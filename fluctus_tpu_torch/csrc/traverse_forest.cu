// K5: treelet-forest traversal: the whole work queue of a call in one
// launch (queue_kernel), and one launch per scheduler pass (forest_kernel).
//
// Replaces the TPU kernel fluctus_tpu/ops/traverse_forest.py::_kernel
// (launched by traverse_forest._launch, from its work queue's rounds and
// its passes). On the TPU, the Pallas grid (ray block, K scheduled chunks)
// streams each chunk's bf16 tables into VMEM and walks it with one-hot
// matmul gathers, keeping the block's best hit in the VMEM-resident output
// across the K visits; a round of the work queue sorts the rays into
// single-chunk blocks so a block streams one chunk. Hopper gathers per
// thread, so these kernels read the chunks' f32 rows (accel/wide.py
// layout, stacked (C, Tp, 56) nodes and (C, Lp, W, 10) leaves) straight
// from device memory and walk a chunk from node 0 with K1's walk
// (wide_walk.cuh) under the lane's best t, carrying the best (t, prim, u,
// v) in registers.
//
// queue_kernel, the work queue's path: one thread per ray picks its own
// chunks, so the round loop's sorts, merges, host reads and launches are
// gone. forest_kernel: one thread per ray slot of a schedule (sel, ent) of
// K chunks per row of `blk` slots (the passes, and the round loop that
// ops/traverse_forest.py keeps as the plain version's scheduler).
//
// What bounds them on the H100: as K1, dependent row fetches per ray
// (latency), not FLOPs; a conference chunk's rows (~1-2 MB) stay in the 50
// MB L2 together with the others.
//
// Visit order and arithmetic equal the plain version (K1's plain walk over
// a per-chunk view, ops/traverse_forest.py::launch_plain, and its round
// loop); built with -fmad=false, the two agree bit for bit.
//
// Launchers: the package's one C signature (fluctus_tpu_torch/launch.py);
// they return cudaGetLastError(), or -1 for arguments out of range.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wide_walk.cuh"

namespace {

using namespace wide_walk;

constexpr int kThreads = 128;

// One thread per ray slot, 128-thread blocks. The schedule row of a slot
// is `slot / blk` (blk 128 for the round loop, 1024 for the passes, so a
// 1024-slot row is shared by 8 CUDA blocks). For each of its K visits a
// lane skips the chunk when the chunk's entry distance does not beat its
// best t, or when it is already blocked (any-hit form); otherwise it walks
// the chunk from node 0 under its best t. Pad slots enter with t 0 and
// take no step. CAP is the walk's stack (wide_walk.cuh).
template <bool ANY_HIT, int CAP>
__global__ void __launch_bounds__(kThreads)
forest_kernel(const int* __restrict__ sel, const float* __restrict__ ent,
              const float* __restrict__ nodes,
              const float* __restrict__ leaves,
              const float* __restrict__ orig, const float* __restrict__ dir,
              const float* __restrict__ it, const int* __restrict__ ip,
              const float* __restrict__ iu, const float* __restrict__ iv,
              int n_slots, int blk, int kk, int tp, int lp, int leaf_width,
              float* __restrict__ ot, int* __restrict__ op,
              float* __restrict__ ou, float* __restrict__ ov) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  Ray r;
  r.ox = orig[3 * i]; r.oy = orig[3 * i + 1]; r.oz = orig[3 * i + 2];
  r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);

  float best_t = it[i];
  int best_prim = ip[i];
  float best_u = iu[i], best_v = iv[i];
  bool blocked = ANY_HIT && best_prim > 0;
  const size_t node_rows = (size_t)tp * 56;
  const size_t leaf_rows = (size_t)lp * leaf_width * 10;
  const int row = i / blk;
  for (int k = 0; k < kk; ++k) {
    if (blocked || !(ent[row * kk + k] < best_t)) continue;
    const size_t c = (size_t)sel[row * kk + k];
    if (walk<ANY_HIT, CAP>(nodes + c * node_rows, leaves + c * leaf_rows,
                           0, leaf_width, r, best_t, best_prim, best_u,
                           best_v)) {
      blocked = true;
    }
  }
  ot[i] = best_t;
  op[i] = ANY_HIT ? (blocked ? 1 : 0) : best_prim;
  ou[i] = best_u;
  ov[i] = best_v;
}

// The slab test of chunk box k (component-major boxes at stride c) with
// traverse_brute._slab's expressions in its order.
__device__ __forceinline__ void chunk_slab(const float* b, int c,
                                           const Ray& r, float& tmn,
                                           float& tmx) {
  const float t0x = (b[0] - r.ox) * r.ix;
  const float t1x = (b[3 * c] - r.ox) * r.ix;
  const float t0y = (b[c] - r.oy) * r.iy;
  const float t1y = (b[4 * c] - r.oy) * r.iy;
  const float t0z = (b[2 * c] - r.oz) * r.iz;
  const float t1z = (b[5 * c] - r.oz) * r.iz;
  tmn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  tmx = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// The work queue of one call, one thread per ray. A lane starts from the
// cursor (-1, -1) and its t_max and loops: the next chunk is the least
// (entry, id) after the cursor among the real chunks whose box it hits
// (tmx >= 0, tmn <= tmx, tmn finite) with clamped entry max(tmn, 0) below
// its best t (any-hit: none once blocked); it walks that chunk under its
// best t and moves the cursor there; it stops when there is none.
//
// That is the round loop (ops/traverse_forest.py::_run_workqueue) ray by
// ray. A ray's result there depends only on its own visits: each round
// walks its next chunk, found by _next_chunk with this rule from its own
// cursor and best t, in a block of rays that visit the same chunk, and
// merges that slot's output, its best after the walk, into it; its
// neighbours in the block share nothing with it but the chunk. A round's
// walk runs whenever the ray has a next chunk, since entry >= 0 is below
// its best t. So the chunks a ray walks, their order, the t each walk
// starts from and every expression are the same here, and so are the
// bits. The sort into chunk segments bought coherence only.
template <bool ANY_HIT, int CAP>
__global__ void __launch_bounds__(kThreads)
queue_kernel(const float* __restrict__ boxes,
             const float* __restrict__ nodes,
             const float* __restrict__ leaves,
             const float* __restrict__ orig, const float* __restrict__ dir,
             const float* __restrict__ tv, int n, int c, int tp, int lp,
             int leaf_width, float* __restrict__ ot, int* __restrict__ op,
             float* __restrict__ ou, float* __restrict__ ov) {
  extern __shared__ float s_box[];          // 6 x c chunk boxes
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s_box[k * c + j] = boxes[(size_t)j * 8 + k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = orig[3 * i]; r.oy = orig[3 * i + 1]; r.oz = orig[3 * i + 2];
  r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);

  float best_t = tv[i];
  int best_prim = ANY_HIT ? 0 : -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool blocked = false;
  const size_t node_rows = (size_t)tp * 56;
  const size_t leaf_rows = (size_t)lp * leaf_width * 10;
  float cur_e = -1.0f;
  int cur_c = -1;
  while (!blocked) {
    float ne = INFINITY;
    int nc = -1;
    for (int k = 0; k < c; ++k) {           // ids ascending: equal entries
      float tmn, tmx;                       // keep the least id
      chunk_slab(s_box + k, c, r, tmn, tmx);
      if (!(tmx >= 0.0f && tmn <= tmx && tmn < INFINITY)) continue;
      const float e = fmaxf(tmn, 0.0f);
      if (!(e < best_t) || !(e > cur_e || (e == cur_e && k > cur_c)))
        continue;
      if (e < ne) {
        ne = e;
        nc = k;
      }
    }
    if (nc < 0) break;
    blocked = walk<ANY_HIT, CAP>(nodes + nc * node_rows,
                                 leaves + nc * leaf_rows, 0, leaf_width, r,
                                 best_t, best_prim, best_u, best_v);
    cur_e = ne;
    cur_c = nc;
  }
  ot[i] = best_t;
  op[i] = ANY_HIT ? (blocked ? 1 : 0) : best_prim;
  ou[i] = best_u;
  ov[i] = best_v;
}

}  // namespace

constexpr size_t kMaxSmem = 232448;    // a block's shared memory on Hopper

// Allows queue_kernel<ANY_HIT, CAP> `smem` bytes of dynamic shared memory
// on the current device; the attribute is set only when a launch needs
// more than that device was allowed before.
template <bool ANY_HIT, int CAP>
static cudaError_t queue_allow(size_t smem) {
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem <= 48 * 1024 || (dev < kMaxDevices && smem <= allowed[dev]))
    return cudaSuccess;
  e = cudaFuncSetAttribute(queue_kernel<ANY_HIT, CAP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return e;
}

// Launches kernel<ANY_HIT, CAP> with `smem` bytes of dynamic shared memory
// for the stack cap `cap` a launcher was given: the kStackCap instance
// where it suffices (every hierarchy of wide depth <= 16), the
// kDeepStackCap one above it.
#define K5_DISPATCH(kernel, allow, any_hit, cap, grid, smem, s, ARGS)       \
  do {                                                                     \
    cudaError_t e_ = cudaSuccess;                                          \
    if (any_hit && cap <= kStackCap) {                                     \
      e_ = allow<true, kStackCap>(smem);                                   \
      if (e_ == cudaSuccess)                                               \
        kernel<true, kStackCap><<<grid, kThreads, smem, s>>>(ARGS);        \
    } else if (any_hit) {                                                  \
      e_ = allow<true, kDeepStackCap>(smem);                               \
      if (e_ == cudaSuccess)                                               \
        kernel<true, kDeepStackCap><<<grid, kThreads, smem, s>>>(ARGS);    \
    } else if (cap <= kStackCap) {                                         \
      e_ = allow<false, kStackCap>(smem);                                  \
      if (e_ == cudaSuccess)                                               \
        kernel<false, kStackCap><<<grid, kThreads, smem, s>>>(ARGS);       \
    } else {                                                               \
      e_ = allow<false, kDeepStackCap>(smem);                              \
      if (e_ == cudaSuccess)                                               \
        kernel<false, kDeepStackCap><<<grid, kThreads, smem, s>>>(ARGS);   \
    }                                                                      \
    if (e_ != cudaSuccess) return (int)e_;                                 \
  } while (0)

// forest_kernel takes no dynamic shared memory.
template <bool ANY_HIT, int CAP>
static cudaError_t no_allow(size_t) {
  return cudaSuccess;
}

// a: boxes, nodes, leaves, orig, dir, tv, n, c, tp, lp, leaf_width,
// any_hit, ot, op, ou, ov, stack entries a ray needs (cap), stream.
extern "C" int k5_queue(const long long* a, int n) {
  if (n != 18) return -1;
  const int rays = (int)a[6], c = (int)a[7], tp = (int)a[8];
  const int lp = (int)a[9], leaf_width = (int)a[10], cap = (int)a[16];
  if (rays <= 0) return 0;
  const size_t smem = (size_t)6 * c * sizeof(float);
  if (c <= 0 || smem > kMaxSmem || cap <= 0 || cap > kDeepStackCap)
    return -1;
  const bool any_hit = a[11] != 0;
  const int blocks = (rays + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)a[17];
#define K5Q_ARGS                                                          \
  (const float*)a[0], (const float*)a[1], (const float*)a[2],             \
      (const float*)a[3], (const float*)a[4], (const float*)a[5], rays,   \
      c, tp, lp, leaf_width, (float*)a[12], (int*)a[13], (float*)a[14],   \
      (float*)a[15]
  K5_DISPATCH(queue_kernel, queue_allow, any_hit, cap, blocks, smem, s,
              K5Q_ARGS);
#undef K5Q_ARGS
  return (int)cudaGetLastError();
}

// a: sel, ent, nodes, leaves, orig, dir, it, ip, iu, iv, n_slots, blk, kk,
// tp, lp, leaf_width, any_hit, ot, op, ou, ov, stack entries a ray needs
// (cap), stream.
extern "C" int k5_forest(const long long* a, int n) {
  if (n != 23) return -1;
  const int n_slots = (int)a[10], blk = (int)a[11], kk = (int)a[12];
  const int tp = (int)a[13], lp = (int)a[14], leaf_width = (int)a[15];
  const int cap = (int)a[21];
  if (n_slots <= 0) return 0;
  if (cap <= 0 || cap > kDeepStackCap) return -1;
  const int blocks = (n_slots + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)a[22];
#define K5_ARGS                                                           \
  (const int*)a[0], (const float*)a[1], (const float*)a[2],               \
      (const float*)a[3], (const float*)a[4], (const float*)a[5],         \
      (const float*)a[6], (const int*)a[7], (const float*)a[8],           \
      (const float*)a[9], n_slots, blk, kk, tp, lp, leaf_width,           \
      (float*)a[17], (int*)a[18], (float*)a[19], (float*)a[20]
  K5_DISPATCH(forest_kernel, no_allow, a[16] != 0, cap, blocks, (size_t)0,
              s, K5_ARGS);
#undef K5_ARGS
  return (int)cudaGetLastError();
}
