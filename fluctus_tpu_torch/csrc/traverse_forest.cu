// K5: treelet-forest traversal, one launch per scheduler round or pass.
//
// Replaces the TPU kernel fluctus_tpu/ops/traverse_forest.py::_kernel
// (launched by traverse_forest._launch). On the TPU, the Pallas grid
// (ray block, K scheduled chunks) streams each chunk's bf16 tables into VMEM
// and walks it with one-hot matmul gathers, keeping the block's best hit in
// the VMEM-resident output across the K visits. Hopper gathers per thread,
// so this kernel reads the chunks' f32 rows (accel/wide.py layout, stacked
// (C, Tp, 56) nodes and (C, Lp, W, 10) leaves) straight from device memory,
// and the sequential K axis becomes a loop inside one thread that carries the
// best (t, prim, u, v) in registers.
//
// Layout: one thread per ray slot, 128-thread blocks. The schedule row of a
// slot is `slot / blk` (blk 128 for the work queue, 1024 for the passes, so
// a 1024-slot row is shared by 8 CUDA blocks). For each of its K visits a
// lane skips the chunk when the chunk's entry distance does not beat its
// best t, or when it is already blocked (any-hit form); otherwise it walks
// the chunk from node 0 with K1's walk (wide_walk.cuh) under its best t.
//
// What bounds it on the H100: as K1, dependent row fetches per ray (latency),
// not FLOPs; a conference chunk's rows (~1-2 MB) stay in the 50 MB L2
// together with the others. Pad slots enter with t 0 and take no step.
//
// Visit order and arithmetic equal the plain version (K1's plain walk over a
// per-chunk view, ops/traverse_forest.py::launch_plain); built with
// -fmad=false, the two agree bit for bit.
//
// Launcher: the package's one C signature (fluctus_tpu_torch/launch.py);
// it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_walk.cuh"

namespace {

using namespace wide_walk;

constexpr int kThreads = 128;

template <bool ANY_HIT>
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
    if (walk<ANY_HIT>(nodes + c * node_rows, leaves + c * leaf_rows, 0,
                      leaf_width, r, best_t, best_prim, best_u, best_v)) {
      blocked = true;
    }
  }
  ot[i] = best_t;
  op[i] = ANY_HIT ? (blocked ? 1 : 0) : best_prim;
  ou[i] = best_u;
  ov[i] = best_v;
}

}  // namespace

// a: sel, ent, nodes, leaves, orig, dir, it, ip, iu, iv, n_slots, blk, kk,
// tp, lp, leaf_width, any_hit, ot, op, ou, ov, stream.
extern "C" int k5_forest(const long long* a, int n) {
  if (n != 22) return -1;
  const int n_slots = (int)a[10], blk = (int)a[11], kk = (int)a[12];
  const int tp = (int)a[13], lp = (int)a[14], leaf_width = (int)a[15];
  if (n_slots <= 0) return 0;
  const int blocks = (n_slots + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)a[21];
#define K5_ARGS                                                           \
  (const int*)a[0], (const float*)a[1], (const float*)a[2],               \
      (const float*)a[3], (const float*)a[4], (const float*)a[5],         \
      (const float*)a[6], (const int*)a[7], (const float*)a[8],           \
      (const float*)a[9], n_slots, blk, kk, tp, lp, leaf_width,           \
      (float*)a[17], (int*)a[18], (float*)a[19], (float*)a[20]
  if (a[16])
    forest_kernel<true><<<blocks, kThreads, 0, s>>>(K5_ARGS);
  else
    forest_kernel<false><<<blocks, kThreads, 0, s>>>(K5_ARGS);
#undef K5_ARGS
  return (int)cudaGetLastError();
}
