// K4: packet traversal of the 8-wide fat-leaf BVH.
//
// Replaces the TPU kernel fluctus_tpu/ops/traverse_pallas.py::_kernel
// (launched by traverse_pallas._launch). On the TPU the scalar unit walks one
// stack shared by a 512-ray block and reads each visited row once, while the
// vector unit tests all lanes against it. Here a packet of 512 rays is a
// cluster of kCluster CTAs on neighbouring SMs, each CTA owning a slice of
// the lanes, kSplit threads a lane, and every warp walks its own copy of
// the packet's stack.
//
// Visit order. At an inner node every lane slab-tests the 8 children for its
// ray. Per child the packet forms "any lane hits" and the least entry
// distance over all lanes (3e38 for lanes that miss); a child is pushed if
// some lane hits it, far-to-near: the largest key first, the lowest slot
// first among equal keys (the JAX kernel's selection rule), so the nearest
// pops next. Empty slots (lo.x = +inf) are skipped, as in K1. At a leaf
// every lane Moller-tests the W slots in slot order with a strict t < best.
// Nothing is pruned on pop: a packet visits the union of its lanes' nodes.
//
// Design for the H100:
// - A warp reduces its lanes' keys with one redux a child (the keys as
//   ordered ints; float min is exact and order free, so the key equals the
//   plain version's) and its hits with one redux of a hit mask. It stores these
//   partials into every CTA of the cluster (distributed shared memory),
//   double-buffered by visit parity, so one cluster barrier an inner visit
//   suffices. Then every warp reduces the packet's partials itself, eight
//   lanes a child, and each of those lanes writes its child's stack slot
//   at sp + rank, rank counted by the push order: no thread does the
//   selection alone, and no barrier hands the new stack to the others.
// - Every warp keeps an identical copy of the stack and stages its own rows
//   in shared memory with cp.async, so a leaf needs no barrier at all. At a
//   leaf the next stack top is already known: its row is fetched into the
//   warp's second buffer while this leaf's triangles are tested.
// - A lane's work is split over kSplit threads: each slab-tests 8 / kSplit
//   children, and tests a block of W / kSplit slots, kUnroll of them side
//   by side, keeping the first slot of the least t below the lane's best;
//   the lane's threads then take the least (t, slot), which is the
//   sequential rule's pick. That shortens each visit of the heaviest
//   packets, whose chains of visits set the launch's time.
// - The any-hit form ends when every lane of the packet is blocked. The
//   warps exchange that at the next inner visit, with the partials; visits
//   after all lanes are blocked change no result (a blocked lane pushes
//   nothing and stays blocked), so ending there gives the same flags.
//
// What bounds it on the H100: the heaviest packets. A launch lasts as long
// as its longest chain of dependent visits (on the kitchen's bounce rays
// one packet makes 423 visits against a mean of 32), each a row fetch, the
// lanes' tests and, at an inner node, a cluster barrier, and every lane
// tests every triangle of a visited leaf. Spreading a packet over kCluster
// SMs and kSplit threads a lane cuts the visit's share of that work on one
// SM and puts several packets on each SM, so one packet's waits overlap
// another's tests. Rays are sorted by octant and Morton code before the
// launch (ops/ray_sort.py) to keep packets coherent.
//
// Rows are K1's packed f32 rows: a node is 56 floats (8 x [lo(3) hi(3)],
// then 8 refs as int bits), a leaf W x [v0 e1 e2 id] with the id as int
// bits. The constants and safe_inv come from wide_walk.cuh. Arithmetic and
// visit order equal the plain version (ops/traverse_pallas.py::
// packet_plain); built with -fmad=false, the two agree bit for bit. Each
// warp's stack holds kMaxStack = 7 * 64 + 1 entries, the worst case of the
// deepest hierarchy the builder makes (wide depth 64), so the push never
// clamps; the wrapper refuses a deeper one. 8 warps x 449 x 4 bytes is
// 14 KB of a CTA's shared memory, which leaves the 4 CTAs an SM in place.
//
// Launcher: the package's one C signature (fluctus_tpu_torch/launch.py);
// it returns cudaGetLastError(), or -1 for arguments out of range.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "wide_walk.cuh"

namespace cg = cooperative_groups;

namespace {

using wide_walk::kBig;
using wide_walk::moller;
using wide_walk::Ray;
using wide_walk::safe_inv;

constexpr int kBlk = 512;          // lanes of a packet
constexpr int kSplit = 4;          // threads per lane
constexpr int kCluster = 8;        // CTAs (one cluster) per packet
constexpr int kMinBlocks = 4;      // CTAs an SM, for the register cut
constexpr bool kPrefetch = true;   // fetch the next row during a leaf
constexpr int kUnroll = 2;         // slots a thread tests side by side
constexpr int kThreads = kBlk * kSplit / kCluster;
constexpr int kWarps = kThreads / 32;          // warps of one CTA
constexpr int kPacketWarps = kWarps * kCluster;
constexpr int kKids = 8 / kSplit;              // children per thread
constexpr int kMaxW = 32;
constexpr int kMaxStack = 449;     // 7 * 64 + 1: wide depth 64
constexpr unsigned kAll = 0xffffffffu;

static_assert((kSplit == 1 || kSplit == 2 || kSplit == 4) &&
                  kThreads % 32 == 0 && kThreads * kCluster ==
                  kBlk * kSplit,
              "a packet is whole warps of 1, 2 or 4 threads a lane");

// The ordered-int image of a float: for non-NaN x, y, x < y implies
// ord(x) < ord(y), and equal ints are equal floats (-0 sorts below +0). It
// is its own inverse.
__device__ __forceinline__ int ord(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

__device__ __forceinline__ void cp_async8(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

// Stage the row of stack entry `enc` (a node if >= 0, else leaf ~enc) into
// a warp's buffer, 8 bytes a lane per step, as one cp.async group.
__device__ __forceinline__ void fetch_row(float* buf, int enc,
                                          const float* __restrict__ nodes,
                                          const float* __restrict__ leaves,
                                          int w, int lane) {
  const float* src = enc >= 0 ? nodes + (size_t)enc * 56
                              : leaves + (size_t)(~enc) * 10 * w;
  const int pairs = enc >= 0 ? 28 : 5 * w;
  for (int k = lane; k < pairs; k += 32) cp_async8(buf + 2 * k, src + 2 * k);
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void fetch_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

template <bool ANY_HIT>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, kMinBlocks)
packet_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
              const float* __restrict__ tmax,
              const float* __restrict__ nodes,
              const float* __restrict__ leaves, int root_ref, int w,
              int row_floats, float* __restrict__ out_t,
              int* __restrict__ out_prim, float* __restrict__ out_u,
              float* __restrict__ out_v) {
  // per visit parity, per warp of the packet: each child's least key (as
  // ord ints) and a mask of the hit children | (all lanes blocked) << 8
  __shared__ int s_key[2][kPacketWarps][8];
  __shared__ int s_mask[2][kPacketWarps];
  __shared__ int s_stack[kWarps][kMaxStack];
  extern __shared__ __align__(16) float s_rows[];   // kWarps x 2 x row_floats

  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = threadIdx.x % kSplit;       // the thread's part of a lane
  const int rank = (int)cl.block_rank();
  const int pw = rank * kWarps + warp;        // the warp's place in the packet
  const int i = (blockIdx.x / kCluster) * kBlk +
                (rank * kThreads + threadIdx.x) / kSplit;
  const float ox = orig[3 * i], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const Ray ray = {ox, oy, oz, dx, dy, dz, ix, iy, iz};

  float best_t = tmax[i];
  int best_prim = -1;
  float best_u = 0.0f, best_v = 0.0f;
  int blocked = 0;

  int* stack = s_stack[warp];
  float* rows = s_rows + (size_t)warp * 2 * row_floats;
  if (lane == 0) stack[0] = root_ref;
  __syncwarp();
  if (kPrefetch) fetch_row(rows, root_ref, nodes, leaves, w, lane);
  int sp = 1;     // uniform over the packet
  int cur = 0;    // the buffer that holds (or receives) the top's row
  int par = 0;    // parity of the inner visit

  while (sp > 0) {
    const int enc = stack[sp - 1];
    --sp;
    float* row = rows + cur * row_floats;
    if (!kPrefetch) fetch_row(row, enc, nodes, leaves, w, lane);
    fetch_wait();
    if (enc >= 0) {
      // thread sub slab-tests children kKids * sub ..; for the others it
      // gives the min and the any their neutral values
      float key[kKids];
      bool hit[kKids];
#pragma unroll
      for (int k = 0; k < kKids; ++k) {
        const float* c = row + 6 * (kKids * sub + k);
        const float lox = c[0];
        const float t0x = (lox - ox) * ix;
        const float t1x = (c[3] - ox) * ix;
        const float t0y = (c[1] - oy) * iy;
        const float t1y = (c[4] - oy) * iy;
        const float t0z = (c[2] - oz) * iz;
        const float t1z = (c[5] - oz) * iz;
        const float tmn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                fminf(t0z, t1z));
        const float tmx = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                fmaxf(t0z, t1z));
        hit[k] = tmx >= 0.0f && tmn <= tmx && tmn < best_t && !isinf(lox);
        if (ANY_HIT) hit[k] = hit[k] && !blocked;
        key[k] = hit[k] ? tmn : kBig;
      }
      unsigned mine_hits = 0;
#pragma unroll
      for (int k = 0; k < kKids; ++k)
        mine_hits |= hit[k] ? 1u << (kKids * sub + k) : 0u;
      const unsigned hits = __reduce_or_sync(kAll, mine_hits);
      int my_key = INT_MAX;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool mine = j / kKids == sub;
        const int least = __reduce_min_sync(
            kAll, mine ? ord(__float_as_int(key[j % kKids])) : INT_MAX);
        if (lane == j) my_key = least;
      }
      int mask = (int)hits;
      if (ANY_HIT && __all_sync(kAll, blocked)) mask |= 1 << 8;
      // the partials go to every CTA of the cluster
#pragma unroll
      for (int c = 0; c < kCluster; ++c) {
        if (lane < 8) cl.map_shared_rank(&s_key[par][pw][0], c)[lane] = my_key;
        if (lane == 8) *cl.map_shared_rank(&s_mask[par][pw], c) = mask;
      }
      if (kCluster > 1)
        cl.sync();
      else
        __syncthreads();
      // lane: child lane & 7 over the packet's warps lane >> 3, +4, ...
      const int c = lane & 7;
      int k = INT_MAX;
#pragma unroll
      for (int g = lane >> 3; g < kPacketWarps; g += 4)
        k = min(k, s_key[par][g][c]);
      k = min(k, __shfl_xor_sync(kAll, k, 8));
      k = min(k, __shfl_xor_sync(kAll, k, 16));
      int m_or = 0, m_and = 1;
#pragma unroll
      for (int g = lane; g < kPacketWarps; g += 32) {
        const int m = s_mask[par][g];
        m_or |= m & 0xff;
        m_and &= m >> 8;
      }
      const unsigned any = (unsigned)__reduce_or_sync(kAll, m_or);
      const bool all_blocked = __reduce_and_sync(kAll, m_and) != 0;
      par ^= 1;
      if (ANY_HIT && all_blocked) break;     // uniform over the packet
      const float ks = (any >> c) & 1u ? __int_as_float(ord(k))
                                       : -CUDART_INF_F;
      // push order: the largest key first, the lowest slot first among
      // equal keys; a child's rank is the number pushed before it
      int before = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float kj = __shfl_sync(kAll, ks, j);
        before += (kj > ks || (kj == ks && j < c)) ? 1 : 0;
      }
      if (lane < 8 && ((any >> lane) & 1u))
        stack[sp + before] = __float_as_int(row[48 + lane]);
      sp += __popc(any);
      __syncwarp();
    }
    if (kPrefetch && sp > 0)
      fetch_row(rows + (cur ^ 1) * row_floats, stack[sp - 1], nodes, leaves,
                w, lane);
    if (enc < 0) {
      // thread sub tests slots [lo, hi) of the lane, kUnroll side by side,
      // keeping the first slot of the least t below best; the lane's
      // threads then take the least (t, slot): the sequential rule's pick
      const int per = (w + kSplit - 1) / kSplit;
      const int lo = sub * per, hi = min(w, lo + per);
      float lt = best_t, lu = 0.0f, lv = 0.0f;
      int lj = INT_MAX, lid = -1;
      if (!(ANY_HIT && blocked)) {
        for (int j0 = lo; j0 < hi; j0 += kUnroll) {
          float tt[kUnroll], uu[kUnroll], vv[kUnroll];
          int id[kUnroll];
          bool ok[kUnroll];
#pragma unroll
          for (int q = 0; q < kUnroll; ++q) {
            float s[10];
            const float2* src = reinterpret_cast<const float2*>(
                row + 10 * min(j0 + q, hi - 1));
#pragma unroll
            for (int e = 0; e < 5; ++e) {
              const float2 x = src[e];
              s[2 * e] = x.x;
              s[2 * e + 1] = x.y;
            }
            ok[q] = moller(s, ray, tt[q], uu[q], vv[q], id[q]) && j0 + q < hi;
          }
#pragma unroll
          for (int q = 0; q < kUnroll; ++q) {
            if (ok[q] && tt[q] < lt) {
              lt = tt[q]; lj = j0 + q; lid = id[q]; lu = uu[q]; lv = vv[q];
            }
          }
        }
      }
      if (ANY_HIT) {
        bool hit = lj != INT_MAX;
#pragma unroll
        for (int off = 1; off < kSplit; off <<= 1)
          hit |= __shfl_xor_sync(kAll, hit, off) != 0;
        if (hit) blocked = 1;
      } else {
#pragma unroll
        for (int off = 1; off < kSplit; off <<= 1) {
          const float ot = __shfl_xor_sync(kAll, lt, off);
          const int oj = __shfl_xor_sync(kAll, lj, off);
          if (ot < lt || (ot == lt && oj < lj)) {
            lt = ot;
            lj = oj;
          }
        }
        const int src = (lane & ~(kSplit - 1)) | (lj / per);
        const int wid = __shfl_sync(kAll, lid, src & 31);
        const float wu = __shfl_sync(kAll, lu, src & 31);
        const float wv = __shfl_sync(kAll, lv, src & 31);
        if (lj != INT_MAX) {
          best_t = lt;
          best_prim = wid;
          best_u = wu;
          best_v = wv;
        }
      }
    }
    cur ^= 1;
  }
  if (kCluster > 1) cl.sync();   // no CTA leaves while partials may arrive
  if (sub != 0) return;
  out_t[i] = best_t;
  out_prim[i] = ANY_HIT ? blocked : best_prim;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

// Allows packet_kernel<ANY_HIT> `smem` bytes of dynamic shared memory on
// the current device, setting the attribute only where its static and
// dynamic shared memory pass 48 KB and above what it allowed before.
template <bool ANY_HIT>
cudaError_t allow(size_t smem) {
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && smem <= allowed[dev]) return cudaSuccess;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, packet_kernel<ANY_HIT>);
  if (e != cudaSuccess) return e;
  if (fa.sharedSizeBytes + smem > 48 * 1024)
    e = cudaFuncSetAttribute(packet_kernel<ANY_HIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return e;
}

}  // namespace

// a: orig, dir, tmax, nodes, leaves, n_rays, root_ref, leaf_width, any_hit,
// out_t, out_prim, out_u, out_v, stream.
extern "C" int k4_packet(const long long* a, int n) {
  if (n != 14) return -1;
  const int n_rays = (int)a[5], root_ref = (int)a[6], leaf_width = (int)a[7];
  if (n_rays <= 0) return 0;
  if (n_rays % kBlk || leaf_width <= 0 || leaf_width > kMaxW) return -1;
  // a warp's two row buffers: a node row or a leaf row, 16-byte multiples
  const int row_floats = (max(56, 10 * leaf_width) + 3) & ~3;
  const size_t smem = (size_t)kWarps * 2 * row_floats * sizeof(float);
  const int blocks = n_rays / kBlk * kCluster;
  cudaStream_t s = (cudaStream_t)a[13];
  const bool any_hit = a[8] != 0;
  const cudaError_t e = any_hit ? allow<true>(smem) : allow<false>(smem);
  if (e != cudaSuccess) return (int)e;
#define K4_ARGS                                                           \
  (const float*)a[0], (const float*)a[1], (const float*)a[2],             \
      (const float*)a[3], (const float*)a[4], root_ref, leaf_width,       \
      row_floats, (float*)a[9], (int*)a[10], (float*)a[11], (float*)a[12]
  if (any_hit)
    packet_kernel<true><<<blocks, kThreads, smem, s>>>(K4_ARGS);
  else
    packet_kernel<false><<<blocks, kThreads, smem, s>>>(K4_ARGS);
#undef K4_ARGS
  return (int)cudaGetLastError();
}
