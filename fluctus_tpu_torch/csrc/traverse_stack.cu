// K1: per-ray near-first stack traversal of the 8-wide fat-leaf BVH.
//
// Replaces the TPU kernel fluctus_tpu/ops/traverse_mxu.py::_kernel (launched
// by traverse_mxu._launch). The TPU has no per-lane gather, so that kernel
// fetched node and leaf rows with one-hot bf16 matmuls over re-encoded
// tables. Hopper gathers per thread, so this kernel reads the f32 rows of
// accel/wide.py straight from device memory: a node row of 56 floats (224 B)
// per inner visit and a leaf row of W x 10 floats (640 B at W = 16) per leaf
// visit. The tables of a scene under the fast-big cutover (< 8 MB) stay
// resident in the 50 MB L2.
//
// What bounds it on the H100: the rows each ray fetches, a chain of
// dependent loads, so latency and load instructions rather than FLOPs. The
// design: a team of kTeam lanes walks one ray.
// - An inner visit: the team reads the node row together, each lane the
//   boxes of 8 / kTeam children with 8- or 16-byte loads (a 224-byte row in
//   two 128-byte lines), slab-tests them, and shares the entry distances
//   with shuffles. Each lane ranks its hit children by (tmin, slot), the
//   order the plain version visits them in, and writes them far-first onto
//   the ray's stack, so the nearest pops next.
// - A leaf visit: lane k tests a contiguous block of ceil(W / kTeam) slots,
//   keeping the first slot of the least t below the ray's best t; the team
//   then takes the least (t, slot) over its lanes, which is the sequential
//   rule's pick. In the any-hit form a team vote ends the walk.
// - The ray's stack lives in shared memory (cap entries of (key, ref) per
//   ray, cap = 7 * (depth + 1) + 9 from the wrapper), so the local-memory
//   stack and the insertion sort of one thread a ray are gone, and a
//   65,536-ray launch is kTeam times as many warps.
// Stale entries are pruned on pop against the running best t, as before.
//
// Visit order and arithmetic equal the plain version (the restart-trail
// walk of fluctus_tpu/ops/traverse_wide.py, ported in ops/traverse_stack.py):
// children are visited in ascending (tmin, slot) order, the slab and
// Moller-Trumbore expressions are evaluated in the same order, and the
// library is built with -fmad=false, so the two agree bit for bit. K5 keeps
// the one-thread walk of wide_walk.cuh.
//
// Launcher: the package's one C signature (fluctus_tpu_torch/launch.py);
// it returns cudaGetLastError(), or -1 for arguments out of range.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "wide_walk.cuh"

namespace {

using wide_walk::kBig;
using wide_walk::kDeepStackCap;
using wide_walk::kStackCap;
using wide_walk::moller;
using wide_walk::Ray;
using wide_walk::safe_inv;

constexpr int kTeam = 8;           // lanes per ray: 1, 2, 4 or 8
constexpr int kThreads = 128;      // threads per CTA
constexpr int kMinBlocks = 8;      // CTAs an SM, for the register cut
constexpr bool kSharedStack = true;
constexpr int kUnroll = 2;         // slots a lane tests side by side
constexpr int kRays = kThreads / kTeam;    // rays per CTA
constexpr int kKids = 8 / kTeam;           // children per lane

static_assert(kTeam == 1 || kTeam == 2 || kTeam == 4 || kTeam == 8,
              "a team is 1, 2, 4 or 8 lanes");

// One stack entry: the child's entry distance and its ref as int bits.
using Entry = float2;

// The children kKids * t .. of node row `row` for team lane t: each one's
// entry distance if the ray hits it below best_t (else +inf) and its ref.
__device__ __forceinline__ void slab(const float* __restrict__ row, int t,
                                     const Ray& r, float best_t,
                                     float (&tmin)[kKids], int (&ref)[kKids]) {
  float b[6 * kKids];
  const float* p = row + 6 * kKids * t;
  if constexpr (kKids == 1) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p) + q);
      b[2 * q] = x.x;
      b[2 * q + 1] = x.y;
    }
    ref[0] = __float_as_int(__ldg(row + 48 + t));
  } else {
#pragma unroll
    for (int q = 0; q < 3 * kKids / 2; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
      b[4 * q] = x.x;
      b[4 * q + 1] = x.y;
      b[4 * q + 2] = x.z;
      b[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < kKids / 2; ++q) {
      const float2 x =
          __ldg(reinterpret_cast<const float2*>(row + 48 + kKids * t) + q);
      ref[2 * q] = __float_as_int(x.x);
      ref[2 * q + 1] = __float_as_int(x.y);
    }
  }
#pragma unroll
  for (int k = 0; k < kKids; ++k) {
    const float* c = b + 6 * k;
    const float lox = c[0];
    const float t0x = (lox - r.ox) * r.ix;
    const float t1x = (c[3] - r.ox) * r.ix;
    const float t0y = (c[1] - r.oy) * r.iy;
    const float t1y = (c[4] - r.oy) * r.iy;
    const float t0z = (c[2] - r.oz) * r.iz;
    const float t1z = (c[5] - r.oz) * r.iz;
    const float tmn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                            fminf(t0z, t1z));
    const float tmx = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                            fmaxf(t0z, t1z));
    const bool hit = !isinf(lox) && tmx >= 0.0f && tmn <= tmx &&
                     tmn < best_t && tmn < kBig;
    tmin[k] = hit ? tmn : CUDART_INF_F;
  }
}

// One leaf row for the team: lane t tests slots [t * per, (t + 1) * per).
// Closest form: the least (t, slot) over the team's valid hits replaces the
// best hit (the first slot of the least t, as the sequential rule picks).
// Any-hit form: true when some slot is hit before best_t.
template <bool ANY_HIT>
__device__ __forceinline__ bool leaf(const float* __restrict__ row, int w,
                                     int t, unsigned tmask, const Ray& r,
                                     float& best_t, int& best_prim,
                                     float& best_u, float& best_v) {
  const int per = (w + kTeam - 1) / kTeam;
  const int lo = t * per, hi = min(w, lo + per);
  float lt = best_t, lu = 0.0f, lv = 0.0f;
  int lj = INT_MAX, lid = -1;
  for (int j0 = lo; j0 < hi; j0 += kUnroll) {
    float tt[kUnroll], uu[kUnroll], vv[kUnroll];
    int id[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      float s[10];
      const float2* src =
          reinterpret_cast<const float2*>(row + 10 * min(j0 + q, hi - 1));
#pragma unroll
      for (int e = 0; e < 5; ++e) {
        const float2 x = __ldg(src + e);
        s[2 * e] = x.x;
        s[2 * e + 1] = x.y;
      }
      ok[q] = moller(s, r, tt[q], uu[q], vv[q], id[q]) && j0 + q < hi;
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (ok[q] && tt[q] < lt) {
        lt = tt[q]; lj = j0 + q; lid = id[q]; lu = uu[q]; lv = vv[q];
      }
    }
  }
  if (ANY_HIT) {
    const bool any = lj != INT_MAX;
    return kTeam == 1 ? any : __any_sync(tmask, any);
  }
#pragma unroll
  for (int off = 1; off < kTeam; off <<= 1) {
    const float ot = __shfl_xor_sync(tmask, lt, off, kTeam);
    const int oj = __shfl_xor_sync(tmask, lj, off, kTeam);
    if (ot < lt || (ot == lt && oj < lj)) {
      lt = ot;
      lj = oj;
    }
  }
  if (lj != INT_MAX) {
    const int src = lj / per;    // the lane that tested slot lj
    best_t = lt;
    best_prim = kTeam == 1 ? lid : __shfl_sync(tmask, lid, src, kTeam);
    best_u = kTeam == 1 ? lu : __shfl_sync(tmask, lu, src, kTeam);
    best_v = kTeam == 1 ? lv : __shfl_sync(tmask, lv, src, kTeam);
  }
  return false;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
traverse_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ tmax,
                const float* __restrict__ nodes,
                const float* __restrict__ leaves, int n_rays, int root_ref,
                int leaf_width, int cap, float* __restrict__ out_t,
                int* __restrict__ out_prim, float* __restrict__ out_u,
                float* __restrict__ out_v, uint8_t* __restrict__ out_blocked) {
  extern __shared__ __align__(16) Entry s_stack[];   // kRays x cap
  const int t = threadIdx.x % kTeam;
  const int ray = threadIdx.x / kTeam;
  const int i = blockIdx.x * kRays + ray;
  if (i >= n_rays) return;     // the whole team
  const unsigned tmask = ((1u << kTeam) - 1)
                         << ((threadIdx.x & 31) & ~(kTeam - 1));
  Ray r;
  r.ox = orig[3 * i]; r.oy = orig[3 * i + 1]; r.oz = orig[3 * i + 2];
  r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);

  float best_t = tmax[i];
  int best_prim = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool blocked = false;
  const int row_len = leaf_width * 10;
  Entry* stack = s_stack + (size_t)ray * cap;
  Entry lstack[kSharedStack ? 1 : kStackCap];   // the local-memory variant
  int sp = 0;                                    // uniform over the team

  if (root_ref < 0) {
    blocked = leaf<ANY_HIT>(leaves + (size_t)(~root_ref) * row_len,
                            leaf_width, t, tmask, r, best_t, best_prim,
                            best_u, best_v);
  } else {
    int node = root_ref;
    while (node >= 0) {
      float tmin[kKids];
      int ref[kKids];
      slab(nodes + (size_t)node * 56, t, r, best_t, tmin, ref);
      // every lane holds all 8 entry distances; hit children rank by
      // (tmin, slot) and go far-first onto the stack
      float all[8];
#pragma unroll
      for (int l = 0; l < kTeam; ++l)
#pragma unroll
        for (int k = 0; k < kKids; ++k)
          all[l * kKids + k] =
              kTeam == 1 ? tmin[k] : __shfl_sync(tmask, tmin[k], l, kTeam);
      int nc = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) nc += all[j] < CUDART_INF_F ? 1 : 0;
      if (kSharedStack) {
        __syncwarp(tmask);    // earlier pops of these slots are done
#pragma unroll
        for (int k = 0; k < kKids; ++k) {
          const int j = t * kKids + k;
          if (tmin[k] < CUDART_INF_F) {
            int rank = 0;
#pragma unroll
            for (int q = 0; q < 8; ++q)
              rank += (all[q] < tmin[k] || (all[q] == tmin[k] && q < j)) ? 1
                                                                        : 0;
            stack[sp + nc - 1 - rank] =
                make_float2(tmin[k], __int_as_float(ref[k]));
          }
        }
        __syncwarp(tmask);
      } else {
        int refs[8];
#pragma unroll
        for (int l = 0; l < kTeam; ++l)
#pragma unroll
          for (int k = 0; k < kKids; ++k)
            refs[l * kKids + k] =
                kTeam == 1 ? ref[k] : __shfl_sync(tmask, ref[k], l, kTeam);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (all[j] < CUDART_INF_F) {
            int rank = 0;
#pragma unroll
            for (int q = 0; q < 8; ++q)
              rank += (all[q] < all[j] || (all[q] == all[j] && q < j)) ? 1
                                                                      : 0;
            lstack[sp + nc - 1 - rank] =
                make_float2(all[j], __int_as_float(refs[j]));
          }
        }
      }
      sp += nc;
      // pop until the next inner node; leaves are tested on the way
      node = -1;
      while (sp > 0) {
        --sp;
        const Entry e = kSharedStack ? stack[sp] : lstack[sp];
        if (!(e.x < best_t)) continue;   // made stale by a closer hit
        const int ref_ = __float_as_int(e.y);
        if (ref_ >= 0) {
          node = ref_;
          break;
        }
        if (leaf<ANY_HIT>(leaves + (size_t)(~ref_) * row_len, leaf_width, t,
                          tmask, r, best_t, best_prim, best_u, best_v)) {
          blocked = true;
          sp = 0;
        }
      }
    }
  }
  if (t != 0) return;
  if (ANY_HIT) {
    out_blocked[i] = blocked ? 1 : 0;
  } else {
    out_t[i] = best_t;
    out_prim[i] = best_prim;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

// Allows traverse_kernel<ANY_HIT> `smem` bytes of dynamic shared memory on
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
  e = cudaFuncGetAttributes(&fa, traverse_kernel<ANY_HIT>);
  if (e != cudaSuccess) return e;
  if (fa.sharedSizeBytes + smem > 48 * 1024)
    e = cudaFuncSetAttribute(traverse_kernel<ANY_HIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return e;
}

}  // namespace

// a: orig, dir, tmax, nodes, leaves, n_rays, root_ref, leaf_width, any_hit,
// out_t, out_prim, out_u, out_v, out_blocked, stack entries per ray (cap),
// stream.
extern "C" int k1_traverse(const long long* a, int n) {
  if (n != 16) return -1;
  const int n_rays = (int)a[5], root_ref = (int)a[6], leaf_width = (int)a[7];
  const int cap = (int)a[14];
  if (n_rays <= 0) return 0;
  // the shared stack takes any depth up to the builder's (the wrapper's
  // cap, 16 x cap x 8 bytes a CTA: 59,392 at wide depth 64); the local
  // variant has kStackCap entries a ray
  if (leaf_width <= 0 || cap <= 0 ||
      cap > (kSharedStack ? kDeepStackCap : kStackCap))
    return -1;
  const int blocks = (n_rays + kRays - 1) / kRays;
  const size_t smem = kSharedStack ? (size_t)kRays * cap * sizeof(Entry) : 0;
  cudaStream_t s = (cudaStream_t)a[15];
  const float* orig = (const float*)a[0];
  const float* dir = (const float*)a[1];
  const float* tmax = (const float*)a[2];
  const float* nodes = (const float*)a[3];
  const float* leaves = (const float*)a[4];
  const bool any_hit = a[8] != 0;
  const cudaError_t e = any_hit ? allow<true>(smem) : allow<false>(smem);
  if (e != cudaSuccess) return (int)e;
  if (any_hit) {
    traverse_kernel<true><<<blocks, kThreads, smem, s>>>(
        orig, dir, tmax, nodes, leaves, n_rays, root_ref, leaf_width, cap,
        nullptr, nullptr, nullptr, nullptr, (uint8_t*)a[13]);
  } else {
    traverse_kernel<false><<<blocks, kThreads, smem, s>>>(
        orig, dir, tmax, nodes, leaves, n_rays, root_ref, leaf_width, cap,
        (float*)a[9], (int*)a[10], (float*)a[11], (float*)a[12], nullptr);
  }
  return (int)cudaGetLastError();
}
