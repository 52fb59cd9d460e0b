// K1: per-ray near-first stack traversal of the 8-wide fat-leaf BVH.
//
// Replaces the TPU kernel fluctus_tpu/ops/traverse_mxu.py::_kernel (launched
// by traverse_mxu._launch). The TPU has no per-lane gather, so that kernel
// fetched node and leaf rows with one-hot bf16 matmuls over re-encoded
// tables. Hopper gathers per thread, so this kernel reads the f32 rows of
// accel/wide.py straight from device memory: one thread per ray, a node row
// of 56 floats (224 B) per inner visit and a leaf row of W x 10 floats
// (640 B at W = 16) per leaf visit. The tables of a scene under the
// fast-big cutover (< 8 MB) stay resident in the 50 MB L2.
//
// What bounds it on the H100: the rows each ray fetches, dependent loads in
// a loop, so latency and L2 bandwidth rather than FLOPs. The design keeps
// the loop simple: the stack lives in thread-local memory (L1-cached),
// children are pushed far-first so the near child pops next, and stale
// entries are pruned on pop against the running best t. The walk itself is
// in wide_walk.cuh, shared with K5.
//
// Visit order and arithmetic equal the plain version (the restart-trail
// walk of fluctus_tpu/ops/traverse_wide.py, ported in ops/traverse_stack.py):
// children are visited in ascending (tmin, slot) order, the slab and
// Moller-Trumbore expressions are evaluated in the same order, and the
// library is built with -fmad=false, so the two agree bit for bit.
//
// Launcher: the package's one C signature (fluctus_tpu_torch/launch.py);
// it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_walk.cuh"

namespace {

using namespace wide_walk;

template <bool ANY_HIT>
__global__ void __launch_bounds__(128)
traverse_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ tmax,
                const float* __restrict__ nodes,
                const float* __restrict__ leaves, int n_rays, int root_ref,
                int leaf_width, float* __restrict__ out_t,
                int* __restrict__ out_prim, float* __restrict__ out_u,
                float* __restrict__ out_v, uint8_t* __restrict__ out_blocked) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  r.ox = orig[3 * i]; r.oy = orig[3 * i + 1]; r.oz = orig[3 * i + 2];
  r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);

  float best_t = tmax[i];
  int best_prim = -1;
  float best_u = 0.0f, best_v = 0.0f;
  const bool blocked = walk<ANY_HIT>(nodes, leaves, root_ref, leaf_width, r,
                                     best_t, best_prim, best_u, best_v);
  if (ANY_HIT) {
    out_blocked[i] = blocked ? 1 : 0;
  } else {
    out_t[i] = best_t;
    out_prim[i] = best_prim;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

}  // namespace

// a: orig, dir, tmax, nodes, leaves, n_rays, root_ref, leaf_width, any_hit,
// out_t, out_prim, out_u, out_v, out_blocked, stream.
extern "C" int k1_traverse(const long long* a, int n) {
  if (n != 15) return -1;
  const int n_rays = (int)a[5], root_ref = (int)a[6], leaf_width = (int)a[7];
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)a[14];
  const float* orig = (const float*)a[0];
  const float* dir = (const float*)a[1];
  const float* tmax = (const float*)a[2];
  const float* nodes = (const float*)a[3];
  const float* leaves = (const float*)a[4];
  if (a[8]) {
    traverse_kernel<true><<<blocks, threads, 0, s>>>(
        orig, dir, tmax, nodes, leaves, n_rays, root_ref, leaf_width,
        nullptr, nullptr, nullptr, nullptr, (uint8_t*)a[13]);
  } else {
    traverse_kernel<false><<<blocks, threads, 0, s>>>(
        orig, dir, tmax, nodes, leaves, n_rays, root_ref, leaf_width,
        (float*)a[9], (int*)a[10], (float*)a[11], (float*)a[12], nullptr);
  }
  return (int)cudaGetLastError();
}
