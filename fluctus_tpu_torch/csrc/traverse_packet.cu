// K4: packet traversal of the 8-wide fat-leaf BVH.
//
// Replaces the TPU kernel fluctus_tpu/ops/traverse_pallas.py::_kernel
// (launched by traverse_pallas._launch). On the TPU the scalar unit walks one
// stack shared by a 512-ray block and reads each visited row once, while the
// vector unit tests all lanes against it. Here one 512-thread CUDA block is
// one packet: the stack (192 entries) lives in shared memory, each visited
// row is staged once into shared memory and read by every thread.
//
// Inner node: every thread slab-tests the 8 children for its ray. Per child
// the block forms "any lane hits" and the least entry distance over all
// lanes (3e38 for lanes that miss) with warp ballots and shuffles, then
// across the 16 warps through shared memory; float min is exact and order
// free, so the key equals the plain version's. Thread 0 pushes the hit
// children far-to-near with the JAX kernel's selection rule: repeatedly the
// largest key, the lowest slot first among equal keys. Empty slots (lo.x =
// +inf) are skipped, as in K1. Leaf: every thread Moller-tests the W slots
// in slot order with a strict t < best. The any-hit form ends when every
// lane of the packet is blocked (__syncthreads_and).
//
// What bounds it on the H100: the serial walk of one stack per packet; a
// visit costs a row fetch and two to three block barriers, and an incoherent
// packet visits the union of its lanes' nodes. Rays are sorted by octant and
// Morton code before the launch (ops/ray_sort.py) to keep packets coherent.
//
// Rows are K1's packed f32 rows: a node is 56 floats (8 x [lo(3) hi(3)],
// then 8 refs as int bits), a leaf W x [v0 e1 e2 id] with the id as int
// bits. The constants and safe_inv come from the walk K1 and K5 share.
// Arithmetic and visit order equal the plain version
// (ops/traverse_pallas.py::packet_plain); built with -fmad=false, the two
// agree bit for bit. The wrapper refuses hierarchies whose worst-case stack
// (7 * depth + 1) exceeds 192, so the push never clamps.
//
// Launcher: the package's one C signature (fluctus_tpu_torch/launch.py);
// it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wide_walk.cuh"

namespace {

using wide_walk::kBig;
using wide_walk::kTriEps;
using wide_walk::safe_inv;

constexpr int kBlk = 512;
constexpr int kWarps = kBlk / 32;
constexpr int kStack = 192;
constexpr int kMaxW = 32;

template <bool ANY_HIT>
__global__ void __launch_bounds__(kBlk)
packet_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
              const float* __restrict__ tmax,
              const float* __restrict__ nodes,
              const float* __restrict__ leaves, int root_ref, int w,
              float* __restrict__ out_t, int* __restrict__ out_prim,
              float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ int s_stack[kStack];
  __shared__ int s_sp;
  __shared__ float s_node[48];
  __shared__ int s_ref[8];
  __shared__ float s_leaf[10 * kMaxW];
  __shared__ float s_key[kWarps][8];
  __shared__ int s_hit[kWarps][8];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i = blockIdx.x * kBlk + tid;
  const float ox = orig[3 * i], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  float best_t = tmax[i];
  int best_prim = -1;
  float best_u = 0.0f, best_v = 0.0f;
  int blocked = 0;

  if (tid == 0) s_stack[0] = root_ref;
  int sp = 1;   // uniform over the block
  __syncthreads();

  while (sp > 0) {
    if (ANY_HIT && __syncthreads_and(blocked)) break;
    const int enc = s_stack[sp - 1];
    --sp;
    if (enc >= 0) {
      if (tid < 48) {
        s_node[tid] = nodes[(size_t)enc * 56 + tid];
      } else if (tid < 56) {
        s_ref[tid - 48] = __float_as_int(nodes[(size_t)enc * 56 + tid]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float lox = s_node[6 * j];
        const float t0x = (lox - ox) * ix;
        const float t1x = (s_node[6 * j + 3] - ox) * ix;
        const float t0y = (s_node[6 * j + 1] - oy) * iy;
        const float t1y = (s_node[6 * j + 4] - oy) * iy;
        const float t0z = (s_node[6 * j + 2] - oz) * iz;
        const float t1z = (s_node[6 * j + 5] - oz) * iz;
        const float tmn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                fminf(t0z, t1z));
        const float tmx = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                fmaxf(t0z, t1z));
        bool hit = tmx >= 0.0f && tmn <= tmx && tmn < best_t && !isinf(lox);
        if (ANY_HIT) hit = hit && !blocked;
        float key = hit ? tmn : kBig;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          key = fminf(key, __shfl_xor_sync(0xffffffffu, key, off));
        }
        const int any = __any_sync(0xffffffffu, hit);
        if (lane == 0) {
          s_key[warp][j] = key;
          s_hit[warp][j] = any;
        }
      }
      __syncthreads();
      if (tid == 0) {
        float ks[8];
        for (int j = 0; j < 8; ++j) {
          float key = s_key[0][j];
          int any = s_hit[0][j];
          for (int k = 1; k < kWarps; ++k) {
            key = fminf(key, s_key[k][j]);
            any |= s_hit[k][j];
          }
          ks[j] = any ? key : -CUDART_INF_F;
        }
        // push far-to-near: the largest key first, the lowest slot first
        // among equal keys (the JAX kernel's selection network)
        int p = sp;
        for (int n = 0; n < 8; ++n) {
          int far = 0;
          float fk = ks[0];
          for (int j = 1; j < 8; ++j) {
            if (ks[j] > fk) {
              far = j;
              fk = ks[j];
            }
          }
          if (fk > -CUDART_INF_F) s_stack[p++] = s_ref[far];
          ks[far] = -CUDART_INF_F;
        }
        s_sp = p;
      }
      __syncthreads();
      sp = s_sp;
    } else {
      const int leaf = ~enc;
      for (int k = tid; k < 10 * w; k += kBlk) {
        s_leaf[k] = leaves[(size_t)leaf * 10 * w + k];
      }
      __syncthreads();
      for (int slot = 0; slot < w; ++slot) {
        const float* s = s_leaf + slot * 10;
        const float ax = s[0], ay = s[1], az = s[2];
        const float e1x = s[3], e1y = s[4], e1z = s[5];
        const float e2x = s[6], e2y = s[7], e2z = s[8];
        const int id = __float_as_int(s[9]);
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        bool ok = fabsf(det) >= kTriEps;
        const float idet = 1.0f / (ok ? det : 1.0f);
        const float tvx = ox - ax, tvy = oy - ay, tvz = oz - az;
        const float u = (tvx * px + tvy * py + tvz * pz) * idet;
        const float qx = tvy * e1z - tvz * e1y;
        const float qy = tvz * e1x - tvx * e1z;
        const float qz = tvx * e1y - tvy * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * idet;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * idet;
        ok = ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
             t >= 0.0f && t < best_t && id >= 0;
        if (ANY_HIT) {
          if (ok) blocked = 1;
        } else if (ok) {
          best_t = t;
          best_prim = id;
          best_u = u;
          best_v = v;
        }
      }
      __syncthreads();   // the next visit overwrites the staged rows
    }
  }
  out_t[i] = best_t;
  out_prim[i] = ANY_HIT ? blocked : best_prim;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

}  // namespace

// a: orig, dir, tmax, nodes, leaves, n_rays, root_ref, leaf_width, any_hit,
// out_t, out_prim, out_u, out_v, stream.
extern "C" int k4_packet(const long long* a, int n) {
  if (n != 14) return -1;
  const int n_rays = (int)a[5], root_ref = (int)a[6], leaf_width = (int)a[7];
  if (n_rays <= 0) return 0;
  if (n_rays % kBlk || leaf_width <= 0 || leaf_width > kMaxW) return -1;
  const int blocks = n_rays / kBlk;
  cudaStream_t s = (cudaStream_t)a[13];
#define K4_ARGS                                                           \
  (const float*)a[0], (const float*)a[1], (const float*)a[2],             \
      (const float*)a[3], (const float*)a[4], root_ref, leaf_width,       \
      (float*)a[9], (int*)a[10], (float*)a[11], (float*)a[12]
  if (a[8])
    packet_kernel<true><<<blocks, kBlk, 0, s>>>(K4_ARGS);
  else
    packet_kernel<false><<<blocks, kBlk, 0, s>>>(K4_ARGS);
#undef K4_ARGS
  return (int)cudaGetLastError();
}
