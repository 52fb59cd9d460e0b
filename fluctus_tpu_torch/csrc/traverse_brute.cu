// K2 and K3: brute-chunk traversal of the big-scene forest.
//
// K2 replaces the TPU kernel fluctus_tpu/ops/traverse_brute.py::_vkernel
// (with _vkernel_body and _moller_tile; launched by _vlaunch). K3 replaces
// traverse_brute.py::_kernel (with _kernel_body; launched by _launch).
//
// On the TPU a grid step held one (ray block, chunk) visit as (128, tile)
// vector planes and kept the block's best hit resident in VMEM across the
// visit steps of one block. Here one CUDA block of blk threads (one ray
// each) is one ray block: K2 walks the block's v_per visit slots in a loop
// inside the kernel and keeps the best hit in registers; K3 makes its one
// visit. Pallas's pl.when guards become block-uniform branches decided
// with __syncthreads_or; the chunk's tile boxes (K2) or chunk boxes (K3)
// and each piece of blk triangles (10 floats each) are staged in shared
// memory, and every thread then tests the staged triangles in order.
//
// What bounds them on the H100: the Moller tests of the tiles a block
// runs (~55 FP32 instructions per triangle and live lane), so operations,
// with the triangle rows read from L2 (the conference's tables, 15 MB,
// fit in its 50 MB). The design keeps the arithmetic simple and exact
// rather than fast: no FMAs (-fmad=false), IEEE division.
//
// Semantics equal the plain versions in ops/traverse_brute.py bit for bit
// (the same expressions in the same order): a tile group's result is its
// least valid t together with 3e38 and the first slot on equal t, and it
// replaces the carried best only where it is smaller (the JAX kernels'
// min over a (blk, tile) plane); K3's next-chunk lists are the mm least
// (entry, id) pairs after the cursor, kept by insertion per thread.
//
// Plain C interface for ctypes; the launchers return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;    // the "no hit" sentinel of a tile group
constexpr float kTriEps = 1e-12f;
constexpr int kMaxMM = 8;          // MAX_MM of the wrapper

__device__ __forceinline__ float safe_inv(float d) {
  float s = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / s;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays8,
                                        int i) {
  Ray r;
  const float* p = rays8 + (size_t)i * 8;
  r.ox = p[0]; r.oy = p[1]; r.oz = p[2];
  r.dx = p[3]; r.dy = p[4]; r.dz = p[5];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  return r;
}

// slab test of one box given as lo(3) hi(3) at stride `s` in `b`
__device__ __forceinline__ void slab(const float* b, int s, const Ray& r,
                                     float& tmn, float& tmx) {
  const float t0x = (b[0] - r.ox) * r.ix;
  const float t1x = (b[3 * s] - r.ox) * r.ix;
  const float t0y = (b[s] - r.oy) * r.iy;
  const float t1y = (b[4 * s] - r.oy) * r.iy;
  const float t0z = (b[2 * s] - r.oz) * r.iz;
  const float t1z = (b[5 * s] - r.oz) * r.iz;
  tmn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  tmx = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// Running result of one tile group for one lane.
struct Group {
  float lt;      // least valid t so far, starting at kBig
  int lid;       // its triangle id, -1 while none
  float lu, lv;
  bool any;      // any-hit form: some valid triangle
};

// Moller-Trumbore of `n` staged triangles (rows of s_tri at stride `st`)
// against one lane, valid below `bt0` (the carried best at group start).
template <bool ANY_HIT>
__device__ __forceinline__ void test_piece(const float* s_tri, int st, int n,
                                           const Ray& r, float bt0,
                                           Group& g) {
  for (int q = 0; q < n; ++q) {
    const float ax = s_tri[q], ay = s_tri[st + q], az = s_tri[2 * st + q];
    const float e1x = s_tri[3 * st + q], e1y = s_tri[4 * st + q];
    const float e1z = s_tri[5 * st + q];
    const float e2x = s_tri[6 * st + q], e2y = s_tri[7 * st + q];
    const float e2z = s_tri[8 * st + q];
    const float tid = s_tri[9 * st + q];
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    bool ok = fabsf(det) >= kTriEps;
    const float idet = 1.0f / (ok ? det : 1.0f);
    const float tvx = r.ox - ax, tvy = r.oy - ay, tvz = r.oz - az;
    const float u = (tvx * px + tvy * py + tvz * pz) * idet;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * idet;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * idet;
    ok = ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= 0.0f && t < bt0 && tid > 0.0f;
    if (ANY_HIT) {
      if (ok) {
        g.any = true;
        return;
      }
    } else if (ok && (t < g.lt || (g.lid < 0 && t == g.lt))) {
      g.lt = t; g.lid = (int)tid - 1; g.lu = u; g.lv = v;
    }
  }
}

// Moller tests of triangles [lo, hi) of one chunk's table `tc` (rows at
// stride tp) for the block, staged in pieces of blockDim.x; every thread
// of the block must call this. `live` lanes test, the others only stage.
template <bool ANY_HIT>
__device__ __forceinline__ void run_group(const float* __restrict__ tc,
                                          int tp, int lo, int hi,
                                          float* s_tri, const Ray& r,
                                          bool live, float& bt, int& bp,
                                          float& bu, float& bv) {
  const int blk = blockDim.x;
  const float bt0 = bt;
  Group g{kBig, -1, 0.0f, 0.0f, false};
  for (int base = lo; base < hi; base += blk) {
    const int n = min(blk, hi - base);
    __syncthreads();    // the previous piece is consumed
    if ((int)threadIdx.x < n) {
#pragma unroll
      for (int k = 0; k < 10; ++k)
        s_tri[k * blk + threadIdx.x] = tc[(size_t)k * tp + base + threadIdx.x];
    }
    __syncthreads();
    if (live && !(ANY_HIT && g.any))
      test_piece<ANY_HIT>(s_tri, blk, n, r, bt0, g);
  }
  if (ANY_HIT) {
    if (g.any) bp = max(bp, 1);
  } else if (g.lt < bt0) {
    bt = g.lt;
    bp = g.lid;
    bu = g.lid >= 0 ? g.lu : 0.0f;
    bv = g.lid >= 0 ? g.lv : 0.0f;
  }
}

// K2: visit-list chunk visits. Block b walks slots b*v_per .. +v_per-1.
template <bool ANY_HIT>
__global__ void __launch_bounds__(1024)
k2_kernel(const int* __restrict__ sel, const int* __restrict__ val,
          const float* __restrict__ tris, const float* __restrict__ tboxes,
          const float* __restrict__ rays8, const float* __restrict__ it,
          const int* __restrict__ ip, const float* __restrict__ iu,
          const float* __restrict__ iv, float* __restrict__ ot,
          int* __restrict__ op, float* __restrict__ ou,
          float* __restrict__ ov, int tp, int ntp, int tt, int v_per,
          int gr) {
  extern __shared__ float smem[];
  const int blk = blockDim.x;
  const int nt = tp / tt;
  const int ng = nt / gr;
  float* s_tri = smem;                            // 10 x blk
  float* s_tb = smem + 10 * blk;                  // 6 x nt tile boxes
  int* s_live = (int*)(s_tb + 6 * nt);            // nt flags
  const int b = blockIdx.x;
  const int i = b * blk + threadIdx.x;
  const Ray r = load_ray(rays8, i);
  float bt = it[i], bu = iu[i], bv = iv[i];
  int bp = ip[i];

  for (int v = 0; v < v_per; ++v) {
    const int slot = b * v_per + v;
    if (val[slot] <= 0) continue;                 // uniform over the block
    const bool lane = bt > 0.0f && (ANY_HIT ? bp <= 0 : true);
    if (!__syncthreads_or(lane)) continue;
    const int c = sel[slot];
    const float* tb = tboxes + (size_t)c * 8 * ntp;
    for (int j = threadIdx.x; j < nt; j += blk) {
#pragma unroll
      for (int k = 0; k < 6; ++k) s_tb[k * nt + j] = tb[(size_t)k * ntp + j];
      s_live[j] = 0;
    }
    __syncthreads();
    if (lane) {
      for (int j = 0; j < nt; ++j) {
        float tmn, tmx;
        slab(s_tb + j, nt, r, tmn, tmx);
        if (tmx >= 0.0f && tmn <= tmx && fmaxf(tmn, 0.0f) < bt)
          s_live[j] = 1;
      }
    }
    __syncthreads();
    const float* tc = tris + (size_t)c * 16 * tp;
    for (int g = 0; g < ng; ++g) {
      bool glive = false;
      for (int j = g * gr; j < (g + 1) * gr; ++j) glive |= s_live[j] != 0;
      if (!glive) continue;                       // uniform (shared flags)
      const bool live = bt > 0.0f && (ANY_HIT ? bp <= 0 : true);
      run_group<ANY_HIT>(tc, tp, g * gr * tt, (g + 1) * gr * tt, s_tri, r,
                         live, bt, bp, bu, bv);
    }
    __syncthreads();    // s_tb / s_live are rewritten by the next visit
  }
  ot[i] = bt; op[i] = bp; ou[i] = bu; ov[i] = bv;
}

// K3: one round-loop chunk visit per block, then each lane's next chunks.
template <bool ANY_HIT>
__global__ void __launch_bounds__(1024)
k3_kernel(const int* __restrict__ sel, const float* __restrict__ tris,
          const float* __restrict__ boxes_t, const float* __restrict__ rays8,
          const float* __restrict__ it, const int* __restrict__ ip,
          const float* __restrict__ iu, const float* __restrict__ iv,
          float* __restrict__ ot, int* __restrict__ op,
          float* __restrict__ ou, float* __restrict__ ov,
          int* __restrict__ onc, int tp, int cp, int tt, int mm,
          int c_real) {
  extern __shared__ float smem[];
  const int blk = blockDim.x;
  float* s_tri = smem;                  // 10 x blk
  float* s_bx = smem + 10 * blk;        // 6 x cp chunk boxes
  const int b = blockIdx.x;
  const int i = b * blk + threadIdx.x;
  const Ray r = load_ray(rays8, i);
  const float t_in = it[i];
  float bt = t_in, bu = iu[i], bv = iv[i];
  int bp = ip[i];
  int* out_nc = onc + (size_t)i * mm;

  const bool alive_in = ANY_HIT ? bp <= 0 : true;
  if (!__syncthreads_or(bt > 0.0f && alive_in)) {
    ot[i] = bt; op[i] = bp; ou[i] = bu; ov[i] = bv;
    for (int j = 0; j < mm; ++j) out_nc[j] = -1;
    return;                             // the whole block leaves
  }
  for (int j = threadIdx.x; j < cp; j += blk) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s_bx[k * cp + j] = boxes_t[(size_t)k * cp + j];
  }
  __syncthreads();

  const int c_id = sel[b];
  const bool scout = c_id < 0;
  float my_e = INFINITY;
  if (!scout) {
    float tmn, tmx;
    slab(s_bx + c_id, cp, r, tmn, tmx);
    if (tmx >= 0.0f && tmn <= tmx && c_id < c_real) my_e = fmaxf(tmn, 0.0f);
  }
  bool live = !scout && my_e < bt && bt > 0.0f;
  if (ANY_HIT) live = live && bp <= 0;
  if (__syncthreads_or(live)) {
    const float* tc = tris + (size_t)c_id * 16 * tp;
    const int nt = tp / tt;
    for (int k = 0; k < nt; ++k)
      run_group<ANY_HIT>(tc, tp, k * tt, (k + 1) * tt, s_tri, r,
                         live && !(ANY_HIT && bp > 0), bt, bp, bu, bv);
  }

  // next chunks after the cursor (entry, id) of this visit
  const float eff_t = ANY_HIT ? (bp > 0 ? 0.0f : t_in) : bt;
  const float cur_e = (scout || my_e == INFINITY) ? -INFINITY : my_e;
  const int cur_c = scout ? -1 : c_id;
  float le[kMaxMM];
  int lc[kMaxMM];
  int n = 0;
  if (eff_t > 0.0f) {                   // entries are >= 0
    for (int c = 0; c < c_real; ++c) {
      float tmn, tmx;
      slab(s_bx + c, cp, r, tmn, tmx);
      if (!(tmx >= 0.0f && tmn <= tmx)) continue;
      const float e = fmaxf(tmn, 0.0f);
      if (!(e < eff_t)) continue;
      if (!(e > cur_e || (e == cur_e && c > cur_c))) continue;
      // insert by (e, id); ids arrive ascending, so equal e keep order
      int k = n < mm ? n++ : mm;
      while (k > 0 && le[k - 1] > e) {
        if (k < mm) {
          le[k] = le[k - 1];
          lc[k] = lc[k - 1];
        }
        --k;
      }
      if (k < mm) {
        le[k] = e;
        lc[k] = c;
      }
    }
  }
  for (int j = 0; j < mm; ++j) out_nc[j] = j < n ? lc[j] : -1;
  ot[i] = bt; op[i] = bp; ou[i] = bu; ov[i] = bv;
}

}  // namespace

extern "C" int k2_vlaunch(const void* sel, const void* val, const void* tris,
                          const void* tboxes, const void* rays8,
                          const void* it, const void* ip, const void* iu,
                          const void* iv, void* ot, void* op, void* ou,
                          void* ov, int cap, int blk, int tp, int ntp,
                          int tt, int v_per, int gr, int any_hit,
                          void* stream) {
  if (cap <= 0) return 0;
  const int nt = tp / tt;
  const size_t smem = (size_t)(10 * blk + 7 * nt) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = cap / blk;
#define K2_ARGS                                                           \
  (const int*)sel, (const int*)val, (const float*)tris,                   \
      (const float*)tboxes, (const float*)rays8, (const float*)it,        \
      (const int*)ip, (const float*)iu, (const float*)iv, (float*)ot,     \
      (int*)op, (float*)ou, (float*)ov, tp, ntp, tt, v_per, gr
  if (any_hit)
    k2_kernel<true><<<blocks, blk, smem, s>>>(K2_ARGS);
  else
    k2_kernel<false><<<blocks, blk, smem, s>>>(K2_ARGS);
#undef K2_ARGS
  return (int)cudaGetLastError();
}

extern "C" int k3_launch(const void* sel, const void* tris,
                         const void* boxes_t, const void* rays8,
                         const void* it, const void* ip, const void* iu,
                         const void* iv, void* ot, void* op, void* ou,
                         void* ov, void* onc, int cap, int blk, int tp,
                         int cp, int tt, int mm, int c_real, int any_hit,
                         void* stream) {
  if (cap <= 0) return 0;
  const size_t smem = (size_t)(10 * blk + 6 * cp) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = cap / blk;
#define K3_ARGS                                                           \
  (const int*)sel, (const float*)tris, (const float*)boxes_t,             \
      (const float*)rays8, (const float*)it, (const int*)ip,              \
      (const float*)iu, (const float*)iv, (float*)ot, (int*)op,           \
      (float*)ou, (float*)ov, (int*)onc, tp, cp, tt, mm, c_real
  if (any_hit)
    k3_kernel<true><<<blocks, blk, smem, s>>>(K3_ARGS);
  else
    k3_kernel<false><<<blocks, blk, smem, s>>>(K3_ARGS);
#undef K3_ARGS
  return (int)cudaGetLastError();
}
