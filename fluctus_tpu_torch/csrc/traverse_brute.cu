// K2 and K3: brute-chunk traversal of the big-scene forest.
//
// K2 replaces the TPU kernel fluctus_tpu/ops/traverse_brute.py::_vkernel
// (with _vkernel_body and _moller_tile; launched by _vlaunch). K3 replaces
// traverse_brute.py::_kernel (with _kernel_body; launched by _launch).
//
// On the TPU a grid step held one (ray block, chunk) visit as (128, tile)
// vector planes and kept the block's best hit resident in VMEM across the
// visit steps of one block. Here a ray block of 128 rays runs on one
// cluster of CTAs: K2 walks the block's v_per visit slots in a loop inside
// the kernel and keeps the best hit in registers; K3 makes the block's one
// visit of the round loop, every tile of the chunk, then lists each lane's
// next chunks. Pallas's pl.when guards become block-uniform branches
// decided with __syncthreads_or.
//
// What bounds them on the H100: the Moller tests of the groups a block
// runs, ~55 FP32 instructions per triangle and live lane (chip_smoke.py's
// OPS_PER_TRI; a tile or chunk slab test is OPS_PER_CHILD = 26), so
// operations, with the triangle rows read from L2 (the conference's tables,
// 15 MB, fit in its 50 MB). The arithmetic stays simple and exact rather
// than fast: no FMAs (-fmad=false), IEEE division.
//
// The first design (one thread per ray, 128 threads, each piece of 128
// triangles copied through registers into shared memory between two
// __syncthreads, every thread testing the piece in order with 10 scalar
// shared loads a test) lost time three ways: 4 warps per block and ~4
// blocks per SM left each scheduler ~4 warps to hide a dependent Moller
// chain and its shared loads; every group cost two block barriers and a
// merge, and no copy overlapped a test; and a test issued as many
// shared-memory issue slots as FP32 ones. K2 and K3 now share one visit
// (`visit`):
// - A ray block is a cluster of kCluster CTAs of kTeams warp-teams (128
//   threads each). Every CTA holds the block's rays and carried best; a
//   visit's groups (K2: the live groups its tile slab tests list, those
//   tests dealt out over all the cluster's teams; K3: every tile of the
//   chunk, in order) are dealt out over the CTAs (entry e of the list to
//   CTA e % kCluster), and each group's slots over a CTA's teams, in
//   contiguous slices. The largest block of a launch, which sets the
//   launch's time once the small blocks are done, so runs on kCluster SMs
//   at once.
// - Each CTA stages its groups, team slice by team slice, with cp.async
//   into a ring of two buffers of kPiece triangles: several small groups
//   share a piece, a large group takes several. The next piece's copy is
//   in flight while the current one is tested; a piece costs one wait and
//   one CTA barrier, a visit one cluster barrier and the merge.
// - Each trip tests two triangles, read as float2 pairs (5 shared loads a
//   test), whose chains are independent. The registers this needs (one
//   CTA of 16 warps an SM) buy more than more resident warps would: capped
//   at 64 or 40 registers the pairs spill and K2 is slower
//   (scripts/probe_k2_design.py). K3 runs two CTAs an SM (kK3MinBlocks).
// - Each team keeps its least (t, group, slot) of the visit exactly as the
//   sequential loop keeps a group's (start at (3e38, -1), take t < lt or
//   (no hit yet and t == lt)), and the teams' results meet once per visit
//   through distributed shared memory: the least (t, group, team) among
//   their hits. The any-hit form stops a ray's other teams through the
//   CTAs' shared flags at their next piece. Why one merge per visit is the
//   per-group merge bit for bit is written above k2_kernel.
// - K3's next-chunk lists (the mm least (entry, id) chunks after the
//   cursor) are made after the merge by the first team of the first CTA.
// The Moller expressions and their order are the plain version's
// (ops/traverse_brute.py::_moller).
//
// Semantics equal the plain versions in ops/traverse_brute.py bit for bit
// (the same expressions in the same order): a tile group's result is its
// least valid t together with 3e38 and the first slot on equal t, and it
// replaces the carried best only where it is smaller (the JAX kernels'
// min over a (blk, tile) plane); K3's next-chunk lists are the mm least
// (entry, id) pairs after the cursor, kept by insertion per thread.
//
// Launchers: the package's one C signature (fluctus_tpu_torch/launch.py);
// they return cudaGetLastError(), or -1 for arguments out of range.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// ---------------------------------------------------- the visit of K2 and K3

constexpr int kRays = 128;       // rays per block (BLK)
constexpr int kTeams = 4;        // warp-teams per CTA
constexpr int kCluster = 2;      // CTAs (one cluster) per ray block
constexpr int kPiece = 512;      // triangles per staged piece, over all teams
constexpr int kMinBlocks = 1;    // K2's CTAs per SM, for the register cut
// K3's: at 64 registers its pairs spill a few bytes, yet two CTAs an SM run
// its blocks, which all test every tile of their chunk, faster than one
// (scripts/probe_k2_design.py --kernel k3); K2's uneven blocks do not gain.
constexpr int kK3MinBlocks = 2;
constexpr int kK2Threads = kRays * kTeams;
constexpr int kTeamPiece = kPiece / kTeams;     // a team's slots per piece
static_assert(kTeamPiece % 2 == 0, "a team's piece holds float2 pairs");

// slots of one team's slice of a group of gw slots (even, for the pairs)
__host__ __device__ __forceinline__ int k2_team_slots(int gw) {
  return ((gw + kTeams - 1) / kTeams + 1) & ~1;
}

// How a visit's live groups are staged: m whole groups per piece, or
// (m = 1) each group in ppg parts; pc slots of a team's part of a piece.
struct Pieces {
  int m, ppg, pc;
};

__host__ __device__ __forceinline__ Pieces k2_pieces(int gw) {
  const int gs = k2_team_slots(gw);
  if (gs <= kTeamPiece) return Pieces{kTeamPiece / gs, 1, kTeamPiece / gs * gs};
  return Pieces{1, (gs + kTeamPiece - 1) / kTeamPiece, kTeamPiece};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One Moller-Trumbore test with the plain version's expressions in its
// order; true where the triangle is hit validly below bt0.
__device__ __forceinline__ bool moller(const Ray& r, float ax, float ay,
                                       float az, float e1x, float e1y,
                                       float e1z, float e2x, float e2y,
                                       float e2z, float tid, float bt0,
                                       float& t, float& u, float& v) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) >= kTriEps;
  const float idet = 1.0f / (ok ? det : 1.0f);
  const float tvx = r.ox - ax, tvy = r.oy - ay, tvz = r.oz - az;
  u = (tvx * px + tvy * py + tvz * pz) * idet;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * idet;
  t = (e2x * qx + e2y * qy + e2z * qz) * idet;
  return ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= 0.0f && t < bt0 && tid > 0.0f;
}

// A team's least (t, group, slot) of a visit so far, as the sequential
// loop keeps it: start at (3e38, -1); id -1 while nothing was taken; key,
// the group's place in the visit's list of live groups.
struct Best {
  float t;
  int id;
  float u, v;
  int key;
};

__device__ __forceinline__ void take(Best& h, bool ok, float t, float tid,
                                     float u, float v, int key) {
  if (ok && (t < h.t || (h.id < 0 && t == h.t))) {
    h.t = t; h.id = (int)tid - 1; h.u = u; h.v = v; h.key = key;
  }
}

// Tests the n staged triangles of a team's slice of one group (rows at
// stride st) in slot order, valid below bt0. Closest form: into h;
// any-hit form: true at the first valid hit.
template <bool ANY_HIT>
__device__ __forceinline__ bool test_slice(const float* s, int st, int n,
                                           const Ray& r, float bt0,
                                           Best& h, int key) {
  for (int q = 0; q < n; q += 2) {
    float2 f[10];
#pragma unroll
    for (int k = 0; k < 10; ++k)
      f[k] = *reinterpret_cast<const float2*>(s + k * st + q);
    float ta, ua, va, tb, ub, vb;
    const bool oka = moller(r, f[0].x, f[1].x, f[2].x, f[3].x, f[4].x,
                            f[5].x, f[6].x, f[7].x, f[8].x, f[9].x, bt0,
                            ta, ua, va);
    const bool okb = moller(r, f[0].y, f[1].y, f[2].y, f[3].y, f[4].y,
                            f[5].y, f[6].y, f[7].y, f[8].y, f[9].y, bt0,
                            tb, ub, vb) && q + 1 < n;
    if (ANY_HIT) {
      if (oka || okb) return true;
    } else {
      take(h, oka, ta, f[9].x, ua, va, key);
      take(h, okb, tb, f[9].y, ub, vb, key);
    }
  }
  return false;
}

// Issues the cp.async copies of the calling team's part of piece i of
// this CTA's share of a visit (one commit group): its entries rank,
// rank + kCluster, ... of the visit's list gl of live groups, m whole
// groups a piece, or part i % ppg of one group. tc: the team slice's
// first slot of component 0 in the chunk (components at stride tp); dst:
// the piece buffer (components at stride st), the team's part at team * pc.
__device__ __forceinline__ void stage(float* dst, const float* tc, int tp,
                                      int gw, const int* gl, int nme, int i,
                                      Pieces pz, int gs, int len, int st,
                                      int rank, int ray, int team) {
  float* d = dst + team * pz.pc;
  if (pz.ppg == 1) {
    const int first = i * pz.m, cnt = min(pz.m, nme - first);
    for (int e = ray; e < cnt * gs; e += kRays) {
      const int j = e / gs, q = e - j * gs;
      if (q < len) {
        const float* src =
            tc + (size_t)gl[rank + kCluster * (first + j)] * gw + q;
#pragma unroll
        for (int k = 0; k < 10; ++k)
          cp_async4(d + k * st + e, src + (size_t)k * tp);
      }
    }
  } else {
    const int p = i % pz.ppg;
    const float* src =
        tc + (size_t)gl[rank + kCluster * (i / pz.ppg)] * gw + p * pz.pc;
    const int n = min(pz.pc, len - p * pz.pc);
    for (int q = ray; q < n; q += kRays) {
#pragma unroll
      for (int k = 0; k < 10; ++k)
        cp_async4(d + k * st + q, src + (size_t)k * tp + q);
    }
  }
  cp_async_commit();
}

// The visit's result from the records of every team of the cluster,
// merged into the carried best: the least (t, group, team) among their
// hits, or (3e38, -1), replacing the carried best where smaller. Any-hit:
// the ray's flags.
template <bool ANY_HIT>
__device__ __forceinline__ void merge(cg::cluster_group& cl, float4* red,
                                      int* s_key, int* s_hit, int ray,
                                      float& bt, int& bp, float& bu,
                                      float& bv) {
  if (ANY_HIT) {
    int hit = 0;
#pragma unroll
    for (int c = 0; c < kCluster; ++c)
      hit |= cl.map_shared_rank(s_hit, c)[ray];
    if (hit) bp = max(bp, 1);
    return;
  }
  Best g{kBig, -1, 0.0f, 0.0f, 0};
#pragma unroll
  for (int c = 0; c < kCluster; ++c) {
    const float4* rr = cl.map_shared_rank(red, c);
    const int* rk = cl.map_shared_rank(s_key, c);
#pragma unroll
    for (int k = 0; k < kTeams; ++k) {
      const float4 q = rr[k * kRays + ray];
      const int id = __float_as_int(q.w);
      const int key = rk[k * kRays + ray];
      if (id >= 0 &&
          (g.id < 0 || q.x < g.t || (q.x == g.t && key < g.key))) {
        g.t = q.x; g.id = id; g.u = q.y; g.v = q.z; g.key = key;
      }
    }
  }
  if (g.t < bt) {
    bt = g.t;
    bp = g.id;
    bu = g.id >= 0 ? g.u : 0.0f;
    bv = g.id >= 0 ? g.v : 0.0f;
  }
}

// Whether some CTA of the cluster has blocked the ray (any-hit form).
__device__ __forceinline__ bool blocked(cg::cluster_group& cl, int* s_hit,
                                        int ray) {
  int hit = 0;
#pragma unroll
  for (int c = 0; c < kCluster; ++c)
    hit |= *reinterpret_cast<volatile int*>(cl.map_shared_rank(s_hit, c) +
                                            ray);
  return hit != 0;
}

// Shared memory of a visit, the same layout in every CTA of a cluster.
struct VisitSmem {
  float4* red;     // kTeams x kRays: each team's least (t, u, v, id)
  float* tri;      // 2 x 10 x st: the ring of staged pieces
  int* key;        // kTeams x kRays: the group of each team's least
  int* hit;        // kRays: any-hit flags
};

// The visit's floats of shared memory before the caller's own, at
// component stride st.
__host__ __device__ __forceinline__ size_t visit_smem_floats(int st) {
  return (size_t)kTeams * kRays * 4 + (size_t)2 * 10 * st +
         kTeams * kRays + kRays;
}

__device__ __forceinline__ VisitSmem visit_smem(float* base, int st) {
  VisitSmem sm;
  sm.red = reinterpret_cast<float4*>(base);
  sm.tri = base + kTeams * kRays * 4;
  sm.key = reinterpret_cast<int*>(sm.tri + 2 * 10 * st);
  sm.hit = sm.key + kTeams * kRays;
  return sm;
}

// One chunk visit of the ray block, on every thread of every CTA of its
// cluster: the Moller tests of the ngl groups listed in gl (gw slots
// each, rows of the chunk at stride tp; tc is the calling team slice's
// first slot of component 0), this CTA taking entries rank, rank +
// kCluster, ..., its teams a slice of each, then the merge into the
// carried best (t, prim or blocked, u, v). `lane`: whether this ray
// tests; the first group is tested below the best t at the visit's start,
// the others below min(that, 3e38). Any-hit flags must be 0, and visible
// to the whole cluster, for a ray that tests. Ends with every team's
// record read; the caller passes one more cluster barrier before a CTA
// writes its shared memory again or leaves.
template <bool ANY_HIT>
__device__ __forceinline__ void visit(cg::cluster_group& cl,
                                      const VisitSmem& sm, const float* tc,
                                      int tp, int gw, const int* gl, int ngl,
                                      Pieces pz, int gs, int len, int st,
                                      int rank, int ray, int team,
                                      const Ray& r, bool lane, float& bt,
                                      int& bp, float& bu, float& bv) {
  const int nme = (ngl - rank + kCluster - 1) / kCluster;   // my entries
  const int n_pieces = pz.ppg == 1 ? (nme + pz.m - 1) / pz.m
                                   : nme * pz.ppg;
  const float bt0 = bt, bt0c = fminf(bt, kBig);
  Best h{kBig, -1, 0.0f, 0.0f, 0};
  if (n_pieces > 0)
    stage(sm.tri, tc, tp, gw, gl, nme, 0, pz, gs, len, st, rank, ray, team);
  for (int p = 0; p < n_pieces; ++p) {
    cp_async_wait_all();
    __syncthreads();      // piece p visible; the other buffer is free
    if (p + 1 < n_pieces)
      stage(sm.tri + ((p + 1) & 1) * 10 * st, tc, tp, gw, gl, nme, p + 1,
            pz, gs, len, st, rank, ray, team);
    if (!lane || (ANY_HIT && blocked(cl, sm.hit, ray))) continue;
    const float* part = sm.tri + (p & 1) * 10 * st + team * pz.pc;
    bool hit = false;
    if (pz.ppg == 1) {
      const int first = p * pz.m, cnt = min(pz.m, nme - first);
      for (int j = 0; j < cnt && !hit; ++j) {
        const int e = rank + kCluster * (first + j);
        hit = test_slice<ANY_HIT>(part + j * gs, st, len, r,
                                  e == 0 ? bt0 : bt0c, h, e);
      }
    } else {
      const int e = rank + kCluster * (p / pz.ppg);
      const int q0 = (p % pz.ppg) * pz.pc;
      hit = test_slice<ANY_HIT>(part, st, min(pz.pc, len - q0), r,
                                e == 0 ? bt0 : bt0c, h, e);
    }
    if (ANY_HIT && hit) sm.hit[ray] = 1;
  }
  if (!ANY_HIT) {
    sm.red[team * kRays + ray] =
        make_float4(h.t, h.u, h.v, __int_as_float(h.id));
    sm.key[team * kRays + ray] = h.key;
  }
  cl.sync();                  // every team's record is written
  merge<ANY_HIT>(cl, sm.red, sm.key, sm.hit, ray, bt, bp, bu, bv);
}

// ---------------------------------------------------------------- K2

// K2: visit-list chunk visits. Ray block b is one cluster of kCluster
// CTAs; it walks visit slots b*v_per .. +v_per-1. Every CTA holds the
// block's 128 rays and the same carried best; in a CTA, thread (team, ray)
// = (threadIdx.x / 128, threadIdx.x % 128). The tile slab tests are dealt
// out over the cluster's teams, the visit's live groups over its CTAs
// (entry e of the list to CTA e % kCluster) and each group's slots over a
// CTA's teams.
//
// Within a visit every group is tested below the best t at the visit's
// start (below min(that, 3e38) after its first group) and the teams'
// results merge once, at the visit's end. That is the sequential
// per-group merge: a group's candidates below the carried best are a
// subset of these, the least (t, group, slot) of the visit is the one
// the sequential strict-< merges keep, and any candidate at or above the
// sequential threshold loses the final comparison with the carried best.
// Which groups a visit runs is decided from the exact best at its start.
// The same holds for a K3 visit, whose list is every tile of the chunk in
// order: K3's per-tile loop is this per-group merge with gr = 1.
template <bool ANY_HIT>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kK2Threads, kMinBlocks)
k2_kernel(const int* __restrict__ sel, const int* __restrict__ val,
          const float* __restrict__ tris, const float* __restrict__ tboxes,
          const float* __restrict__ rays8, const float* __restrict__ it,
          const int* __restrict__ ip, const float* __restrict__ iu,
          const float* __restrict__ iv, float* __restrict__ ot,
          int* __restrict__ op, float* __restrict__ ou,
          float* __restrict__ ov, int tp, int ntp, int tt, int v_per,
          int gr) {
  extern __shared__ __align__(16) float k2_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int nt = tp / tt;
  const int ng = nt / gr;
  const int gw = gr * tt;
  const int gs = k2_team_slots(gw);
  const Pieces pz = k2_pieces(gw);
  const int st = kTeams * pz.pc;                 // component stride
  const VisitSmem sm = visit_smem(k2_smem, st);
  int* s_glive = sm.hit + kRays;                        // ng group flags
  int* s_gl = s_glive + ng;                             // ng + 1: live list
  float* s_tb = reinterpret_cast<float*>(s_gl + ng + 1);  // 6 x nt boxes
  const int ray = threadIdx.x % kRays;
  const int team = threadIdx.x / kRays;
  const int len = max(0, min(gs, gw - team * gs));   // the team's slice
  const int b = blockIdx.x / kCluster;
  const int i = b * kRays + ray;
  const Ray r = load_ray(rays8, i);
  float bt = it[i], bu = iu[i], bv = iv[i];
  int bp = ip[i];
  if (ANY_HIT && team == 0) sm.hit[ray] = 0;
  cl.sync();                  // every CTA's flags are set before any read

  for (int v = 0; v < v_per; ++v) {
    const int slot = b * v_per + v;
    if (val[slot] <= 0) continue;               // uniform over the cluster
    const bool lane = bt > 0.0f && (ANY_HIT ? bp <= 0 : true);
    if (!__syncthreads_or(lane)) continue;      // the same in every CTA
    const int c = sel[slot];
    const float* tb = tboxes + (size_t)c * 8 * ntp;
    for (int j = threadIdx.x; j < nt; j += kK2Threads) {
#pragma unroll
      for (int k = 0; k < 6; ++k) s_tb[k * nt + j] = tb[(size_t)k * ntp + j];
    }
    for (int j = threadIdx.x; j < ng; j += kK2Threads) s_glive[j] = 0;
    __syncthreads();
    if (lane) {
      for (int j = rank * kTeams + team; j < nt; j += kCluster * kTeams) {
        float tmn, tmx;
        slab(s_tb + j, nt, r, tmn, tmx);
        if (tmx >= 0.0f && tmn <= tmx && fmaxf(tmn, 0.0f) < bt)
          s_glive[j / gr] = 1;
      }
    }
    cl.sync();                // every CTA's flags are written
    if (threadIdx.x < 32) {   // warp 0 lists the groups live in any CTA
      int n = 0;
      for (int j0 = 0; j0 < ng; j0 += 32) {
        const int j = j0 + (int)threadIdx.x;
        int f = 0;
        if (j < ng) {
#pragma unroll
          for (int q = 0; q < kCluster; ++q)
            f |= cl.map_shared_rank(s_glive, q)[j];
        }
        const unsigned m = __ballot_sync(0xffffffffu, f != 0);
        if (f) s_gl[n + __popc(m & ((1u << threadIdx.x) - 1u))] = j;
        n += __popc(m);
      }
      if (threadIdx.x == 0) s_gl[ng] = n;
    }
    __syncthreads();
    const int ngl = s_gl[ng];
    if (ngl == 0) {           // uniform over the cluster; the flags are
      cl.sync();              // reset only after every CTA has read them
      continue;
    }
    visit<ANY_HIT>(cl, sm, tris + (size_t)c * 16 * tp + team * gs, tp, gw,
                   s_gl, ngl, pz, gs, len, st, rank, ray, team, r, lane,
                   bt, bp, bu, bv);
  }
  if (rank == 0 && team == 0) {
    ot[i] = bt; op[i] = bp; ou[i] = bu; ov[i] = bv;
  }
  cl.sync();                  // no CTA leaves while another reads it
}

// dynamic shared memory of a K2 launch, in floats
__host__ __forceinline__ size_t k2_smem_floats(int nt, int ng, int pc) {
  return visit_smem_floats(kTeams * pc) + 2 * ng + 1 + 6 * nt;
}

// ---------------------------------------------------------------- K3

// K3: one round-loop chunk visit per ray block, then each lane's next
// chunks. Ray block b (a cluster, laid out as K2's) visits chunk sel[b],
// or none for a scout launch (sel -1). A block with no lane alive (t > 0
// and, any-hit, not blocked) keeps its seeds and gets no next chunks.
// Otherwise each lane's entry into the chunk comes from its slab; when
// some lane enters the chunk below its best t, the visit tests every tile
// of tt triangles, in order, for those lanes and merges into every lane of
// the block (a lane that does not test takes the visit's (3e38, -1) where
// its best t is larger, as the sequential per-tile merge gives it). Then
// the first team of the first CTA lists each lane's mm least (entry, id)
// chunks after the cursor (the visited chunk's entry and id, or (-inf,
// -1) for a scout or a lane that missed it) with entry below its best t
// (any-hit: its t at entry, or 0 once blocked).
template <bool ANY_HIT>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kK2Threads, kK3MinBlocks)
k3_kernel(const int* __restrict__ sel, const float* __restrict__ tris,
          const float* __restrict__ boxes_t, const float* __restrict__ rays8,
          const float* __restrict__ it, const int* __restrict__ ip,
          const float* __restrict__ iu, const float* __restrict__ iv,
          float* __restrict__ ot, int* __restrict__ op,
          float* __restrict__ ou, float* __restrict__ ov,
          int* __restrict__ onc, int tp, int cp, int tt, int mm,
          int c_real) {
  extern __shared__ __align__(16) float k3_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int nt = tp / tt;
  const int gs = k2_team_slots(tt);
  const Pieces pz = k2_pieces(tt);
  const int st = kTeams * pz.pc;                 // component stride
  const VisitSmem sm = visit_smem(k3_smem, st);
  int* s_gl = sm.hit + kRays;                           // nt: every tile
  float* s_bx = reinterpret_cast<float*>(s_gl + nt);    // 6 x cp boxes
  const int ray = threadIdx.x % kRays;
  const int team = threadIdx.x / kRays;
  const int len = max(0, min(gs, tt - team * gs));   // the team's slice
  const int b = blockIdx.x / kCluster;
  const int i = b * kRays + ray;
  const bool writer = rank == 0 && team == 0;        // writes ray i
  const Ray r = load_ray(rays8, i);
  const float t_in = it[i];
  float bt = t_in, bu = iu[i], bv = iv[i];
  int bp = ip[i];
  int* out_nc = onc + (size_t)i * mm;

  const bool alive_in = ANY_HIT ? bp <= 0 : true;
  if (!__syncthreads_or(bt > 0.0f && alive_in)) {   // the same in every CTA
    if (writer) {
      ot[i] = bt; op[i] = bp; ou[i] = bu; ov[i] = bv;
      for (int j = 0; j < mm; ++j) out_nc[j] = -1;
    }
    return;                             // the whole cluster leaves
  }
  for (int j = threadIdx.x; j < cp; j += kK2Threads) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s_bx[k * cp + j] = boxes_t[(size_t)k * cp + j];
  }
  for (int j = threadIdx.x; j < nt; j += kK2Threads) s_gl[j] = j;
  if (ANY_HIT && team == 0) sm.hit[ray] = 0;
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
  const bool run = __syncthreads_or(live);   // the same in every CTA
  if (run) {
    cl.sync();                // every CTA's flags are reset before any read
    visit<ANY_HIT>(cl, sm, tris + (size_t)c_id * 16 * tp + team * gs, tp,
                   tt, s_gl, nt, pz, gs, len, st, rank, ray, team, r, live,
                   bt, bp, bu, bv);
  }

  if (writer) {
    // next chunks after the cursor (entry, id) of this visit
    const float eff_t = ANY_HIT ? (bp > 0 ? 0.0f : t_in) : bt;
    const float cur_e = (scout || my_e == INFINITY) ? -INFINITY : my_e;
    const int cur_c = scout ? -1 : c_id;
    float le[kMaxMM];
    int lc[kMaxMM];
    int n = 0;
    if (eff_t > 0.0f) {                 // entries are >= 0
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
  if (run) cl.sync();         // no CTA leaves while another reads it
}

// dynamic shared memory of a K3 launch, in floats
__host__ __forceinline__ size_t k3_smem_floats(int nt, int pc, int cp) {
  return visit_smem_floats(kTeams * pc) + nt + 6 * (size_t)cp;
}

}  // namespace

constexpr size_t kMaxSmem = 232448;    // a block's shared memory on Hopper

// The K2 launch's dynamic shared memory in bytes (0 if it does not fit).
static size_t k2_smem(int tp, int tt, int gr) {
  const int nt = tp / tt;
  const size_t smem =
      k2_smem_floats(nt, nt / gr, k2_pieces(gr * tt).pc) * sizeof(float);
  return smem > kMaxSmem ? 0 : smem;
}

// The K3 launch's dynamic shared memory in bytes (0 if it does not fit).
static size_t k3_smem(int tp, int tt, int cp) {
  const size_t smem =
      k3_smem_floats(tp / tt, k2_pieces(tt).pc, cp) * sizeof(float);
  return smem > kMaxSmem ? 0 : smem;
}

// Allows K2's (or, with K3, K3's) kernel `smem` bytes of dynamic shared
// memory on the current device; the attribute is set only when a launch
// needs more than that device was allowed before.
template <bool ANY_HIT, bool K3>
static cudaError_t allow(size_t smem) {
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem <= 48 * 1024 || (dev < kMaxDevices && smem <= allowed[dev]))
    return cudaSuccess;
  if constexpr (K3)
    e = cudaFuncSetAttribute(k3_kernel<ANY_HIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  else
    e = cudaFuncSetAttribute(k2_kernel<ANY_HIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return e;
}

// a: sel, val, tris, tboxes, rays8, it, ip, iu, iv, ot, op, ou, ov, cap,
// blk, tp, ntp, tt, v_per, gr, any_hit, stream.
extern "C" int k2_vlaunch(const long long* a, int n) {
  if (n != 22) return -1;
  const int cap = (int)a[13], blk = (int)a[14], tp = (int)a[15];
  const int ntp = (int)a[16], tt = (int)a[17], v_per = (int)a[18];
  const int gr = (int)a[19];
  if (cap <= 0) return 0;
  if (blk != kRays || cap % kRays || tt <= 0 || gr <= 0 || tp % tt ||
      (tp / tt) % gr || tp / tt > ntp)
    return -1;
  const size_t smem = k2_smem(tp, tt, gr);
  if (smem == 0) return -1;
  cudaStream_t s = (cudaStream_t)a[21];
  const int blocks = cap / kRays;
  const bool any_hit = a[20] != 0;
  const cudaError_t e = any_hit ? allow<true, false>(smem)
                                : allow<false, false>(smem);
  if (e != cudaSuccess) return (int)e;
#define K2_ARGS                                                           \
  (const int*)a[0], (const int*)a[1], (const float*)a[2],                 \
      (const float*)a[3], (const float*)a[4], (const float*)a[5],         \
      (const int*)a[6], (const float*)a[7], (const float*)a[8],           \
      (float*)a[9], (int*)a[10], (float*)a[11], (float*)a[12], tp, ntp,   \
      tt, v_per, gr
  if (any_hit)
    k2_kernel<true><<<blocks * kCluster, kK2Threads, smem, s>>>(K2_ARGS);
  else
    k2_kernel<false><<<blocks * kCluster, kK2Threads, smem, s>>>(K2_ARGS);
#undef K2_ARGS
  return (int)cudaGetLastError();
}

// K2's resident warps at dynamic shared memory `smem`: per SM from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (cluster = 0), or on the
// whole card from cudaOccupancyMaxActiveClusters, which also counts where
// the clusters fit (cluster = 1); -1 on an error.
template <bool ANY_HIT>
static int k2_warps(size_t smem, bool cluster) {
  if (allow<ANY_HIT, false>(smem) != cudaSuccess) return -1;
  int n = 0;
  if (!cluster) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, k2_kernel<ANY_HIT>, kK2Threads, smem) != cudaSuccess)
      return -1;
    return n * kK2Threads / 32;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kK2Threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  if (cudaOccupancyMaxActiveClusters(&n, k2_kernel<ANY_HIT>, &cfg) !=
      cudaSuccess)
    return -1;
  return n * kCluster * kK2Threads / 32;
}

// a: tp, tt, gr, any_hit, cluster, stream (unused). Returns k2_warps at
// that shape, or -1.
extern "C" int k2_occupancy(const long long* a, int n) {
  if (n != 6) return -1;
  const int tp = (int)a[0], tt = (int)a[1], gr = (int)a[2];
  if (tt <= 0 || gr <= 0 || tp % tt || (tp / tt) % gr) return -1;
  const size_t smem = k2_smem(tp, tt, gr);
  if (smem == 0) return -1;
  return a[3] ? k2_warps<true>(smem, a[4] != 0)
              : k2_warps<false>(smem, a[4] != 0);
}

// a: sel, tris, boxes_t, rays8, it, ip, iu, iv, ot, op, ou, ov, onc, cap,
// blk, tp, cp, tt, mm, c_real, any_hit, stream.
extern "C" int k3_launch(const long long* a, int n) {
  if (n != 22) return -1;
  const int cap = (int)a[13], blk = (int)a[14], tp = (int)a[15];
  const int cp = (int)a[16], tt = (int)a[17], mm = (int)a[18];
  const int c_real = (int)a[19];
  if (cap <= 0) return 0;
  if (blk != kRays || cap % kRays || tt <= 0 || tp % tt || mm <= 0 ||
      mm > kMaxMM || c_real > cp)
    return -1;
  const size_t smem = k3_smem(tp, tt, cp);
  if (smem == 0) return -1;
  cudaStream_t s = (cudaStream_t)a[21];
  const int blocks = cap / kRays;
  const bool any_hit = a[20] != 0;
  const cudaError_t e = any_hit ? allow<true, true>(smem)
                                : allow<false, true>(smem);
  if (e != cudaSuccess) return (int)e;
#define K3_ARGS                                                           \
  (const int*)a[0], (const float*)a[1], (const float*)a[2],               \
      (const float*)a[3], (const float*)a[4], (const int*)a[5],           \
      (const float*)a[6], (const float*)a[7], (float*)a[8], (int*)a[9],   \
      (float*)a[10], (float*)a[11], (int*)a[12], tp, cp, tt, mm, c_real
  if (any_hit)
    k3_kernel<true><<<blocks * kCluster, kK2Threads, smem, s>>>(K3_ARGS);
  else
    k3_kernel<false><<<blocks * kCluster, kK2Threads, smem, s>>>(K3_ARGS);
#undef K3_ARGS
  return (int)cudaGetLastError();
}
