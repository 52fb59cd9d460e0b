// The per-ray near-first walk of the 8-wide fat-leaf BVH that K5
// (traverse_forest.cu) runs in each chunk, and the constants K1
// (traverse_stack.cu, which walks with a team of lanes a ray) and K4 share.
//
// One thread walks one ray: the 8 children of an inner node are slab-tested
// against the f32 node row (56 floats: 8 x [lo(3) hi(3)] + 8 refs as int
// bits), the hit ones pushed far-first onto a thread-local stack so the
// nearest pops next, and stale entries are pruned on pop against the running
// best t. Leaf rows (W x [v0 e1 e2 id]) are Moller-tested slot by slot.
// Children are visited in ascending (tmin, slot) order and every expression
// is evaluated in the order of the plain version (ops/traverse_stack.py);
// built with -fmad=false, kernel and plain version agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wide_walk {

// Stack entries a walk holds: 7 * (depth + 1) + 9 for a hierarchy of
// wide depth `depth` (ops/traverse_stack.py::stack_entries). kStackCap
// covers wide depth 16; kDeepStackCap covers 64, the depth of the binary
// builder's deepest tree (accel/bvh.py MAX_DEPTH), so no walk refuses a
// hierarchy the builder can make.
constexpr int kStackCap = 128;
constexpr int kDeepStackCap = 464;
constexpr float kBig = 3.0e38f;    // "no child" sentinel of the plain version
constexpr float kTriEps = 1e-12f;

__device__ __forceinline__ float safe_inv(float d) {
  float s = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / s;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Moller-Trumbore of one leaf slot s = [v0 e1 e2 id] against the ray, in
// the expression order of the plain versions, for K1 and K4; the result
// leaves out t < best. v and t are computed only where u passes, which
// changes no result, and __frcp_rn is the correctly rounded 1 / det that
// the plain versions compute.
__device__ __forceinline__ bool moller(const float (&s)[10], const Ray& r,
                                       float& t, float& u, float& v,
                                       int& id) {
  id = __float_as_int(s[9]);
  const float ax = s[0], ay = s[1], az = s[2];
  const float e1x = s[3], e1y = s[4], e1z = s[5];
  const float e2x = s[6], e2y = s[7], e2z = s[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  bool ok = fabsf(det) >= kTriEps;
  const float idet = __frcp_rn(ok ? det : 1.0f);
  const float tvx = r.ox - ax, tvy = r.oy - ay, tvz = r.oz - az;
  u = (tvx * px + tvy * py + tvz * pz) * idet;
  ok = ok && u >= 0.0f && u <= 1.0f && id >= 0;
  t = v = 0.0f;
  if (ok) {
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    v = (r.dx * qx + r.dy * qy + r.dz * qz) * idet;
    t = (e2x * qx + e2y * qy + e2z * qz) * idet;
    ok = v >= 0.0f && u + v <= 1.0f && t >= 0.0f;
  }
  return ok;
}

// Moller-Trumbore over the W slots of one leaf row. Closest form: keep the
// first slot achieving the least t below best_t. Any-hit form: return true
// at the first valid hit.
template <bool ANY_HIT>
__device__ __forceinline__ bool leaf_test(const float* __restrict__ row,
                                          int w, const Ray& r,
                                          float& best_t, int& best_prim,
                                          float& best_u, float& best_v) {
  float lt = best_t;
  int lj = -1, lid = -1;
  float lu = 0.0f, lv = 0.0f;
  for (int j = 0; j < w; ++j) {
    const float* s = row + j * 10;
    const int id = __float_as_int(s[9]);
    const float ax = s[0], ay = s[1], az = s[2];
    const float e1x = s[3], e1y = s[4], e1z = s[5];
    const float e2x = s[6], e2y = s[7], e2z = s[8];
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
         t >= 0.0f && id >= 0 && t < best_t;
    if (ANY_HIT) {
      if (ok) return true;
    } else if (ok && (lj < 0 || t < lt)) {
      lt = t; lj = j; lid = id; lu = u; lv = v;
    }
  }
  if (!ANY_HIT && lj >= 0) {
    best_t = lt; best_prim = lid; best_u = lu; best_v = lv;
  }
  return false;
}

// Walk the hierarchy rooted at `root_ref` (>= 0 an inner node, < 0 the
// leaf ~root_ref) for one ray, updating the best hit in place, with a
// thread-local stack of CAP entries. Returns true in the any-hit form when
// a triangle is hit before best_t.
template <bool ANY_HIT, int CAP = kStackCap>
__device__ __forceinline__ bool walk(const float* __restrict__ nodes,
                                     const float* __restrict__ leaves,
                                     int root_ref, int leaf_width,
                                     const Ray& r, float& best_t,
                                     int& best_prim, float& best_u,
                                     float& best_v) {
  const int row_len = leaf_width * 10;
  bool blocked = false;
  float skey[CAP];
  int sref[CAP];
  int sp = 0;

  if (root_ref < 0) {
    blocked = leaf_test<ANY_HIT>(leaves + (size_t)(~root_ref) * row_len,
                                 leaf_width, r, best_t, best_prim, best_u,
                                 best_v);
  } else {
    int node = root_ref;
    while (node >= 0) {
      // slab tests of the 8 children; hit children sorted by (tmin, slot)
      const float* row = nodes + (size_t)node * 56;
      float ck[8];
      int cr[8];
      int nc = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float lox = row[6 * j];
        if (isinf(lox)) continue;    // empty slot
        const float t0x = (lox - r.ox) * r.ix;
        const float t1x = (row[6 * j + 3] - r.ox) * r.ix;
        const float t0y = (row[6 * j + 1] - r.oy) * r.iy;
        const float t1y = (row[6 * j + 4] - r.oy) * r.iy;
        const float t0z = (row[6 * j + 2] - r.oz) * r.iz;
        const float t1z = (row[6 * j + 5] - r.oz) * r.iz;
        const float tmn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                fminf(t0z, t1z));
        const float tmx = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                fmaxf(t0z, t1z));
        if (tmx >= 0.0f && tmn <= tmx && tmn < best_t && tmn < kBig) {
          const int ref = __float_as_int(row[48 + j]);
          int k = nc++;
          while (k > 0 && ck[k - 1] > tmn) {   // stable: ties keep slot order
            ck[k] = ck[k - 1];
            cr[k] = cr[k - 1];
            --k;
          }
          ck[k] = tmn;
          cr[k] = ref;
        }
      }
      for (int k = nc - 1; k >= 0 && sp < CAP; --k) {   // far first
        skey[sp] = ck[k];
        sref[sp] = cr[k];
        ++sp;
      }
      // pop until the next inner node; leaves are tested on the way
      node = -1;
      while (sp > 0) {
        --sp;
        if (!(skey[sp] < best_t)) continue;   // made stale by a closer hit
        const int ref = sref[sp];
        if (ref >= 0) {
          node = ref;
          break;
        }
        if (leaf_test<ANY_HIT>(leaves + (size_t)(~ref) * row_len, leaf_width,
                               r, best_t, best_prim, best_u, best_v)) {
          blocked = true;
          sp = 0;
        }
      }
    }
  }
  return blocked;
}

}  // namespace wide_walk
