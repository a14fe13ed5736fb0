// The wide-BVH walk of one ray by one thread, shared by csrc/traverse.cu
// (closest-hit and any-hit queries on MT-leaf tables), csrc/cluster_traverse.cu
// (the same on dense cluster-leaf tables) and csrc/megakernel.cu (the walks
// inside the whole-path estimator). One node phase, `walk`, is generic over
// its leaf routine: MtLeaf or ClusterLeaf.
//
// The MT-leaf table is the merged 128-float row table of bvh/wide.py
// pack_for_packets:
//   node row : cols 0:48  = 8 children x (min.xyz, max.xyz)
//              cols 48:56 = 8 child entries (int32 bit-cast)
//   leaf rows: 10 slots of 12 floats (p0, e1, e2, prim id bit-cast, material
//              id bit-cast, normal sign); a leaf spans ceil(leaf_size / 10)
//              consecutive rows.
// Entries: INVALID (0x7FFFFFFF) = empty slot, e >= 0 = node row e,
// e < 0 = leaf, packed = -(e + 1): first row = packed >> 4, count = packed & 15.
// On a cluster scene (bvh/cluster.py pack_clusters) the rows hold the cluster
// top tree's nodes alone, and a leaf's packed >> 4 is a cluster index into
// the [Ncl * 8, 3 * tc] cluster table (see ClusterLeaf).
//
// The arithmetic is the Pallas kernels', term by term, as XLA compiles them
// for the CPU (where the JAX package's tests and goldens run): slab test as
// fma(lo, inv, -o*inv), Moller-Trumbore with strict inequalities and the
// fused multiply-adds LLVM forms there (ops/intersect.py), the cluster
// leaves' dot products in the order of XLA's CPU dot. The sources are built
// with --fmad=false so that nvcc contracts nothing else and every division
// stays an IEEE division; the walks are then bit-identical to their plain
// torch versions (ops/kernel_traverse.py walk_plain, ops/kernel_cluster.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bvh {

constexpr int kRow = 128;
constexpr int kArity = 8;
constexpr int kTrisPerRow = kRow / 12;  // 10
constexpr int kMaxStack = 192;          // cfg.stack_depth * 4
constexpr int kInvalid = 0x7FFFFFFF;

struct Ray {
  float o[3], d[3], inv[3], oi[3];
};

// min/max that return NaN when either input is NaN, as torch.minimum /
// torch.maximum and jnp.minimum / jnp.maximum do (fminf/fmaxf would drop
// the NaN).
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ Ray make_ray(const float o[3], const float d[3]) {
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = o[a];
    r.d[a] = d[a];
    // sign(d) / max(|d|, 1e-12)  (pallas_traverse.py:1311-1312)
    r.inv[a] = (d[a] >= 0.0f ? 1.0f : -1.0f) / nan_max(fabsf(d[a]), 1e-12f);
    r.oi[a] = o[a] * r.inv[a];
  }
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  const float oo[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const float dd[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  return make_ray(oo, dd);
}

// Expands one node row: pushes the children the ray enters before t, so
// that they pop in ascending (t_near, slot) order when `ordered`, in slot
// order otherwise. Pushes past `depth` are dropped.
__device__ __forceinline__ void expand_node(const float* __restrict__ row,
                                            const Ray& r, float t,
                                            bool ordered, int* stack, int& sp,
                                            int depth) {
  float key[kArity];
  int slot[kArity];
  int total = 0;
#pragma unroll
  for (int j = 0; j < kArity; ++j) {
    float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float t0 = __fmaf_rn(row[j * 6 + a], r.inv[a], -r.oi[a]);
      float t1 = __fmaf_rn(row[j * 6 + 3 + a], r.inv[a], -r.oi[a]);
      float lo = nan_min(t0, t1);
      float hi = nan_max(t0, t1);
      tmin = a == 0 ? lo : nan_max(tmin, lo);
      tmax = a == 0 ? hi : nan_min(tmax, hi);
    }
    int entry = __float_as_int(row[6 * kArity + j]);
    if (tmin <= tmax && tmax > 0.0f && tmin < t && entry != kInvalid) {
      // Insertion by (key, slot): slots arrive ascending, so a strict
      // comparison keeps equal keys in slot order.
      int k = total++;
      if (ordered) {
        while (k > 0 && key[k - 1] > tmin) {
          key[k] = key[k - 1];
          slot[k] = slot[k - 1];
          --k;
        }
      }
      key[k] = tmin;
      slot[k] = j;
    }
  }
  // Farthest first, so the nearest child ends on top of the stack.
  for (int k = total - 1; k >= 0; --k) {
    int pos = sp + (total - 1 - k);
    if (pos < depth) stack[pos] = __float_as_int(row[6 * kArity + slot[k]]);
  }
  sp = min(sp + total, depth);
}

// Moller-Trumbore against the `count` slots of one leaf block, in the
// operation order of pallas_traverse.py:265-280 and the roundings of
// ops/intersect.py mt_intersect. A hit records t, prim, u, v and the slot
// it came from. With `any_hit`, returns at the first hit.
__device__ __forceinline__ void intersect_leaf(const float* __restrict__ block,
                                               int count, const Ray& r,
                                               bool any_hit, float& t,
                                               int& prim, float& u, float& v,
                                               const float*& slot) {
  const float* d = r.d;
  for (int k = 0; k < count; ++k) {
    const float* s = block + (k / kTrisPerRow) * kRow + (k % kTrisPerRow) * 12;
    float p0x = s[0], p0y = s[1], p0z = s[2];
    float e1x = s[3], e1y = s[4], e1z = s[5];
    float e2x = s[6], e2y = s[7], e2z = s[8];
    float px = __fmaf_rn(d[1], e2z, -(d[2] * e2y));
    float py = __fmaf_rn(d[2], e2x, -(d[0] * e2z));
    float pz = __fmaf_rn(d[0], e2y, -(d[1] * e2x));
    float det = __fmaf_rn(e1z, pz, __fmaf_rn(e1y, py, e1x * px));
    float idet = 1.0f / det;
    float tx = r.o[0] - p0x;
    float ty = r.o[1] - p0y;
    float tz = r.o[2] - p0z;
    float uu = __fmaf_rn(tz, pz, __fmaf_rn(tx, px, ty * py)) * idet;
    float qx = __fmaf_rn(ty, e1z, -(tz * e1y));
    float qy = __fmaf_rn(tz, e1x, -(tx * e1z));
    float qz = __fmaf_rn(tx, e1y, -(ty * e1x));
    float vv = __fmaf_rn(d[2], qz, __fmaf_rn(d[0], qx, d[1] * qy)) * idet;
    float tt = __fmaf_rn(e2z, qz, __fmaf_rn(e2x, qx, e2y * qy)) * idet;
    if (uu > 0.0f && uu < 1.0f && vv > 0.0f && uu + vv < 1.0f &&
        tt > 0.0f && tt < t) {
      t = tt;
      prim = __float_as_int(s[9]);
      u = uu;
      v = vv;
      slot = s;
      if (any_hit) return;
    }
  }
}

// The leaf routine of MT-leaf tables: records the closest hit's prim, u, v
// and leaf slot (the megakernel's hit-time capture). Returns true once a hit
// is recorded (the walk reads it only for any-hit, which ends at the first).
template <bool kAnyHit>
struct MtLeaf {
  const float* rows;
  int prim = -1;
  float u = 0.0f, v = 0.0f;
  const float* slot = nullptr;

  __device__ __forceinline__ explicit MtLeaf(const float* r) : rows(r) {}

  __device__ __forceinline__ bool operator()(int packed, const Ray& r,
                                             float& t) {
    intersect_leaf(rows + (size_t)(packed >> 4) * kRow, packed & 15, r,
                   kAnyHit, t, prim, u, v, slot);
    return prim >= 0;
  }
};

// sum_a m[a * w] * x[a] rounded as XLA's CPU dot rounds the cluster kernel's
// K = 3 contractions: fma(m2, x2, fma(m1, x1, m0 * x0)).
__device__ __forceinline__ float dot_k3(const float* m, int w, const float* x) {
  return __fmaf_rn(m[2 * w], x[2], __fmaf_rn(m[w], x[1], m[0] * x[0]));
}

// The same sum as LLVM contracts the elementwise winner recompute of
// pallas_traverse.py:544-551: fma(m2, x2, fma(m0, x0, m1 * x1)).
__device__ __forceinline__ float dot_rc(const float* m, int w, const float* x) {
  return __fmaf_rn(m[2 * w], x[2], __fmaf_rn(m[0], x[0], m[w] * x[1]));
}

// One dense cluster block [8, 3 * tc] (bvh/cluster.py), lanes in thirds
// A | B | C of the inverse matrix per triangle slot: rows 0:3 the direction
// coefficients (wd), rows 3:7 the origin coefficients with the folded
// constant in row 6 (wo4), row 7 the signed material float in the first
// third. For slot j: t = num / dc, u = oa + t * da, v = ob + t * db, valid iff
// u > 0, v > 0, u + v < 1, t > 0 (padding slots are all zero: t = NaN fails
// every comparison). Returns the smallest valid t and in `slot` the lowest
// slot that has it (pallas_traverse.py:507-538), +inf when none is valid.
// With any_hit, returns at the first valid slot with t < t_cur and +inf when
// there is none: the occlusion answer is the same.
__device__ __forceinline__ float cluster_min(const float* __restrict__ blk,
                                             int tc, const Ray& r,
                                             bool any_hit, float t_cur,
                                             int& slot) {
  const int w = 3 * tc;
  const float* wo = blk + 3 * w;
  float best = __int_as_float(0x7f800000);  // +inf
  slot = 0;
  for (int j = 0; j < tc; ++j) {
    float da = dot_k3(blk + j, w, r.d);
    float db = dot_k3(blk + tc + j, w, r.d);
    float dc = dot_k3(blk + 2 * tc + j, w, r.d);
    float oa = dot_k3(wo + j, w, r.o) + wo[3 * w + j];
    float ob = dot_k3(wo + tc + j, w, r.o) + wo[3 * w + tc + j];
    float num = dot_k3(wo + 2 * tc + j, w, r.o) + wo[3 * w + 2 * tc + j];
    float tt = num / dc;
    float uu = __fmaf_rn(tt, da, oa);
    float vv = __fmaf_rn(tt, db, ob);
    if (uu > 0.0f && vv > 0.0f && uu + vv < 1.0f && tt > 0.0f) {
      if (any_hit) {
        if (tt < t_cur) {
          slot = j;
          return tt;
        }
      } else if (tt < best) {
        best = tt;
        slot = j;
      }
    }
  }
  return best;
}

// u, v of the winning slot at t, recomputed from its A and B origin rows
// as pallas_traverse.py:544-553 does (not the per-slot values, which can
// differ in the last place).
__device__ __forceinline__ void cluster_uv(const float* __restrict__ blk,
                                           int tc, int slot, const Ray& r,
                                           float t, float& u, float& v) {
  const int w = 3 * tc;
  const float* a = blk + 3 * w + slot;
  const float* b = a + tc;
  u = __fmaf_rn(t, dot_rc(a, w, r.d), dot_rc(a, w, r.o) + a[3 * w]);
  v = __fmaf_rn(t, dot_rc(b, w, r.d), dot_rc(b, w, r.o) + b[3 * w]);
}

// The leaf routine of cluster tables: the hit counts only if the block's
// smallest valid t is below the current t (applied to the reduced result,
// pallas_traverse.py:518-522). Records the winner as cidx * tc + slot, the
// JAX kernel's cluster-local prim id.
template <bool kAnyHit>
struct ClusterLeaf {
  const float* cl;
  int tc;
  int win = -1;

  __device__ __forceinline__ ClusterLeaf(const float* c, int n) : cl(c), tc(n) {}

  __device__ __forceinline__ const float* block(int cidx) const {
    return cl + (size_t)cidx * 8 * 3 * tc;
  }

  __device__ __forceinline__ bool operator()(int packed, const Ray& r,
                                             float& t) {
    int cidx = packed >> 4, slot;
    float tmin = cluster_min(block(cidx), tc, r, kAnyHit, t, slot);
    if (tmin < t) {
      t = tmin;
      win = cidx * tc + slot;
      return true;
    }
    return false;
  }
};

// Walks the tree from the root: closest hit within (0, t) in near-first
// order, or (kAnyHit) until the first leaf that reports a hit. On a miss t
// and the leaf's records keep the values they came in with.
template <bool kAnyHit, class Leaf>
__device__ __forceinline__ void walk(const float* __restrict__ rows,
                                     const Ray& r, int depth, float& t,
                                     Leaf& leaf) {
  int stack[kMaxStack];
  int sp = 1;
  stack[0] = 0;  // root node row
  while (sp > 0) {
    int entry = stack[--sp];
    if (entry >= 0) {
      expand_node(rows + (size_t)entry * kRow, r, t, !kAnyHit, stack, sp,
                  depth);
    } else if (leaf(-(entry + 1), r, t) && kAnyHit) {
      return;
    }
  }
}

}  // namespace bvh
