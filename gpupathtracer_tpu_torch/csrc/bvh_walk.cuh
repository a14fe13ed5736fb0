// The wide-BVH walk of one ray by one thread, shared by csrc/traverse.cu
// (closest-hit and any-hit queries on MT-leaf tables) and csrc/megakernel.cu
// (the walks inside the whole-path estimator on MT leaves). One node phase,
// `walk`, is generic over its leaf routine (MtLeaf); `walk_ilv` and
// `walk_multi` are two more schedules of it. csrc/cluster_warp.cuh (the
// same queries on dense cluster-leaf tables, each cluster run by a warp:
// csrc/cluster_traverse.cu and the megakernel's cluster walks) takes the
// node expansion and the cluster dot products from here,
// csrc/subpacket_traverse.cu (one stack per 128 rays) the slab test and
// the leaf test, and csrc/dense_intersect.cu the dot products.
//
// The MT-leaf table is the merged 128-float row table of bvh/wide.py
// pack_for_packets, its nodes A = kArity wide (GPT_ARITY, 2 to 16; 8 unless
// the build defines it, ops/cuda_build.py builds one library per arity):
//   node row : cols 0:6A   = A children x (min.xyz, max.xyz)
//              cols 6A:7A  = A child entries (int32 bit-cast)
//   leaf rows: 10 slots of 12 floats (p0, e1, e2, prim id bit-cast, material
//              id bit-cast, normal sign); a leaf spans ceil(leaf_size / 10)
//              consecutive rows.
// Entries: INVALID (0x7FFFFFFF) = empty slot, e >= 0 = node row e,
// e < 0 = leaf, packed = -(e + 1): first row = packed >> 4, count = packed & 15.
// On a cluster scene (bvh/cluster.py pack_clusters) the rows hold the cluster
// top tree's nodes alone, and a leaf's packed >> 4 is a cluster index into
// the [Ncl * 8, 3 * tc] cluster table (see cluster_uv).
//
// A node pop reads its row's 28A used bytes (224 at A = 8) as ceil(7A / 4)
// 16-byte loads through the read-only path, all issued before the first
// slab test, and orders the entered children in registers with a fixed
// compare-exchange network (no array is indexed at run time); a leaf slot
// is three 16-byte loads. Rows are 512 bytes and slots 48, so every load is aligned when the
// table is (the wrappers check it). The walk's stack is the caller's: a
// pointer and a stride, so that B1 keeps it in shared memory. A walk
// starts at the entry its caller gives (row 0, the whole tree's root, or
// a subtree root or leaf of the treelet cut: the TPU kernels' per-packet
// root_ref); kInvalid starts no walk.
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

#ifndef GPT_ARITY
#define GPT_ARITY 8
#endif

#include "sort_net.cuh"

namespace bvh {

constexpr int kRow = 128;
constexpr int kArity = GPT_ARITY;
static_assert(kArity >= 2 && kArity <= 16,
              "a node row holds 2 to 16 children (7 * 16 <= 128 floats)");
constexpr int kTrisPerRow = kRow / 12;  // 10
constexpr int kMaxStack = 192;          // cfg.stack_depth * 4
constexpr int kInvalid = 0x7FFFFFFF;
constexpr float kSkipMargin = 1.0f / 4096.0f;  // pop_skip (next_cluster)

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

// 16 bytes of a table: through the read-only data path from global memory
// (kLdg), or a plain load of a row staged in shared memory.
template <bool kLdg = true>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (kLdg) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    return *reinterpret_cast<const float4*>(p);
  }
}

// The slab test of one child's box b = (min.xyz, max.xyz): true iff the
// ray's interval through it is not empty and ends ahead of the origin and
// its entry distance tmin is below t (the TPU kernel's slab body).
__device__ __forceinline__ bool slab_test(const float* b, const Ray& r,
                                          float t, float& tmin) {
  float tmax = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t0 = __fmaf_rn(b[a], r.inv[a], -r.oi[a]);
    float t1 = __fmaf_rn(b[3 + a], r.inv[a], -r.oi[a]);
    float lo = nan_min(t0, t1);
    float hi = nan_max(t0, t1);
    tmin = a == 0 ? lo : nan_max(tmin, lo);
    tmax = a == 0 ? hi : nan_min(tmax, hi);
  }
  return tmin <= tmax && tmax > 0.0f && tmin < t;
}

// slab_test of child j of a node row read in place (the sub-packet kernel
// reads a row staged in shared memory; the roofline probe csrc/roofline.cu
// calls slab_test on boxes it loads as 16-byte words).
__device__ __forceinline__ bool slab(const float* __restrict__ row, int j,
                                     const Ray& r, float t, float& tmin) {
  return slab_test(row + j * 6, r, t, tmin);
}

// Slab test of child j of one node row: true iff the ray enters the child's
// box before t and the slot is used; tmin is its entry distance.
__device__ __forceinline__ bool child_hit(const float* __restrict__ row, int j,
                                          const Ray& r, float t, float& tmin) {
  bool hit = slab(row, j, r, t, tmin);
  int entry = __float_as_int(row[6 * kArity + j]);
  return hit && entry != kInvalid;
}

// The pop_skip key of a child with box b, entered at tmin: tmin less
// kSkipMargin (|tmin| + |o_a inv_a|), a the axis whose slab entry is tmin.
// The entry fma(bound, inv, -o inv) exceeds the exact (bound - o) / d by at
// most about 2^-24 (2 |tmin| + |o_a inv_a|): absolute, not relative to t,
// for rays that start far from the world origin. The margin is 2^11 times
// that; the rest covers a triangle's t, which is computed otherwise than
// its box's entry and can round below it (ROADMAP.md section C).
__device__ __forceinline__ float skip_key(const float* b, const Ray& r,
                                          float tmin) {
  float scale = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo = nan_min(__fmaf_rn(b[a], r.inv[a], -r.oi[a]),
                       __fmaf_rn(b[3 + a], r.inv[a], -r.oi[a]));
    if (lo == tmin) scale = fmaxf(scale, fabsf(r.oi[a]));
  }
  return tmin - kSkipMargin * (fabsf(tmin) + scale);
}

// A node row's children in registers: A boxes and A entries, the row's
// 28A used bytes as kRowWords 16-byte loads, all in flight at once (the
// last word of an odd A reads up to 8 bytes past the entries, inside the
// 512-byte row).
constexpr int kRowWords = (7 * kArity + 3) / 4;  // 14 at A = 8

struct NodeRow {
  float b[6 * kArity];
  int e[kArity];
};

// Float k of 16-byte words v (k a constant once the loops unroll).
__device__ __forceinline__ float word_float(const float4 (&v)[kRowWords],
                                            int k) {
  const float4 w = v[k / 4];
  return k % 4 == 0 ? w.x : k % 4 == 1 ? w.y : k % 4 == 2 ? w.z : w.w;
}

__device__ __forceinline__ void load_node(const float* __restrict__ row,
                                          NodeRow& n) {
  float4 v[kRowWords];
#pragma unroll
  for (int q = 0; q < kRowWords; ++q) v[q] = load4(row + 4 * q);
#pragma unroll
  for (int k = 0; k < 6 * kArity; ++k) n.b[k] = word_float(v, k);
#pragma unroll
  for (int j = 0; j < kArity; ++j)
    n.e[j] = __float_as_int(word_float(v, 6 * kArity + j));
}

template <class T>
__device__ __forceinline__ void swap_if(bool s, T& a, T& b) {
  const T x = s ? b : a;
  b = s ? a : b;
  a = x;
}

// Sorts the A (key, slot) pairs ascending, lexicographically, carrying
// each child's entry (and, with kKeys, its pop_skip key) along. The slots
// are distinct, so the order is total and any sorting network gives the
// stable sort by key: the insertion order of the JAX kernel's port. The
// pairs (sort_net.cuh, one network per arity) are the compare-exchanges of
// the JAX kernel's _sort_net(A) (pallas_traverse.py:46-69), which compares
// keys alone there: the hand-kept 19 of _NET8 at A = 8.
template <bool kKeys>
__device__ __forceinline__ void sort_children(float (&key)[kArity],
                                              int (&slot)[kArity],
                                              int (&entry)[kArity],
                                              float* skey) {
  constexpr int kNet[GPT_CHILD_NET_SIZE][2] = GPT_CHILD_NET;
#pragma unroll
  for (int c = 0; c < GPT_CHILD_NET_SIZE; ++c) {
    const int a = kNet[c][0], b = kNet[c][1];
    const bool s =
        key[a] > key[b] || (key[a] == key[b] && slot[a] > slot[b]);
    swap_if(s, key[a], key[b]);
    swap_if(s, slot[a], slot[b]);
    swap_if(s, entry[a], entry[b]);
    if constexpr (kKeys) swap_if(s, skey[a], skey[b]);
  }
}

// The two entered children of a node (bits `hits`) to positions 0 and 1 in
// pop order: one compare, the pair picked by selects, where the network
// takes 19 at A = 8 (the cost B4, bound by instruction issue, feels: PERF.md). Equal
// keys keep slot order, as the network's (key, slot) order does.
template <bool kKeys>
__device__ __forceinline__ void order_two(unsigned hits, float (&key)[kArity],
                                          int (&entry)[kArity], float* skey) {
  const int j0 = __ffs(hits) - 1, j1 = __ffs(hits & (hits - 1u)) - 1;
  float k0 = key[0], k1 = key[0], s0 = skey[0], s1 = skey[0];
  int e0 = entry[0], e1 = entry[0];
#pragma unroll
  for (int j = 1; j < kArity; ++j) {
    if (j == j0) {
      k0 = key[j];
      e0 = entry[j];
      if constexpr (kKeys) s0 = skey[j];
    }
    if (j == j1) {
      k1 = key[j];
      e1 = entry[j];
      if constexpr (kKeys) s1 = skey[j];
    }
  }
  const bool s = k1 < k0;
  key[0] = s ? k1 : k0;
  key[1] = s ? k0 : k1;
  entry[0] = s ? e1 : e0;
  entry[1] = s ? e0 : e1;
  if constexpr (kKeys) {
    skey[0] = s ? s1 : s0;
    skey[1] = s ? s0 : s1;
  }
}

// Expands one node row: pushes the children the ray enters before t, so
// that they pop in ascending (t_near, slot) order when `ordered`, in slot
// order otherwise (one entered child needs no order, two one compare, more
// the network). Entry p of the stack is stack[p * stride]. Pushes past
// `depth` are dropped (the nearest first: it would sit on top); returns how
// many were. With kKeys each pushed child's skip_key goes to `keys` at its
// stack position (stride 1).
template <bool kKeys = false>
__device__ __forceinline__ int expand_node(const float* __restrict__ row,
                                           const Ray& r, float t,
                                           bool ordered, int* stack,
                                           int stride, int& sp, int depth,
                                           float* keys = nullptr) {
  NodeRow n;
  load_node(row, n);
  float key[kArity], skey[kKeys ? kArity : 1];
  int slot[kArity], entry[kArity];
  unsigned hits = 0;
#pragma unroll
  for (int j = 0; j < kArity; ++j) {
    float tmin = 0.0f;
    const bool hit = slab_test(n.b + 6 * j, r, t, tmin) && n.e[j] != kInvalid;
    hits |= (hit ? 1u : 0u) << j;
    // Misses key last: an entered child's tmin is below t, so below +inf.
    key[j] = hit ? tmin : __int_as_float(0x7f800000);
    slot[j] = j;
    entry[j] = n.e[j];
    if constexpr (kKeys) skey[j] = skip_key(n.b + 6 * j, r, tmin);
  }
  const int total = __popc(hits);
  if (ordered && total == 2) {
    order_two<kKeys>(hits, key, entry, skey);
  } else if (ordered && total > 2) {
    sort_children<kKeys>(key, slot, entry, skey);
  }
  if (ordered && total > 1) {
    // The k-th child in pop order sits k below the top.
#pragma unroll
    for (int k = 0; k < kArity; ++k) {
      const int pos = sp + total - 1 - k;
      if (k < total && pos < depth) {
        stack[pos * stride] = entry[k];
        if constexpr (kKeys) keys[pos] = skey[k];
      }
    }
  } else {
    // Slot order (also the order of one entered child, or none).
#pragma unroll
    for (int j = 0; j < kArity; ++j) {
      const int pos = sp + total - 1 - __popc(hits & ((1u << j) - 1u));
      if (((hits >> j) & 1u) && pos < depth) {
        stack[pos * stride] = entry[j];
        if constexpr (kKeys) keys[pos] = skey[j];
      }
    }
  }
  const int dropped = max(sp + total - depth, 0);
  sp = min(sp + total, depth);
  return dropped;
}

// Moller-Trumbore of one leaf slot, its 12 floats in s0, s1, s2 (p0, e1,
// e2, ...), in the operation order of pallas_traverse.py:265-280 and the
// roundings of ops/intersect.py mt_intersect: true iff the ray hits it at
// tt in (0, t), with its barycentrics uu, vv.
__device__ __forceinline__ bool mt_slot(const float4& s0, const float4& s1,
                                        const float4& s2, const Ray& r,
                                        float t, float& tt, float& uu,
                                        float& vv) {
  const float* d = r.d;
  float p0x = s0.x, p0y = s0.y, p0z = s0.z;
  float e1x = s0.w, e1y = s1.x, e1z = s1.y;
  float e2x = s1.z, e2y = s1.w, e2z = s2.x;
  float px = __fmaf_rn(d[1], e2z, -(d[2] * e2y));
  float py = __fmaf_rn(d[2], e2x, -(d[0] * e2z));
  float pz = __fmaf_rn(d[0], e2y, -(d[1] * e2x));
  float det = __fmaf_rn(e1z, pz, __fmaf_rn(e1y, py, e1x * px));
  float idet = 1.0f / det;
  float tx = r.o[0] - p0x;
  float ty = r.o[1] - p0y;
  float tz = r.o[2] - p0z;
  uu = __fmaf_rn(tz, pz, __fmaf_rn(tx, px, ty * py)) * idet;
  float qx = __fmaf_rn(ty, e1z, -(tz * e1y));
  float qy = __fmaf_rn(tz, e1x, -(tx * e1z));
  float qz = __fmaf_rn(tx, e1y, -(ty * e1x));
  vv = __fmaf_rn(d[2], qz, __fmaf_rn(d[0], qx, d[1] * qy)) * idet;
  tt = __fmaf_rn(e2z, qz, __fmaf_rn(e2x, qx, e2y * qy)) * idet;
  return uu > 0.0f && uu < 1.0f && vv > 0.0f && uu + vv < 1.0f &&
         tt > 0.0f && tt < t;
}

// Moller-Trumbore (mt_slot) against the `count` slots of one leaf block; a
// slot is three 16-byte loads (kLdg: from the table in global memory, else
// from a row staged in shared memory). A hit records t, prim, u, v and the
// slot it came from. With `any_hit`, returns at the first hit.
template <bool kLdg = true>
__device__ __forceinline__ void intersect_leaf(const float* __restrict__ block,
                                               int count, const Ray& r,
                                               bool any_hit, float& t,
                                               int& prim, float& u, float& v,
                                               const float*& slot) {
  for (int k = 0; k < count; ++k) {
    const float* s = block + (k / kTrisPerRow) * kRow + (k % kTrisPerRow) * 12;
    const float4 s0 = load4<kLdg>(s), s1 = load4<kLdg>(s + 4),
                 s2 = load4<kLdg>(s + 8);
    float tt, uu, vv;
    if (mt_slot(s0, s1, s2, r, t, tt, uu, vv)) {
      t = tt;
      prim = __float_as_int(s2.y);
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
  const float* rows = nullptr;
  int prim = -1;
  float u = 0.0f, v = 0.0f;
  const float* slot = nullptr;

  MtLeaf() = default;
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
// every comparison), each sum a dot_k3. A cluster pop's answer is the
// smallest valid t and the lowest slot that has it (pallas_traverse.py:507-538),
// +inf when none is valid; an any-hit pop's, whether some valid slot has t
// below t_cur. The walks run a block's slots across a warp
// (cluster_warp.cuh slot_t), the roofline probe four slots a thread
// (csrc/roofline.cu), with this arithmetic.

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

// Pop counters of one ray's walk (the kStats instantiations; the TPU
// kernels' with_stats counts the pops of a packet's shared stack, these
// count one ray's): node pops, leaf pops run (MT leaves or clusters) and,
// with kSkip, leaf pops skipped. The multi-pop schedule counts every node
// it pops (all are expanded, even those its stale t lets through) and
// every leaf it intersects.
struct Pops {
  int node = 0, leaf = 0, skip = 0;
};

// Walks the tree from entry `root` (0: the root node row; a node row or a
// leaf entry of the treelet cut; kInvalid: no walk, nothing is read):
// closest hit within (0, t) in near-first order, or (kAnyHit) until the
// first leaf that reports a hit. On a miss t and the leaf's records keep
// the values they came in with. kStats counts the pops into *pops. The
// stack is the caller's: entry p at stack[p * stride], `depth` entries.
template <bool kAnyHit, class Leaf, bool kStats = false>
__device__ __forceinline__ void walk(const float* __restrict__ rows,
                                     const Ray& r, int depth, float& t,
                                     Leaf& leaf, Pops* pops, int* stack,
                                     int stride, int root = 0) {
  int sp = root != kInvalid ? 1 : 0;
  stack[0] = root;
  while (sp > 0) {
    const int entry = stack[--sp * stride];
    if (entry >= 0) {
      if constexpr (kStats) ++pops->node;
      expand_node(rows + (size_t)entry * kRow, r, t, !kAnyHit, stack, stride,
                  sp, depth);
    } else {
      if constexpr (kStats) ++pops->leaf;
      if (leaf(-(entry + 1), r, t) && kAnyHit) return;
    }
  }
}

// Asks for the 128-byte lines of a popped entry's row to be brought near
// the SM before the walk reads them: the A children's bounds and entries
// of a node row (28A bytes), the used 48-byte slots of a leaf's first row.
__device__ __forceinline__ void prefetch_entry(const float* __restrict__ rows,
                                               int entry) {
  const char* p;
  int nbytes;
  if (entry >= 0) {
    p = (const char*)(rows + (size_t)entry * kRow);
    nbytes = 7 * kArity * 4;
  } else {
    int packed = -(entry + 1);
    p = (const char*)(rows + (size_t)(packed >> 4) * kRow);
    nbytes = min(packed & 15, kTrisPerRow) * 48;
  }
  for (int b = 0; b < nbytes; b += 128)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p + b));
}

// W walks in flight in one thread (the interleave schedule): every
// iteration pops one entry of each ray that still has one, asks for all
// their rows, then processes them in turn, so that the W dependent row
// reads overlap. Each ray's own visit order is `walk`'s, so its results are
// too, bit for bit. Slots with on[w] false, or whose start entry root[w]
// is kInvalid, never start.
template <int W, bool kAnyHit, class Leaf, bool kStats = false>
__device__ __forceinline__ void walk_ilv(const float* __restrict__ rows,
                                         const Ray (&r)[W], const bool (&on)[W],
                                         const int (&root)[W], int depth,
                                         float (&t)[W], Leaf (&leaf)[W],
                                         Pops* pops = nullptr) {
  int stack[W][kMaxStack];
  int sp[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    stack[w][0] = root[w];
    sp[w] = on[w] && root[w] != kInvalid ? 1 : 0;
  }
  for (;;) {
    int entry[W];
    bool any = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      entry[w] = kInvalid;
      if (sp[w] > 0) {
        entry[w] = stack[w][--sp[w]];
        prefetch_entry(rows, entry[w]);
        any = true;
      }
    }
    if (!any) return;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      int e = entry[w];
      if (e == kInvalid) continue;
      if (e >= 0) {
        if constexpr (kStats) ++pops[w].node;
        expand_node(rows + (size_t)e * kRow, r[w], t[w], !kAnyHit, stack[w],
                    1, sp[w], depth);
      } else {
        if constexpr (kStats) ++pops[w].leaf;
        if (leaf[w](-(e + 1), r[w], t[w]) && kAnyHit) sp[w] = 0;
      }
    }
  }
}

// Up to Q pops of the ray's stack per iteration (the multi-pop schedule):
// the popped node rows are all expanded against the t held when the
// iteration began, in pop order, then the popped leaves are intersected in
// pop order. The closest t is `walk`'s (stale-t pruning only enters more
// children); the visit order is not, so among triangles at bitwise-equal t
// another one may win. `depth` is the caller's stack bound times Q; the
// walk starts at `root` as `walk` does. Returns the number of pushes
// dropped at the top of the stack (the overflow latch: nonzero means hits
// may have been lost).
template <int Q, bool kAnyHit, class Leaf, bool kStats = false>
__device__ __forceinline__ int walk_multi(const float* __restrict__ rows,
                                          const Ray& r, int depth, float& t,
                                          Leaf& leaf, Pops* pops = nullptr,
                                          int root = 0) {
  int stack[kMaxStack];
  int sp = root != kInvalid ? 1 : 0, dropped = 0;
  stack[0] = root;
  while (sp > 0) {
    int entry[Q];
    int n = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (sp > 0) {
        entry[q] = stack[--sp];
        prefetch_entry(rows, entry[q]);
        n = q + 1;
      }
    }
    const float t_entry = t;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (q < n && entry[q] >= 0) {
        if constexpr (kStats) ++pops->node;
        dropped += expand_node(rows + (size_t)entry[q] * kRow, r, t_entry,
                               !kAnyHit, stack, 1, sp, depth);
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (q < n && entry[q] < 0) {
        if constexpr (kStats) ++pops->leaf;
        if (leaf(-(entry[q] + 1), r, t) && kAnyHit) return dropped;
      }
    }
  }
  return dropped;
}

}  // namespace bvh
