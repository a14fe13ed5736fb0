// The walk of dense cluster-leaf tables with each cluster pop run by the
// whole warp, shared by csrc/cluster_traverse.cu (B4's closest-hit and
// any-hit queries) and csrc/megakernel.cu (the megakernel's cluster walks).
//
// A cluster pop intersects all tc triangles of its block and keeps the
// smallest valid t, the lowest slot among equal t (the answer that
// bvh_walk.cuh defines above cluster_uv). Run by one thread, a pop's 128 slots are a serial
// loop whose loads no other lane shares, while the warp's other lanes wait
// in their node phase or their own leaves. So the walk is a warp loop in
// the pattern of Aila and Laine's "while-while" traversal (HPG 2009): each
// lane runs node pops (bvh_walk.cuh expand_node: its own stack, near-first
// order, t, pop counts and pop_skip keys) until its next pop is a cluster
// it must run or its stack is empty; a ballot gathers the pending clusters,
// and the warp runs them one at a time, lane L taking slots L, L + 32, ...
// with the block's per-slot arithmetic (bvh_walk.cuh), so every load of a block row is
// coalesced across the warp. A warp reduction gives the owner its result.
//
// Every lane of the warp must call walk_warp together, and stay in it until
// the whole warp is done: lanes with no ray to trace (past n, inactive, or
// a megakernel lane whose path has ended) take part in every ballot and
// shuffle with `on` false.

#pragma once

#include "bvh_walk.cuh"

namespace bvh {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Slot j of a block [8, 3 * tc] against ray o, d: the block's per-slot
// arithmetic, term for term. Returns t; `valid` says whether the hit lies
// inside the triangle and ahead of the origin.
__device__ __forceinline__ float slot_t(const float* __restrict__ blk, int tc,
                                        int j, const float (&o)[3],
                                        const float (&d)[3], bool& valid) {
  const int w = 3 * tc;
  const float* wo = blk + 3 * w;
  float da = dot_k3(blk + j, w, d);
  float db = dot_k3(blk + tc + j, w, d);
  float dc = dot_k3(blk + 2 * tc + j, w, d);
  float oa = dot_k3(wo + j, w, o) + wo[3 * w + j];
  float ob = dot_k3(wo + tc + j, w, o) + wo[3 * w + tc + j];
  float num = dot_k3(wo + 2 * tc + j, w, o) + wo[3 * w + 2 * tc + j];
  float tt = num / dc;
  float uu = __fmaf_rn(tt, da, oa);
  float vv = __fmaf_rn(tt, db, ob);
  valid = uu > 0.0f && vv > 0.0f && uu + vv < 1.0f && tt > 0.0f;
  return tt;
}

// The origin and direction of lane src's ray, in every lane.
__device__ __forceinline__ void shfl_ray(const Ray& r, int src, float (&o)[3],
                                         float (&d)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = __shfl_sync(kFull, r.o[a], src);
    d[a] = __shfl_sync(kFull, r.d[a], src);
  }
}

// A cluster pop of one ray by the whole warp: the smallest valid t of the
// block and the lowest slot that has it (+inf when none is valid), in
// every lane; a cluster pop's answer.
__device__ __forceinline__ float warp_cluster_min(const float* __restrict__ blk,
                                                  int tc, const float (&o)[3],
                                                  const float (&d)[3],
                                                  int lane, int& slot) {
  float best = __int_as_float(0x7f800000);  // +inf
  slot = tc;
#pragma unroll 4
  for (int j = lane; j < tc; j += kWarp) {
    bool valid;
    float tt = slot_t(blk, tc, j, o, d, valid);
    if (valid && tt < best) {  // j ascends: the lane keeps its lowest slot
      best = tt;
      slot = j;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    float ot = __shfl_xor_sync(kFull, best, off);
    int os = __shfl_xor_sync(kFull, slot, off);
    if (ot < best || (ot == best && os < slot)) {
      best = ot;
      slot = os;
    }
  }
  return best;
}

// An any-hit cluster pop by the whole warp: true in every lane iff some
// slot is valid with t below t_cur, an any-hit pop's answer.
__device__ __forceinline__ bool warp_cluster_any(const float* __restrict__ blk,
                                                 int tc, const float (&o)[3],
                                                 const float (&d)[3],
                                                 float t_cur, int lane) {
  bool hit = false;
#pragma unroll 4
  for (int j = lane; j < tc; j += kWarp) {
    bool valid;
    float tt = slot_t(blk, tc, j, o, d, valid);
    hit |= valid && tt < t_cur;
  }
  return __any_sync(kFull, hit);
}

// One ray's walk, `walk`'s node phase, paused at each cluster pop: pops
// node rows (expanding them as `walk` does) until the next pop is a
// cluster to run, whose index it returns, or the stack is empty (-1).
// kSkip (closest walks, pop_skip of the TPU cluster kernel) keeps each
// pushed entry's skip_key on a parallel key stack and skips a cluster pop
// whose key is not below the current t: no triangle inside its box can be
// closer.
template <bool kAnyHit, bool kStats, bool kSkip>
__device__ __forceinline__ int next_cluster(const float* __restrict__ rows,
                                            const Ray& r, int depth, float t,
                                            int* stack, int& sp, float* keys,
                                            Pops& pops) {
  while (sp > 0) {
    int entry = stack[--sp];
    if (entry >= 0) {
      if constexpr (kStats) ++pops.node;
      expand_node<kSkip>(rows + (size_t)entry * kRow, r, t, !kAnyHit, stack,
                         1, sp, depth, keys);
    } else {
      if constexpr (kSkip) {
        if (keys[sp] >= t) {
          if constexpr (kStats) ++pops.skip;
          continue;
        }
      }
      if constexpr (kStats) ++pops.leaf;
      return (-(entry + 1)) >> 4;
    }
  }
  return -1;
}

// The warp loop of a cluster walk. Lanes with `on` walk from entry `root`
// (as bvh_walk.cuh `walk` does: kInvalid starts none, a leaf entry starts
// at its cluster); on a closest hit t and win take the winner (cidx * tc +
// slot, the JAX kernel's cluster-local prim id; the hit counts only if the
// block's smallest valid t is below the ray's t,
// pallas_traverse.py:518-522), on an any-hit win >= 0 and the ray ends.
template <bool kAnyHit, bool kStats, bool kSkip>
__device__ __forceinline__ void walk_warp(const float* __restrict__ rows,
                                          const float* __restrict__ cl,
                                          int tc, const Ray& r, bool on,
                                          int depth, float& t, int& win,
                                          Pops& pops, int root = 0) {
  static_assert(!(kSkip && kAnyHit), "pop_skip orders by t_near: closest only");
  const int lane = threadIdx.x % kWarp;
  int stack[kMaxStack];
  float keys[kSkip ? kMaxStack : 1];
  int sp = on && root != kInvalid ? 1 : 0;
  stack[0] = root;
  if constexpr (kSkip) keys[0] = -__int_as_float(0x7f800000);
  for (;;) {
    const int cidx = next_cluster<kAnyHit, kStats, kSkip>(rows, r, depth, t,
                                                          stack, sp, keys,
                                                          pops);
    unsigned pending = __ballot_sync(kFull, cidx >= 0);
    if (!pending) return;
    while (pending) {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const int c = __shfl_sync(kFull, cidx, src);
      const float* blk = cl + (size_t)c * 8 * 3 * tc;
      float o[3], d[3];
      shfl_ray(r, src, o, d);
      if constexpr (kAnyHit) {
        const float t_src = __shfl_sync(kFull, t, src);
        if (warp_cluster_any(blk, tc, o, d, t_src, lane) && lane == src) {
          win = c * tc;
          sp = 0;  // the first cluster hit ends the ray
        }
      } else {
        int slot;
        const float tmin = warp_cluster_min(blk, tc, o, d, lane, slot);
        if (lane == src && tmin < t) {
          t = tmin;
          win = c * tc + slot;
        }
      }
    }
  }
}

}  // namespace bvh
