// Wide-BVH traversal with dense cluster leaves on Hopper: one thread per
// ray for the node phase, the whole warp for each cluster leaf.
//
// Replaces the TPU's Pallas kernel
//   gpupathtracer_tpu/ops/pallas_traverse.py:307 _kernel_cluster
// (plumbing :1490-1576) over the same tables: the cluster top tree's node
// rows and the [Ncl * 8, 3 * tc] inverse-matrix blocks of bvh/cluster.py.
// A cluster leaf pop intersects all tc triangles of its block and keeps
// the smallest valid t, the lowest slot among equal t. The closest hit's
// u, v are recomputed from the winner's A/B rows, and its prim is remapped
// here through cluster_refs to the global triangle id (the JAX package
// does that gather after its kernel, ops/traverse.py remap_cluster_prims).
// Any-hit ends the ray at its first cluster hit. The results are
// bit-identical to the plain torch version (ops/kernel_cluster.py
// closest_cluster_plain / anyhit_cluster_plain).
//
// The TPU kernel intersects a whole 2048-ray packet with a cluster as two
// small matmuls on its matrix unit. What bounds it here, by count, is the
// per-slot FP32 work of each cluster pop (the bound chip_smoke.py
// computes): about 40 operations, one an IEEE division, and 21 four-byte
// loads a slot. Run by one thread, a pop's 128 slots are a serial loop
// whose loads no other lane shares, while the warp's other lanes wait in
// their node phase or their own leaves. So the walk is a warp loop in the
// pattern of Aila and Laine's "while-while" traversal (HPG 2009): each lane
// runs node pops (bvh_walk.cuh expand_node: its own stack, near-first
// order, t, pop counts and pop_skip keys, as `walk`) until its next pop is
// a cluster it must run or its stack is empty; a ballot gathers the
// pending clusters, and the warp runs them one at a time, lane L taking
// slots L, L + 32, ... with cluster_min's per-slot arithmetic, so every
// load of a block row is coalesced across the warp. A warp reduction gives
// the owner its result. Every lane stays in the loop until the whole warp
// is done: lanes past n and inactive rays take part in every ballot and
// shuffle. bvh::cluster_min and ClusterLeaf, which the megakernel and the
// roofline probe use, are not used here.
//
// Both kernels have kStats instantiations, launched when the caller passes
// a stats array: the TPU kernel's with_stats counters, per ray ([n, 3]: node
// pops, cluster pops run, cluster pops skipped). Closest hits also take
// pop_skip (kSkip: a parallel stack of each pushed entry's skip_key, and a
// cluster pop whose key is not below the ray's t is skipped). The TPU
// kernel keys on the packet's nearest entry and skips against its farthest
// ray's t; per ray the key and t are the ray's own. With kStats and kSkip
// false both compile away.

#include "bvh_walk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Ray i's pop counts to stats[3 * i ...] (kStats).
template <bool kStats>
__device__ __forceinline__ void store_pops(int* __restrict__ stats, int i,
                                           const bvh::Pops& pops) {
  if constexpr (kStats) {
    stats[3 * i] = pops.node;
    stats[3 * i + 1] = pops.leaf;
    stats[3 * i + 2] = pops.skip;
  }
}

// Slot j of a block [8, 3 * tc] against ray o, d: bvh::cluster_min's
// per-slot arithmetic, term for term. Returns t; `valid` says whether the
// hit lies inside the triangle and ahead of the origin.
__device__ __forceinline__ float slot_t(const float* __restrict__ blk, int tc,
                                        int j, const float (&o)[3],
                                        const float (&d)[3], bool& valid) {
  const int w = 3 * tc;
  const float* wo = blk + 3 * w;
  float da = bvh::dot_k3(blk + j, w, d);
  float db = bvh::dot_k3(blk + tc + j, w, d);
  float dc = bvh::dot_k3(blk + 2 * tc + j, w, d);
  float oa = bvh::dot_k3(wo + j, w, o) + wo[3 * w + j];
  float ob = bvh::dot_k3(wo + tc + j, w, o) + wo[3 * w + tc + j];
  float num = bvh::dot_k3(wo + 2 * tc + j, w, o) + wo[3 * w + 2 * tc + j];
  float tt = num / dc;
  float uu = __fmaf_rn(tt, da, oa);
  float vv = __fmaf_rn(tt, db, ob);
  valid = uu > 0.0f && vv > 0.0f && uu + vv < 1.0f && tt > 0.0f;
  return tt;
}

// The origin and direction of lane src's ray, in every lane.
__device__ __forceinline__ void shfl_ray(const bvh::Ray& r, int src,
                                         float (&o)[3], float (&d)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = __shfl_sync(kFull, r.o[a], src);
    d[a] = __shfl_sync(kFull, r.d[a], src);
  }
}

// A cluster pop of one ray by the whole warp: the smallest valid t of the
// block and the lowest slot that has it (+inf when none is valid), in
// every lane; cluster_min's answer.
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
// slot is valid with t below t_cur, cluster_min's any-hit answer.
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
template <bool kAnyHit, bool kStats, bool kSkip>
__device__ __forceinline__ int next_cluster(const float* __restrict__ rows,
                                            const bvh::Ray& r, int depth,
                                            float t, int* stack, int& sp,
                                            float* keys, bvh::Pops& pops) {
  while (sp > 0) {
    int entry = stack[--sp];
    if (entry >= 0) {
      if constexpr (kStats) ++pops.node;
      bvh::expand_node<kSkip>(rows + (size_t)entry * bvh::kRow, r, t,
                              !kAnyHit, stack, sp, depth, keys);
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

// The warp loop of both kernels. Lane `on` rays walk from the root; on a
// closest hit t and win take the winner (cidx * tc + slot), on an any-hit
// win >= 0 and the ray ends.
template <bool kAnyHit, bool kStats, bool kSkip>
__device__ __forceinline__ void walk_warp(const float* __restrict__ rows,
                                          const float* __restrict__ cl,
                                          int tc, const bvh::Ray& r, bool on,
                                          int depth, float& t, int& win,
                                          bvh::Pops& pops) {
  static_assert(!(kSkip && kAnyHit), "pop_skip orders by t_near: closest only");
  const int lane = threadIdx.x % kWarp;
  int stack[bvh::kMaxStack];
  float keys[kSkip ? bvh::kMaxStack : 1];
  int sp = on ? 1 : 0;
  stack[0] = 0;  // root node row
  if constexpr (kSkip) keys[0] = -__int_as_float(0x7f800000);
  for (;;) {
    const int cidx =
        next_cluster<kAnyHit, kStats, kSkip>(rows, r, depth, t, stack, sp,
                                             keys, pops);
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
        if (lane == src && tmin < t) {  // ClusterLeaf's rule
          t = tmin;
          win = c * tc + slot;
        }
      }
    }
  }
}

// Every thread of a block runs the warp loop, in range or not: no lane
// leaves before its warp is done.
template <bool kStats, bool kSkip>
__global__ void __launch_bounds__(kThreads)
trace_cluster_closest_kernel(const float* __restrict__ rows,
                             const float* __restrict__ cl,
                             const int* __restrict__ refs, int tc,
                             const float* __restrict__ o,
                             const float* __restrict__ d,
                             const float* __restrict__ t_max,
                             const uint8_t* __restrict__ active, int n,
                             int depth, float* __restrict__ t_out,
                             int* __restrict__ prim_out,
                             float* __restrict__ u_out,
                             float* __restrict__ v_out,
                             int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const bool on = in && active[i];
  float t = in ? t_max[i] : 0.0f, u = 0.0f, v = 0.0f;
  const bvh::Ray r = bvh::load_ray(o, d, on ? i : 0);
  int win = -1;
  bvh::Pops pops;
  walk_warp<false, kStats, kSkip>(rows, cl, tc, r, on, depth, t, win, pops);
  if (!in) return;
  if (win >= 0)
    bvh::cluster_uv(cl + (size_t)(win / tc) * 8 * 3 * tc, tc, win % tc, r, t,
                    u, v);
  t_out[i] = t;
  prim_out[i] = win >= 0 ? refs[win] : -1;
  u_out[i] = u;
  v_out[i] = v;
  store_pops<kStats>(stats, i, pops);
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
trace_cluster_anyhit_kernel(const float* __restrict__ rows,
                            const float* __restrict__ cl, int tc,
                            const float* __restrict__ o,
                            const float* __restrict__ d,
                            const float* __restrict__ t_max,
                            const uint8_t* __restrict__ active, int n,
                            int depth, uint8_t* __restrict__ occluded,
                            int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const bool on = in && active[i];
  float t = in ? t_max[i] : 0.0f;
  const bvh::Ray r = bvh::load_ray(o, d, on ? i : 0);
  int win = -1;
  bvh::Pops pops;
  walk_warp<true, kStats, false>(rows, cl, tc, r, on, depth, t, win, pops);
  if (!in) return;
  occluded[i] = win >= 0 ? 1 : 0;
  store_pops<kStats>(stats, i, pops);
}

}  // namespace

// Plain C interface for ctypes. Each returns cudaGetLastError() after its
// launch (0 = launched); the caller checks it. n must be > 0. `stats` null
// launches the kernel without counters, else its kStats instantiation,
// which also writes the per-ray pop counts there.
extern "C" {

int gpt_cluster_max_stack() { return bvh::kMaxStack; }

// pop_skip != 0 takes the skipping schedule.
int gpt_trace_cluster_closest(const float* rows, const float* cl,
                              const int* refs, int tc, const float* o,
                              const float* d, const float* t_max,
                              const uint8_t* active, int n, int depth,
                              float* t, int* prim, float* u, float* v,
                              int pop_skip, int* stats, void* stream) {
  auto kernel =
      pop_skip ? (stats ? trace_cluster_closest_kernel<true, true>
                        : trace_cluster_closest_kernel<false, true>)
               : (stats ? trace_cluster_closest_kernel<true, false>
                        : trace_cluster_closest_kernel<false, false>);
  int blocks = (n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, cl, refs, tc, o, d, t_max, active, n, depth, t, prim, u, v, stats);
  return (int)cudaGetLastError();
}

int gpt_trace_cluster_anyhit(const float* rows, const float* cl, int tc,
                             const float* o, const float* d,
                             const float* t_max, const uint8_t* active, int n,
                             int depth, uint8_t* occluded, int* stats,
                             void* stream) {
  auto kernel = stats ? trace_cluster_anyhit_kernel<true>
                      : trace_cluster_anyhit_kernel<false>;
  int blocks = (n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, cl, tc, o, d, t_max, active, n, depth, occluded, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
