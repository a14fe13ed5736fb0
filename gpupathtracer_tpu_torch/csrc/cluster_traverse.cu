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
// loads a slot. So each cluster pop is run by the whole warp, 32 slots at
// once with coalesced loads (cluster_warp.cuh walk_warp, which the
// megakernel's cluster walks share), while each lane runs its own ray's
// node phase. Every lane stays in the loop until the whole warp is done:
// lanes past n and inactive rays take part in every ballot and shuffle.
//
// Both kernels take the table's arity at build time (bvh_walk.cuh kArity:
// one library per arity) and, optionally, a start entry per packet of
// `packet` consecutive rays (ray i from roots[i / packet]: a node row, a
// cluster leaf entry, or kInvalid for no walk), as the TPU kernel's
// root_ref; roots null starts every walk at row 0.
//
// Both kernels have kStats instantiations, launched when the caller passes
// a stats array: the TPU kernel's with_stats counters, per ray ([n, 3]: node
// pops, cluster pops run, cluster pops skipped). Closest hits also take
// pop_skip (kSkip: a parallel stack of each pushed entry's skip_key, and a
// cluster pop whose key is not below the ray's t is skipped). The TPU
// kernel keys on the packet's nearest entry and skips against its farthest
// ray's t; per ray the key and t are the ray's own. With kStats and kSkip
// false both compile away.

#include "cluster_warp.cuh"

namespace {

constexpr int kThreads = 128;

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

// Ray i's start entry: roots[i / packet], or row 0 without roots (and for
// lanes with no ray, which start no walk).
__device__ __forceinline__ int root_of(const int* __restrict__ roots,
                                       int packet, bool on, int i) {
  return roots && on ? roots[i / packet] : 0;
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
                             int* __restrict__ stats,
                             const int* __restrict__ roots, int packet) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const bool on = in && active[i];
  float t = in ? t_max[i] : 0.0f, u = 0.0f, v = 0.0f;
  const bvh::Ray r = bvh::load_ray(o, d, on ? i : 0);
  int win = -1;
  bvh::Pops pops;
  bvh::walk_warp<false, kStats, kSkip>(rows, cl, tc, r, on, depth, t, win,
                                       pops, root_of(roots, packet, on, i));
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
                            int* __restrict__ stats,
                            const int* __restrict__ roots, int packet) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const bool on = in && active[i];
  float t = in ? t_max[i] : 0.0f;
  const bvh::Ray r = bvh::load_ray(o, d, on ? i : 0);
  int win = -1;
  bvh::Pops pops;
  bvh::walk_warp<true, kStats, false>(rows, cl, tc, r, on, depth, t, win,
                                      pops, root_of(roots, packet, on, i));
  if (!in) return;
  occluded[i] = win >= 0 ? 1 : 0;
  store_pops<kStats>(stats, i, pops);
}

}  // namespace

// Plain C interface for ctypes. Each returns cudaGetLastError() after its
// launch (0 = launched); the caller checks it. n must be > 0. `stats` null
// launches the kernel without counters, else its kStats instantiation,
// which also writes the per-ray pop counts there. `roots` null walks every
// ray from row 0, else ray i from roots[i / packet] (packet > 0).
extern "C" {

int gpt_cluster_max_stack() { return bvh::kMaxStack; }

int gpt_cluster_arity() { return bvh::kArity; }

// pop_skip != 0 takes the skipping schedule.
int gpt_trace_cluster_closest(const float* rows, const float* cl,
                              const int* refs, int tc, const float* o,
                              const float* d, const float* t_max,
                              const uint8_t* active, int n, int depth,
                              float* t, int* prim, float* u, float* v,
                              int pop_skip, int* stats, const int* roots,
                              int packet, void* stream) {
  auto kernel =
      pop_skip ? (stats ? trace_cluster_closest_kernel<true, true>
                        : trace_cluster_closest_kernel<false, true>)
               : (stats ? trace_cluster_closest_kernel<true, false>
                        : trace_cluster_closest_kernel<false, false>);
  int blocks = (n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, cl, refs, tc, o, d, t_max, active, n, depth, t, prim, u, v, stats,
      roots, packet);
  return (int)cudaGetLastError();
}

int gpt_trace_cluster_anyhit(const float* rows, const float* cl, int tc,
                             const float* o, const float* d,
                             const float* t_max, const uint8_t* active, int n,
                             int depth, uint8_t* occluded, int* stats,
                             const int* roots, int packet, void* stream) {
  auto kernel = stats ? trace_cluster_anyhit_kernel<true>
                      : trace_cluster_anyhit_kernel<false>;
  int blocks = (n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, cl, tc, o, d, t_max, active, n, depth, occluded, stats, roots,
      packet);
  return (int)cudaGetLastError();
}

}  // extern "C"
