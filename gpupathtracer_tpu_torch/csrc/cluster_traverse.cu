// Wide-BVH traversal with dense cluster leaves on Hopper: one thread per
// ray, its own stack.
//
// Replaces the TPU's Pallas kernel
//   gpupathtracer_tpu/ops/pallas_traverse.py:307 _kernel_cluster
// (plumbing :1490-1576) over the same tables: the cluster top tree's node
// rows and the [Ncl * 8, 3 * tc] inverse-matrix blocks of bvh/cluster.py.
// The node phase is bvh_walk.cuh's, shared with csrc/traverse.cu and the
// megakernel; a cluster leaf pop intersects all tc triangles of its block
// (bvh_walk.cuh cluster_min) and keeps the smallest valid t, the lowest slot
// among equal t. The closest hit's u, v are recomputed from the winner's A/B
// rows, and its prim is remapped here through cluster_refs to the global
// triangle id (the JAX package does that gather after its kernel,
// ops/traverse.py remap_cluster_prims). Any-hit ends the ray at its first
// cluster hit. The results are bit-identical to the plain torch version
// (ops/kernel_cluster.py closest_cluster_plain / anyhit_cluster_plain).
//
// The TPU kernel intersects a whole 2048-ray packet with a cluster as two
// small matmuls on its matrix unit; here each thread loops over the block's
// tc slots, about 40 FP32 operations and 21 four-byte loads (84 bytes of
// block) per slot. What bounds it on an H100: by count, the per-slot FP32
// work of each cluster pop (the bound chip_smoke.py computes); it runs at
// about 1% of that bound, which points at the latency of those loads when a
// warp's rays sit in different clusters (every table of the bench's cluster
// scenes fits the 50 MB L2; no profiler reading confirms it yet).
// This first version reads the block from global memory in every thread;
// staging a block in shared memory per warp, spreading its slots over the
// warp's lanes, or the dot products on tensor cores, is later work.

#include "bvh_walk.cuh"

namespace {

constexpr int kThreads = 128;

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
                             float* __restrict__ v_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_max[i], u = 0.0f, v = 0.0f;
  bvh::ClusterLeaf<false> leaf(cl, tc);
  if (active[i]) {
    bvh::Ray r = bvh::load_ray(o, d, i);
    bvh::walk<false>(rows, r, depth, t, leaf);
    if (leaf.win >= 0)
      bvh::cluster_uv(leaf.block(leaf.win / tc), tc, leaf.win % tc, r, t, u,
                      v);
  }
  t_out[i] = t;
  prim_out[i] = leaf.win >= 0 ? refs[leaf.win] : -1;
  u_out[i] = u;
  v_out[i] = v;
}

__global__ void __launch_bounds__(kThreads)
trace_cluster_anyhit_kernel(const float* __restrict__ rows,
                            const float* __restrict__ cl, int tc,
                            const float* __restrict__ o,
                            const float* __restrict__ d,
                            const float* __restrict__ t_max,
                            const uint8_t* __restrict__ active, int n,
                            int depth, uint8_t* __restrict__ occluded) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_max[i];
  bvh::ClusterLeaf<true> leaf(cl, tc);
  if (active[i]) bvh::walk<true>(rows, bvh::load_ray(o, d, i), depth, t, leaf);
  occluded[i] = leaf.win >= 0 ? 1 : 0;
}

}  // namespace

// Plain C interface for ctypes. Each returns cudaGetLastError() after its
// launch (0 = launched); the caller checks it. n must be > 0.
extern "C" {

int gpt_cluster_max_stack() { return bvh::kMaxStack; }

int gpt_trace_cluster_closest(const float* rows, const float* cl,
                              const int* refs, int tc, const float* o,
                              const float* d, const float* t_max,
                              const uint8_t* active, int n, int depth,
                              float* t, int* prim, float* u, float* v,
                              void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  trace_cluster_closest_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, cl, refs, tc, o, d, t_max, active, n, depth, t, prim, u, v);
  return (int)cudaGetLastError();
}

int gpt_trace_cluster_anyhit(const float* rows, const float* cl, int tc,
                             const float* o, const float* d,
                             const float* t_max, const uint8_t* active, int n,
                             int depth, uint8_t* occluded, void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  trace_cluster_anyhit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, cl, tc, o, d, t_max, active, n, depth, occluded);
  return (int)cudaGetLastError();
}

}  // extern "C"
