// Wide-BVH ray traversal on Hopper: one thread per ray, its own stack.
//
// Replaces the TPU's Pallas packet kernels
//   gpupathtracer_tpu/ops/pallas_traverse.py:72   _kernel       (closest / any-hit)
//   gpupathtracer_tpu/ops/pallas_traverse.py:1036 _kernel_pair  (two packets per
//                                                  step; same results as _kernel)
// over the same merged 128-float row table; the walk, its table layout and
// its rounding are in bvh_walk.cuh.
//
// The TPU kernels share one stack per 2048-ray packet because the TPU has a
// scalar unit beside a vector unit; here every thread walks alone, as the
// original GLSL traversal did. The results are bit-identical to the plain
// torch version (ops/kernel_traverse.py closest_plain / anyhit_plain).
//
// What bounds it on an H100: each pop is a dependent 512-byte row read
// (sponza's 25.5 MB table fits the 50 MB L2, so most are L2 hits) and the
// warp diverges as its 32 rays walk different paths. This first version
// does nothing about either (no packet sharing, no ray sorting, no
// persistent threads); the stack lives in local memory.

#include "bvh_walk.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
trace_closest_kernel(const float* __restrict__ rows,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max,
                     const uint8_t* __restrict__ active, int n, int depth,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_max[i];
  bvh::MtLeaf<false> leaf(rows);
  if (active[i]) bvh::walk<false>(rows, bvh::load_ray(o, d, i), depth, t, leaf);
  t_out[i] = t;
  prim_out[i] = leaf.prim;
  u_out[i] = leaf.u;
  v_out[i] = leaf.v;
}

__global__ void __launch_bounds__(kThreads)
trace_anyhit_kernel(const float* __restrict__ rows,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const uint8_t* __restrict__ active, int n, int depth,
                    uint8_t* __restrict__ occluded) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_max[i];
  bvh::MtLeaf<true> leaf(rows);
  if (active[i]) bvh::walk<true>(rows, bvh::load_ray(o, d, i), depth, t, leaf);
  occluded[i] = leaf.prim >= 0 ? 1 : 0;
}

}  // namespace

// Plain C interface for ctypes. Each returns cudaGetLastError() after its
// launch (0 = launched); the caller checks it. n must be > 0.
extern "C" {

int gpt_max_stack() { return bvh::kMaxStack; }

int gpt_trace_closest(const float* rows, const float* o, const float* d,
                      const float* t_max, const uint8_t* active, int n,
                      int depth, float* t, int* prim, float* u, float* v,
                      void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  trace_closest_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, t_max, active, n, depth, t, prim, u, v);
  return (int)cudaGetLastError();
}

int gpt_trace_anyhit(const float* rows, const float* o, const float* d,
                     const float* t_max, const uint8_t* active, int n,
                     int depth, uint8_t* occluded, void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  trace_anyhit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, t_max, active, n, depth, occluded);
  return (int)cudaGetLastError();
}

}  // extern "C"
