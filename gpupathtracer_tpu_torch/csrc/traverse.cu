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
// What bounds it on an H100: the main path traces chunks of 131,072 rays,
// about 31 warps an SM, so nothing hides the latency of each ray's chain of
// dependent pops (a 224-byte row read, mostly from L2: sponza's 25.5 MB
// table fits the 50 MB L2), and the slowest warps' chains set the time
// while their 32 rays diverge. The design cuts the chain's length in
// instructions and memory round trips: a node pop reads its row as
// fourteen 16-byte loads all in flight at once, orders the children in
// registers with a fixed network (bvh_walk.cuh expand_node: no array is
// indexed at run time, so none lives in local memory), and keeps the stack
// in shared memory, laid out [depth][blockDim] (entry p of thread x at
// p * blockDim + x, so a warp's accesses never conflict on a bank at any
// p): depth * blockDim * 4 bytes a block, 15 KB at sponza's stack bound of
// 58 and the wrapper's 64 threads, 48 KB at the largest bound, 192 (then
// four blocks fit an SM, and 131,072 rays take four waves). The block size
// is the caller's (64, 128 or 256 threads).
//
// Two more schedules of the same walk, each with B1's results:
//   gpupathtracer_tpu/ops/pallas_traverse.py:809 _kernel_ilv   (interleave = W)
//   gpupathtracer_tpu/ops/pallas_traverse.py:584 _kernel_multi (multi_pop = Q)
// The TPU kernels keep W packets, or Q pops of one packet's stack, in
// flight per loop iteration to hide the pop -> fetch -> push chain. A thread
// has the same chain (a pop is a dependent row read, mostly from L2), so
// here a thread carries W rays, each with its own stack (bvh::walk_ilv), or
// pops up to Q entries of its ray's stack at once (bvh::walk_multi), and
// asks for all their rows before it works on the first. What bounds them is
// what bounds B1, with their stacks in local memory, plus the registers of
// W rays (interleave) or the extra children that pruning against a stale t
// lets in (multi-pop). For the multi-pop schedule, the rows of its pops
// held in registers (56 a row), its stack in shared memory (whole or its
// first 16-64 entries) and other block sizes and register caps were each
// slower on the main path's rays (tools/torch_walk_variants.py --groups
// multi, PERF.md section 6): the prefetch hints keep the Q rows in flight
// without the registers that would cut the warps hiding the same latency.
//
// Every kernel takes the table's arity at build time (bvh_walk.cuh kArity,
// GPT_ARITY: one library per arity) and, optionally, a start entry per
// packet of `packet` consecutive rays: ray i walks from roots[i / packet]
// (the TPU kernels' root_ref, which the treelet traversal fills with the
// subtree roots of its bins; a leaf entry starts at that leaf, kInvalid
// starts no walk and the ray misses). roots null starts every walk at row
// 0: one predicated load a ray, no template axis.
//
// Every kernel has a kStats instantiation, launched when the caller passes
// a stats array: the pop counters of the TPU kernels' with_stats, per ray,
// [n, 2] node and leaf pops, [n, 3] for the multi-pop schedule, whose third
// column is the ray's pushes dropped at the top of its stack (the TPU
// kernel's overflow lane). With kStats false the counters compile away.

#include "bvh_walk.cuh"

namespace {

constexpr int kThreads = 128;     // the interleave and multi-pop kernels
constexpr int kMaxThreads = 256;  // B1's largest block
// Four of B1's largest blocks an SM: ptxas may take 64 registers a thread
// (1,024 threads an SM, the main path's 131,072 rays in one wave if the
// shared stacks fit too). Unbounded it takes 60 (48 any-hit) and ran 1-5%
// slower on sponza (tools/torch_walk_variants.py, PERF.md).
constexpr int kMinBlocks = 4;

// Ray i's pop counts to stats[cols * i ...] (kStats): node, leaf and, with
// three columns, the pushes dropped at the top of its stack.
template <bool kStats>
__device__ __forceinline__ void store_pops(int* __restrict__ stats, int cols,
                                           int i, const bvh::Pops& pops,
                                           int dropped = 0) {
  if constexpr (kStats) {
    stats[cols * i] = pops.node;
    stats[cols * i + 1] = pops.leaf;
    if (cols == 3) stats[cols * i + 2] = dropped;
  }
}

// Ray i's start entry: roots[i / packet], or row 0 without roots.
__device__ __forceinline__ int root_of(const int* __restrict__ roots,
                                       int packet, int i) {
  return roots ? roots[i / packet] : 0;
}

// B1's kernels: the walk's stack in dynamic shared memory, [depth][blockDim].
template <bool kStats>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
trace_closest_kernel(const float* __restrict__ rows,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max,
                     const uint8_t* __restrict__ active, int n, int depth,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     int* __restrict__ stats, const int* __restrict__ roots,
                     int packet) {
  extern __shared__ int stack[];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_max[i];
  bvh::MtLeaf<false> leaf(rows);
  bvh::Pops pops;
  if (active[i])
    bvh::walk<false, bvh::MtLeaf<false>, kStats>(
        rows, bvh::load_ray(o, d, i), depth, t, leaf, &pops,
        stack + threadIdx.x, blockDim.x, root_of(roots, packet, i));
  t_out[i] = t;
  prim_out[i] = leaf.prim;
  u_out[i] = leaf.u;
  v_out[i] = leaf.v;
  store_pops<kStats>(stats, 2, i, pops);
}

template <bool kStats>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
trace_anyhit_kernel(const float* __restrict__ rows,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const uint8_t* __restrict__ active, int n, int depth,
                    uint8_t* __restrict__ occluded, int* __restrict__ stats,
                    const int* __restrict__ roots, int packet) {
  extern __shared__ int stack[];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_max[i];
  bvh::MtLeaf<true> leaf(rows);
  bvh::Pops pops;
  if (active[i])
    bvh::walk<true, bvh::MtLeaf<true>, kStats>(
        rows, bvh::load_ray(o, d, i), depth, t, leaf, &pops,
        stack + threadIdx.x, blockDim.x, root_of(roots, packet, i));
  occluded[i] = leaf.prim >= 0 ? 1 : 0;
  store_pops<kStats>(stats, 2, i, pops);
}

// Thread j of T = ceil(n / W) carries rays j, T + j, ..., (W - 1) T + j, so
// that neighbouring threads read neighbouring rays in every slot.
template <int W, bool kAnyHit, bool kStats>
__device__ __forceinline__ void ilv_body(
    const float* __restrict__ rows, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_max,
    const uint8_t* __restrict__ active, int n, int depth,
    const int* __restrict__ roots, int packet, int (&ray)[W], float (&t)[W],
    bvh::MtLeaf<kAnyHit> (&leaf)[W], bvh::Pops (&pops)[W]) {
  int threads = (n + W - 1) / W;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  bvh::Ray r[W];
  bool on[W];
  int root[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    int i = w * threads + j;
    bool in = j < threads && i < n;
    ray[w] = in ? i : -1;
    on[w] = in && active[i];
    i = in ? i : 0;
    root[w] = on[w] ? root_of(roots, packet, i) : 0;
    t[w] = t_max[i];
    r[w] = bvh::load_ray(o, d, i);
    leaf[w].rows = rows;
  }
  bvh::walk_ilv<W, kAnyHit, bvh::MtLeaf<kAnyHit>, kStats>(rows, r, on, root,
                                                          depth, t, leaf,
                                                          pops);
}

template <int W, bool kStats>
__global__ void __launch_bounds__(kThreads)
trace_closest_ilv_kernel(const float* __restrict__ rows,
                         const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ t_max,
                         const uint8_t* __restrict__ active, int n, int depth,
                         float* __restrict__ t_out, int* __restrict__ prim_out,
                         float* __restrict__ u_out, float* __restrict__ v_out,
                         int* __restrict__ stats,
                         const int* __restrict__ roots, int packet) {
  int ray[W];
  float t[W];
  bvh::MtLeaf<false> leaf[W];
  bvh::Pops pops[W];
  ilv_body<W, false, kStats>(rows, o, d, t_max, active, n, depth, roots,
                             packet, ray, t, leaf, pops);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (ray[w] < 0) continue;
    t_out[ray[w]] = t[w];
    prim_out[ray[w]] = leaf[w].prim;
    u_out[ray[w]] = leaf[w].u;
    v_out[ray[w]] = leaf[w].v;
    store_pops<kStats>(stats, 2, ray[w], pops[w]);
  }
}

template <int W, bool kStats>
__global__ void __launch_bounds__(kThreads)
trace_anyhit_ilv_kernel(const float* __restrict__ rows,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ t_max,
                        const uint8_t* __restrict__ active, int n, int depth,
                        uint8_t* __restrict__ occluded,
                        int* __restrict__ stats,
                        const int* __restrict__ roots, int packet) {
  int ray[W];
  float t[W];
  bvh::MtLeaf<true> leaf[W];
  bvh::Pops pops[W];
  ilv_body<W, true, kStats>(rows, o, d, t_max, active, n, depth, roots,
                            packet, ray, t, leaf, pops);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (ray[w] < 0) continue;
    occluded[ray[w]] = leaf[w].prim >= 0 ? 1 : 0;
    store_pops<kStats>(stats, 2, ray[w], pops[w]);
  }
}

// `depth` is the stack bound times Q.
template <int Q, bool kStats>
__global__ void __launch_bounds__(kThreads)
trace_closest_multi_kernel(const float* __restrict__ rows,
                           const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ t_max,
                           const uint8_t* __restrict__ active, int n, int depth,
                           float* __restrict__ t_out,
                           int* __restrict__ prim_out,
                           float* __restrict__ u_out, float* __restrict__ v_out,
                           int* __restrict__ stats,
                           const int* __restrict__ roots, int packet) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_max[i];
  bvh::MtLeaf<false> leaf(rows);
  bvh::Pops pops;
  int dropped = 0;
  if (active[i])
    dropped = bvh::walk_multi<Q, false, bvh::MtLeaf<false>, kStats>(
        rows, bvh::load_ray(o, d, i), depth, t, leaf, &pops,
        root_of(roots, packet, i));
  t_out[i] = t;
  prim_out[i] = leaf.prim;
  u_out[i] = leaf.u;
  v_out[i] = leaf.v;
  store_pops<kStats>(stats, 3, i, pops, dropped);
}

template <int Q, bool kStats>
__global__ void __launch_bounds__(kThreads)
trace_anyhit_multi_kernel(const float* __restrict__ rows,
                          const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ t_max,
                          const uint8_t* __restrict__ active, int n, int depth,
                          uint8_t* __restrict__ occluded,
                          int* __restrict__ stats,
                          const int* __restrict__ roots, int packet) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_max[i];
  bvh::MtLeaf<true> leaf(rows);
  bvh::Pops pops;
  int dropped = 0;
  if (active[i])
    dropped = bvh::walk_multi<Q, true, bvh::MtLeaf<true>, kStats>(
        rows, bvh::load_ray(o, d, i), depth, t, leaf, &pops,
        root_of(roots, packet, i));
  occluded[i] = leaf.prim >= 0 ? 1 : 0;
  store_pops<kStats>(stats, 3, i, pops, dropped);
}

constexpr int kBadVariant = -1;  // a W, Q or block size with no kernel

int blocks_for(int threads) { return (threads + kThreads - 1) / kThreads; }

// Launches one of B1's kernels with `threads` a block and its shared stack,
// raising the kernel's dynamic shared memory limit above the default 48 KB
// where the stack needs it (192 entries x 256 threads: 192 KB).
template <class... Params, class... Args>
int launch_b1(void (*kernel)(Params...), int n, int depth, int threads,
              cudaStream_t stream, Args... args) {
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return kBadVariant;
  const size_t smem = (size_t)depth * threads * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(n + threads - 1) / threads, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Each returns cudaGetLastError() after its
// launch (0 = launched); the caller checks it. n must be > 0. `stats` null
// launches the kernel without counters, else its kStats instantiation,
// which also writes the per-ray pop counts there. `roots` null walks every
// ray from row 0, else ray i from roots[i / packet] (packet > 0).
extern "C" {

int gpt_max_stack() { return bvh::kMaxStack; }

int gpt_arity() { return bvh::kArity; }

// B1, `threads` a block (a multiple of 32 up to 256; -1 otherwise).
int gpt_trace_closest(const float* rows, const float* o, const float* d,
                      const float* t_max, const uint8_t* active, int n,
                      int depth, int threads, float* t, int* prim, float* u,
                      float* v, int* stats, const int* roots, int packet,
                      void* stream) {
  auto kernel =
      stats ? trace_closest_kernel<true> : trace_closest_kernel<false>;
  return launch_b1(kernel, n, depth, threads, (cudaStream_t)stream, rows, o,
                   d, t_max, active, n, depth, t, prim, u, v, stats, roots,
                   packet);
}

int gpt_trace_anyhit(const float* rows, const float* o, const float* d,
                     const float* t_max, const uint8_t* active, int n,
                     int depth, int threads, uint8_t* occluded, int* stats,
                     const int* roots, int packet, void* stream) {
  auto kernel =
      stats ? trace_anyhit_kernel<true> : trace_anyhit_kernel<false>;
  return launch_b1(kernel, n, depth, threads, (cudaStream_t)stream, rows, o,
                   d, t_max, active, n, depth, occluded, stats, roots,
                   packet);
}

// The interleave schedule, w = 2 or 4 rays per thread (-1 for any other w).
int gpt_trace_closest_ilv(const float* rows, const float* o, const float* d,
                          const float* t_max, const uint8_t* active, int n,
                          int depth, int w, float* t, int* prim, float* u,
                          float* v, int* stats, const int* roots, int packet,
                          void* stream) {
  auto kernel =
      w == 2 ? (stats ? trace_closest_ilv_kernel<2, true>
                      : trace_closest_ilv_kernel<2, false>)
      : w == 4 ? (stats ? trace_closest_ilv_kernel<4, true>
                        : trace_closest_ilv_kernel<4, false>)
               : nullptr;
  if (!kernel) return kBadVariant;
  kernel<<<blocks_for((n + w - 1) / w), kThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, t_max, active, n, depth, t, prim, u, v, stats, roots,
      packet);
  return (int)cudaGetLastError();
}

int gpt_trace_anyhit_ilv(const float* rows, const float* o, const float* d,
                         const float* t_max, const uint8_t* active, int n,
                         int depth, int w, uint8_t* occluded, int* stats,
                         const int* roots, int packet, void* stream) {
  auto kernel =
      w == 2 ? (stats ? trace_anyhit_ilv_kernel<2, true>
                      : trace_anyhit_ilv_kernel<2, false>)
      : w == 4 ? (stats ? trace_anyhit_ilv_kernel<4, true>
                        : trace_anyhit_ilv_kernel<4, false>)
               : nullptr;
  if (!kernel) return kBadVariant;
  kernel<<<blocks_for((n + w - 1) / w), kThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, t_max, active, n, depth, occluded, stats, roots, packet);
  return (int)cudaGetLastError();
}

// The multi-pop schedule, q = 2 or 4 pops per iteration (-1 for any other
// q); depth = stack bound * q <= gpt_max_stack(); stats [n, 3].
int gpt_trace_closest_multi(const float* rows, const float* o, const float* d,
                            const float* t_max, const uint8_t* active, int n,
                            int depth, int q, float* t, int* prim, float* u,
                            float* v, int* stats, const int* roots,
                            int packet, void* stream) {
  auto kernel =
      q == 2 ? (stats ? trace_closest_multi_kernel<2, true>
                      : trace_closest_multi_kernel<2, false>)
      : q == 4 ? (stats ? trace_closest_multi_kernel<4, true>
                        : trace_closest_multi_kernel<4, false>)
               : nullptr;
  if (!kernel) return kBadVariant;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, t_max, active, n, depth, t, prim, u, v, stats, roots,
      packet);
  return (int)cudaGetLastError();
}

int gpt_trace_anyhit_multi(const float* rows, const float* o, const float* d,
                           const float* t_max, const uint8_t* active, int n,
                           int depth, int q, uint8_t* occluded, int* stats,
                           const int* roots, int packet, void* stream) {
  auto kernel =
      q == 2 ? (stats ? trace_anyhit_multi_kernel<2, true>
                      : trace_anyhit_multi_kernel<2, false>)
      : q == 4 ? (stats ? trace_anyhit_multi_kernel<4, true>
                        : trace_anyhit_multi_kernel<4, false>)
               : nullptr;
  if (!kernel) return kBadVariant;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, t_max, active, n, depth, occluded, stats, roots, packet);
  return (int)cudaGetLastError();
}

}  // extern "C"
