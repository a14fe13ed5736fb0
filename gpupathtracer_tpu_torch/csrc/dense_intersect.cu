// Brute-force ray x triangle intersection on Hopper: every ray against every
// triangle by the inverse-matrix test, no tree.
//
// Replaces the TPU's Pallas kernel
//   gpupathtracer_tpu/ops/dense_intersect.py:105 _kernel
// over the same operands (ops/dense_intersect.py pack_dense_tris): wd
// [3, 3*Tp] and wo [4, 3*Tp], thirds A | B | C of each triangle's inverse
// matrix along the columns, the per-triangle constants folded into wo's
// fourth row. For a ray (o, d) and triangle j:
//   da, db, dc = A.d, B.d, C.d;  oa, ob, num = A.o + a3, B.o + b3, C'.o + c3
//   t = num / dc, u = oa + t * da, v = ob + t * db
//   valid iff u > 0, v > 0, u + v < 1, 0 < t < t_best (strict; a degenerate
//   or padding triangle is all zero: t = 0/0 = NaN fails every comparison).
// Closest hit: the smallest valid t, the lowest triangle index among equal
// t (the TPU kernel takes the first minimum inside a tile and needs a strict
// improvement across tiles, which is the same order). Any-hit: prim is the
// base index of the first `tile` (the argument) that holds a hit, t = 0,
// u = v = 0, as the TPU kernel reports it: the tile of the lowest triangle
// index that holds a hit.
//
// The TPU kernel runs a block of rays against a tile of triangles as two
// matrix products on the MXU (use_mxu) or as broadcast multiplies on the
// VPU. The H100's tensor cores have no full-FP32 mode, so both flags run
// FP32 FMAs on the CUDA cores; they are kept because they round
// differently, each as XLA rounds its form on the CPU (where the JAX
// package's tests run it): use_mxu as the K = 3 / K = 4 dot,
// fma(m2, x2, fma(m1, x1, m0 * x0)) + m3, and the multiply chain as
// fma(m2, x2, fma(m0, x0, m1 * x1)) + m3. Built with --fmad=false, so nvcc
// fuses nothing else.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W, measured with
// tools/torch_walk_variants.py --groups dense): instruction issue. The
// bound counts a pair as 40 operations at 67 TFLOP/s; compiled, a pair is
// about 41 FP32-pipe instructions (the six dots, the IEEE division's seven
// and its slow-path check, five compares) and a share of the record's
// shared loads, so even at the full issue rate it takes about twice the
// bound. The parent's design (a 1,024-ray block a thread a ray, 512-triangle
// tiles staged between two bare barriers, a block leaving only when all its
// rays were done) read 26% of the bound closest and 7.5% any-hit on 131,072
// bathroom rays, and 65.5 ms on 8,192 sponza rays (8 blocks for 132 SMs).
// This design:
// - closest: a block is 128 threads and 256 rays, two a thread, so each
//   staged triangle's six 16-byte shared loads (a broadcast) serve two
//   rays; any-hit: 128 rays, one a thread, since an any-hit warp lasts as
//   long as its slowest ray;
// - triangles are staged 128 at a time with cp.async into two buffers, the
//   next stage in flight while the current one is tested; thread j copies
//   triangle j's record;
// - with fewer ray blocks than two waves of the blocks the card holds at
//   once, the triangle range is split across blocks too (blockIdx.y), up to
//   two waves. Every block folds its rays' best into a 64-bit key a ray
//   with atomicMin: (t bits << 32 | index) for closest (valid t is
//   positive, so its bits order as the floats do; the lower index wins
//   among equal t), the lowest hit index for any-hit. A second kernel turns
//   the keys into t, prim, u, v, recomputing the winner's u, v with the
//   same arithmetic (so the same bits);
// - any-hit keeps each block's live rays in a list, compacted after every
//   stage in which one of them is done (early_exit), so warps run only
//   rays still looking, a warp leaves a stage once its rays are done, and a
//   block leaves when its list is empty. A ray whose key already holds a
//   lower index than the next stage (found by a block of an earlier range)
//   leaves the list too.
// Closest reads 27% of the bound, any-hit 11.5%, sponza 4.0 ms (PERF.md
// section 6).

#include "bvh_walk.cuh"

namespace {

constexpr int kRec = 24;     // floats per staged triangle: 7 rows x 3 thirds + 3
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Rays a thread and triangles unrolled: closest runs every ray over every
// triangle, so two rays share each staged record's loads; an any-hit warp
// lasts as long as its slowest ray, so one ray a thread, and it looks
// whether its rays are done every kUnroll triangles.
template <bool kAnyHit>
constexpr int kRays = kAnyHit ? 1 : 2;
template <bool kAnyHit>
constexpr int kUnroll = kAnyHit ? 4 : 2;
constexpr int kMaxBlockRays = 2 * kThreads;
constexpr int kStage = 128;  // triangles a stage
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most n of this thread's groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Starts the copy of triangles [base, base + kStage) into records of
// kRec floats: rec[k] = wd[k * tp + i] for k < 9 and rec[9 + k] =
// wo[k * tp + i] for k < 12 (k = row * 3 + third), triangle i. Thread j
// copies triangle j's record, so a warp's copies of one k are 128
// consecutive bytes.
__device__ __forceinline__ void stage(const float* __restrict__ wd,
                                      const float* __restrict__ wo, int tp,
                                      int base, float* smem) {
  for (int j = threadIdx.x; j < kStage; j += kThreads) {
    const float* a = wd + base + j;
    const float* b = wo + base + j;
    float* rec = smem + j * kRec;
#pragma unroll
    for (int k = 0; k < 9; ++k) cp_async4(rec + k, a + (size_t)k * tp);
#pragma unroll
    for (int k = 0; k < 12; ++k) cp_async4(rec + 9 + k, b + (size_t)k * tp);
  }
}

template <bool kMxu>
__device__ __forceinline__ float dot3(const float* m, const float* x) {
  return kMxu ? bvh::dot_k3(m, 3, x) : bvh::dot_rc(m, 3, x);
}

// The pair test of one record against one ray: t, and whether it is valid
// below t_lim; u, v as the TPU kernel's slot computes them.
template <bool kMxu>
__device__ __forceinline__ bool pair(const float* rec, const float* ro,
                                     const float* rd, float t_lim, float& tt,
                                     float& uu, float& vv) {
  const float da = dot3<kMxu>(rec + 0, rd);
  const float db = dot3<kMxu>(rec + 1, rd);
  const float dc = dot3<kMxu>(rec + 2, rd);
  const float oa = dot3<kMxu>(rec + 9, ro) + rec[18];
  const float ob = dot3<kMxu>(rec + 10, ro) + rec[19];
  const float num = dot3<kMxu>(rec + 11, ro) + rec[20];
  tt = num / dc;
  uu = __fmaf_rn(tt, da, oa);
  vv = __fmaf_rn(tt, db, ob);
  return uu > 0.0f && vv > 0.0f && uu + vv < 1.0f && tt > 0.0f && tt < t_lim;
}

// Whether any ray slot of any lane of the warp is live.
template <int R>
__device__ __forceinline__ bool any_live(const bool (&live)[R]) {
  bool a = false;
#pragma unroll
  for (int r = 0; r < R; ++r) a = a || live[r];
  return __any_sync(kFull, a);
}

// Rewrites list[] with the rays of the threads' slots whose keep is set;
// returns how many. Every thread of the block calls it.
template <int R>
__device__ __forceinline__ int compact(const int (&id)[R],
                                       const bool (&keep)[R], int* list,
                                       int* warp_sum) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int mine = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) mine += keep[r] ? 1 : 0;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();  // warp sums written; every thread has read list[]
  int pos = incl - mine, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_sum[w];
    pos += w < warp ? c : 0;
    total += c;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (keep[r]) list[pos++] = id[r];
  __syncthreads();  // list written; warp_sum read
  return total;
}

// One block: rays [blockIdx.x * kThreads * R, + kThreads * R) against the
// stages of part blockIdx.y of gridDim.y (R = kRays<kAnyHit>). Slot
// s = tid * R + r of the block's list is ray slot r of thread tid, so the
// live rays fill whole threads and warps, and a warp past the list's end
// skips the stage.
template <bool kAnyHit, bool kMxu>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const float* __restrict__ wd, const float* __restrict__ wo,
             int tp, const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_max,
             const uint8_t* __restrict__ active, int n, int early_exit,
             unsigned long long* __restrict__ keys) {
  constexpr int R = kRays<kAnyHit>, U = kUnroll<kAnyHit>;
  __shared__ float4 buf4[2][kStage * kRec / 4];
  __shared__ int list[kMaxBlockRays];
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int stages = tp / kStage, parts = gridDim.y;
  const int s_lo = blockIdx.y * stages / parts;
  const int s_hi = (blockIdx.y + 1) * stages / parts;
  if (s_lo == s_hi) return;
  stage(wd, wo, tp, s_lo * kStage, reinterpret_cast<float*>(buf4[0]));
  cp_async_commit();

  int id[R];
  bool keep[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    id[r] = (blockIdx.x * R + r) * kThreads + tid;
    keep[r] = id[r] < n && active[id[r]];
  }
  int live_n = compact(id, keep, list, warp_sum);

  float ro[R][3], rd[R][3], t_lim[R];
  int best[R];
  bool live[R];
  auto load = [&]() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = tid * R + r;
      live[r] = s < live_n;
      id[r] = live[r] ? list[s] : 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        ro[r][a] = o[3 * id[r] + a];
        rd[r][a] = d[3 * id[r] + a];
      }
      t_lim[r] = t_max[id[r]];
      best[r] = -1;
    }
  };
  load();

  for (int s = s_lo; s < s_hi && live_n > 0; ++s) {
    const bool next = s + 1 < s_hi;
    if (next)
      stage(wd, wo, tp, (s + 1) * kStage,
            reinterpret_cast<float*>(buf4[(s + 1 - s_lo) & 1]));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage s is in shared memory for every thread
    const float* smem = reinterpret_cast<const float*>(buf4[(s - s_lo) & 1]);
    const int base = s * kStage;
    if (any_live(live)) {
#pragma unroll (U)
      for (int j = 0; j < kStage; ++j) {
        const float4* rec4 = reinterpret_cast<const float4*>(smem + j * kRec);
        float rec[kRec];
#pragma unroll
        for (int k = 0; k < kRec / 4; ++k) {
          const float4 x = rec4[k];
          rec[4 * k] = x.x;
          rec[4 * k + 1] = x.y;
          rec[4 * k + 2] = x.z;
          rec[4 * k + 3] = x.w;
        }
        // Every slot runs the test, live or not (no branch around it, so
        // the slots' and the unrolled triangles' arithmetic interleaves);
        // only a live slot takes the hit.
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float tt, uu, vv;
          if (pair<kMxu>(rec, ro[r], rd[r], t_lim[r], tt, uu, vv) & live[r]) {
            best[r] = base + j;
            if (kAnyHit)
              live[r] = false;
            else
              t_lim[r] = tt;
          }
        }
        // Any-hit: the warp leaves the stage once its rays are done,
        // looking at the end of each unrolled group.
        if (kAnyHit && j % U == U - 1 && !any_live(live)) break;
      }
    }
    if (!kAnyHit) {
      __syncthreads();  // every thread is done with stage s's buffer
      continue;
    }
    // Any-hit: the stage's hits go to the keys; with the range split, a
    // ray that a block of an earlier range has found is dropped too. The
    // barrier that frees stage s's buffer tells whether any ray of the
    // block is done; only then is the list compacted (early_exit).
    const unsigned long long next_base = (unsigned long long)(base + kStage);
    bool done = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (best[r] >= 0) {
        atomicMin(keys + id[r], (unsigned long long)best[r]);
        done = true;
      }
      best[r] = -1;
      keep[r] = live[r];
      if (parts > 1 && live[r] &&
          *(volatile unsigned long long*)(keys + id[r]) < next_base) {
        keep[r] = false;
        done = true;
      }
    }
    if (__syncthreads_or(done && early_exit)) {
      live_n = compact(id, keep, list, warp_sum);
      load();
    }
  }
  cp_async_wait<0>();
  if (!kAnyHit) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (live[r] && best[r] >= 0)
        atomicMin(keys + id[r],
                  ((unsigned long long)__float_as_uint(t_lim[r]) << 32) |
                      (unsigned)best[r]);
  }
}

// The keys as t, prim, u, v: a miss and an inactive ray keep t_max, prim
// -1, u = v = 0; a closest hit's u, v are recomputed from the winner's
// columns as the pair test computed them at its t.
template <bool kAnyHit, bool kMxu>
__global__ void __launch_bounds__(256)
finish_kernel(const float* __restrict__ wd, const float* __restrict__ wo,
              int tp, const float* __restrict__ o,
              const float* __restrict__ d, const float* __restrict__ t_max,
              const uint8_t* __restrict__ active, int n, int tile,
              const unsigned long long* __restrict__ keys,
              float* __restrict__ t_out, int* __restrict__ prim_out,
              float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  float t = t_max[i], u = 0.0f, v = 0.0f;
  int prim = -1;
  if (active[i] && key != kNone) {
    const int j = (int)(unsigned)(key & 0xFFFFFFFFu);
    if (kAnyHit) {
      t = 0.0f;
      prim = j / tile * tile;
    } else {
      float rec[kRec];
      for (int k = 0; k < 9; ++k) rec[k] = wd[(size_t)k * tp + j];
      for (int k = 0; k < 12; ++k) rec[9 + k] = wo[(size_t)k * tp + j];
      const float ro[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
      const float rd[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
      t = __uint_as_float((unsigned)(key >> 32));
      u = __fmaf_rn(t, dot3<kMxu>(rec + 0, rd),
                    dot3<kMxu>(rec + 9, ro) + rec[18]);
      v = __fmaf_rn(t, dot3<kMxu>(rec + 1, rd),
                    dot3<kMxu>(rec + 10, ro) + rec[19]);
      prim = j;
    }
  }
  t_out[i] = t;
  prim_out[i] = prim;
  u_out[i] = u;
  v_out[i] = v;
}

template <bool kAnyHit, bool kMxu>
int launch(const float* wd, const float* wo, int tp, const float* o,
           const float* d, const float* t_max, const uint8_t* active, int n,
           int tile, int early_exit, float* t, int* prim, float* u, float* v,
           unsigned long long* keys, cudaStream_t stream) {
  // Fewer ray blocks than two waves of the blocks the card holds at once:
  // split the triangle range into parts, a block each, up to two waves.
  auto kernel = dense_kernel<kAnyHit, kMxu>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int block_rays = kThreads * kRays<kAnyHit>;
  const int ray_blocks = (n + block_rays - 1) / block_rays;
  const int waves = 2 * max(per_sm, 1) * sms;
  const int parts = max(1, min(tp / kStage, (waves + ray_blocks - 1) / ray_blocks));
  cudaError_t err = cudaMemsetAsync(keys, 0xFF, (size_t)n * sizeof(*keys),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(ray_blocks, parts), kThreads, 0, stream>>>(
      wd, wo, tp, o, d, t_max, active, n, early_exit, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<kAnyHit, kMxu><<<(n + 255) / 256, 256, 0, stream>>>(
      wd, wo, tp, o, d, t_max, active, n, tile, keys, t, prim, u, v);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Returns the CUDA error of the launches (0 =
// launched), -1 for arguments no kernel takes. n > 0; tp a multiple of tile
// and of gpt_dense_stage(); keys: n 64-bit words of scratch.
extern "C" {

int gpt_dense_stage() { return kStage; }

int gpt_dense_intersect(const float* wd, const float* wo, int tp,
                        const float* o, const float* d, const float* t_max,
                        const uint8_t* active, int n, int tile, int any_hit,
                        int use_mxu, int early_exit, float* t, int* prim,
                        float* u, float* v, unsigned long long* keys,
                        void* stream) {
  if (n < 1 || tile < 1 || tp % tile || tp % kStage) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    return use_mxu ? launch<true, true>(wd, wo, tp, o, d, t_max, active, n,
                                        tile, early_exit, t, prim, u, v, keys,
                                        s)
                   : launch<true, false>(wd, wo, tp, o, d, t_max, active, n,
                                         tile, early_exit, t, prim, u, v,
                                         keys, s);
  return use_mxu ? launch<false, true>(wd, wo, tp, o, d, t_max, active, n,
                                       tile, early_exit, t, prim, u, v, keys,
                                       s)
                 : launch<false, false>(wd, wo, tp, o, d, t_max, active, n,
                                        tile, early_exit, t, prim, u, v, keys,
                                        s);
}

}  // extern "C"
