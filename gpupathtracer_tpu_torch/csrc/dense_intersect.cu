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
// base index of the first tile that holds a hit, t = 0, u = v = 0, as the
// TPU kernel reports it.
//
// The TPU kernel runs a block of rays against a tile of triangles as two
// matrix products on the MXU (use_mxu) or as broadcast multiplies on the
// VPU, and reduces along the tile. Here one thread owns one ray and keeps
// the running (t, prim, u, v) in registers; the block stages a tile of
// triangles in shared memory (24 floats a triangle, read back as six
// 16-byte broadcast loads) and every thread runs over it. The H100's tensor
// cores have no full-FP32 mode, so both flags run FP32 FMAs on the CUDA
// cores; they are kept because they round differently, each as XLA rounds
// its form on the CPU (where the JAX package's tests run it): use_mxu as
// the K = 3 / K = 4 dot, fma(m2, x2, fma(m1, x1, m0 * x0)) + m3, and the
// multiply chain as fma(m2, x2, fma(m0, x0, m1 * x1)) + m3. Built with
// --fmad=false, so nvcc fuses nothing else.
//
// What bounds it on an H100: operations. A pair costs 44 FP32
// operations (an FMA as two) and six shared-memory loads; the bytes (the table once per
// block, from L2) are negligible.

#include "bvh_walk.cuh"

namespace {

constexpr int kRec = 24;  // floats per staged triangle: 7 rows x 3 thirds + 3

// Stages triangles [base, base + tile) as records rec[part * 3 + third],
// part 0..2 the rows of wd, 3..6 the rows of wo.
__device__ __forceinline__ void stage_tile(const float* __restrict__ wd,
                                           const float* __restrict__ wo,
                                           int tp, int base, int tile,
                                           float* __restrict__ smem) {
  const int per_part = 3 * tile;
  for (int e = threadIdx.x; e < 7 * per_part; e += blockDim.x) {
    int part = e / per_part, rem = e - part * per_part;
    int third = rem / tile, j = rem - third * tile;
    size_t col = (size_t)third * tp + base + j;
    float x = part < 3 ? wd[(size_t)part * 3 * tp + col]
                       : wo[(size_t)(part - 3) * 3 * tp + col];
    smem[j * kRec + part * 3 + third] = x;
  }
}

template <bool kMxu>
__device__ __forceinline__ float dot3(const float* m, const float* x) {
  return kMxu ? bvh::dot_k3(m, 3, x) : bvh::dot_rc(m, 3, x);
}

template <bool kAnyHit, bool kMxu>
__global__ void __launch_bounds__(1024)
dense_kernel(const float* __restrict__ wd, const float* __restrict__ wo, int tp,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_max,
             const uint8_t* __restrict__ active, int n, int tile,
             int early_exit, float* __restrict__ t_out,
             int* __restrict__ prim_out, float* __restrict__ u_out,
             float* __restrict__ v_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const int ii = in ? i : 0;
  const float ro[3] = {o[3 * ii], o[3 * ii + 1], o[3 * ii + 2]};
  const float rd[3] = {d[3 * ii], d[3 * ii + 1], d[3 * ii + 2]};
  const float tmax = t_max[ii];
  const bool act = in && active[ii];
  float t_best = tmax, u_best = 0.0f, v_best = 0.0f;
  int prim = -1;

  for (int base = 0; base < tp; base += tile) {
    __syncthreads();  // the previous tile has been read
    stage_tile(wd, wo, tp, base, tile, smem);
    __syncthreads();
    if (act && !(kAnyHit && prim >= 0)) {
#pragma unroll 4
      for (int j = 0; j < tile; ++j) {
        const float4* rec4 = reinterpret_cast<const float4*>(smem + j * kRec);
        float rec[kRec];
#pragma unroll
        for (int k = 0; k < kRec / 4; ++k) {
          float4 x = rec4[k];
          rec[4 * k] = x.x;
          rec[4 * k + 1] = x.y;
          rec[4 * k + 2] = x.z;
          rec[4 * k + 3] = x.w;
        }
        float da = dot3<kMxu>(rec + 0, rd);
        float db = dot3<kMxu>(rec + 1, rd);
        float dc = dot3<kMxu>(rec + 2, rd);
        float oa = dot3<kMxu>(rec + 9, ro) + rec[18];
        float ob = dot3<kMxu>(rec + 10, ro) + rec[19];
        float num = dot3<kMxu>(rec + 11, ro) + rec[20];
        float tt = num / dc;
        float uu = __fmaf_rn(tt, da, oa);
        float vv = __fmaf_rn(tt, db, ob);
        if (uu > 0.0f && vv > 0.0f && uu + vv < 1.0f && tt > 0.0f &&
            tt < t_best) {
          if (kAnyHit) {
            prim = base;
            break;
          }
          t_best = tt;
          prim = base + j;
          u_best = uu;
          v_best = vv;
        }
      }
    }
    // Any-hit: the block leaves once each of its active rays has a hit.
    if (kAnyHit && early_exit && __syncthreads_and(!act || prim >= 0)) break;
  }
  if (!in) return;
  if (kAnyHit) {
    t_out[i] = prim >= 0 ? 0.0f : tmax;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
  } else {
    t_out[i] = t_best;
    u_out[i] = u_best;
    v_out[i] = v_best;
  }
  prim_out[i] = prim;
}

template <bool kAnyHit, bool kMxu>
int launch(const float* wd, const float* wo, int tp, const float* o,
           const float* d, const float* t_max, const uint8_t* active, int n,
           int block, int tile, int early_exit, float* t, int* prim, float* u,
           float* v, cudaStream_t stream) {
  size_t smem = (size_t)tile * kRec * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_kernel<kAnyHit, kMxu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_kernel<kAnyHit, kMxu><<<(n + block - 1) / block, block, smem, stream>>>(
      wd, wo, tp, o, d, t_max, active, n, tile, early_exit, t, prim, u, v);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Returns the CUDA error of the launch (0 =
// launched). n > 0; tp a multiple of tile; block <= 1024 threads;
// tile * gpt_dense_tile_bytes() must fit the block's shared memory.
extern "C" {

int gpt_dense_tile_bytes() { return kRec * (int)sizeof(float); }

int gpt_dense_intersect(const float* wd, const float* wo, int tp,
                        const float* o, const float* d, const float* t_max,
                        const uint8_t* active, int n, int block, int tile,
                        int any_hit, int use_mxu, int early_exit, float* t,
                        int* prim, float* u, float* v, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    return use_mxu ? launch<true, true>(wd, wo, tp, o, d, t_max, active, n,
                                        block, tile, early_exit, t, prim, u, v,
                                        s)
                   : launch<true, false>(wd, wo, tp, o, d, t_max, active, n,
                                         block, tile, early_exit, t, prim, u,
                                         v, s);
  return use_mxu ? launch<false, true>(wd, wo, tp, o, d, t_max, active, n,
                                       block, tile, early_exit, t, prim, u, v,
                                       s)
                 : launch<false, false>(wd, wo, tp, o, d, t_max, active, n,
                                        block, tile, early_exit, t, prim, u, v,
                                        s);
}

}  // extern "C"
