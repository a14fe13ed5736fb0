// Wide-BVH ray traversal on Hopper: one thread per ray, its own stack.
//
// Replaces the TPU's Pallas packet kernels
//   gpupathtracer_tpu/ops/pallas_traverse.py:72   _kernel       (closest / any-hit)
//   gpupathtracer_tpu/ops/pallas_traverse.py:1036 _kernel_pair  (two packets per
//                                                  step; same results as _kernel)
// over the same merged 128-float row table (bvh/wide.py pack_for_packets):
//   node row : cols 0:48  = 8 children x (min.xyz, max.xyz)
//              cols 48:56 = 8 child entries (int32 bit-cast)
//   leaf rows: 10 slots of 12 floats (p0, e1, e2, prim id bit-cast, mat, sign);
//              a leaf spans ceil(leaf_size / 10) consecutive rows.
// Entries: INVALID (0x7FFFFFFF) = empty slot, e >= 0 = node row e,
// e < 0 = leaf, packed = -(e + 1): first row = packed >> 4, count = packed & 15.
//
// The TPU kernels share one stack per 2048-ray packet because the TPU has a
// scalar unit beside a vector unit; here every thread walks alone, as the
// original GLSL traversal did. The arithmetic is the Pallas kernel's, term
// by term, as XLA compiles it for the CPU (where the JAX package's tests
// and goldens run): slab test as fma(lo, inv, -o*inv), Moller-Trumbore with
// strict inequalities and the fused multiply-adds LLVM forms there
// (ops/intersect.py). Built with --fmad=false so that nvcc contracts nothing
// else and 1/det stays an IEEE division; the results are then bit-identical
// to the plain torch version (ops/kernel_traverse.py closest_plain /
// anyhit_plain).
//
// What bounds it on an H100: each pop is a dependent 512-byte row read
// (sponza's 25.5 MB table fits the 50 MB L2, so most are L2 hits) and the
// warp diverges as its 32 rays walk different paths. This first version
// does nothing about either (no packet sharing, no ray sorting, no
// persistent threads); the stack lives in local memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;
constexpr int kArity = 8;
constexpr int kTrisPerRow = kRow / 12;  // 10
constexpr int kMaxStack = 192;          // cfg.stack_depth * 4
constexpr int kThreads = 128;
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

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = o[3 * i + a];
    r.d[a] = d[3 * i + a];
    // sign(d) / max(|d|, 1e-12)  (pallas_traverse.py:1311-1312)
    r.inv[a] = (r.d[a] >= 0.0f ? 1.0f : -1.0f) / nan_max(fabsf(r.d[a]), 1e-12f);
    r.oi[a] = r.o[a] * r.inv[a];
  }
  return r;
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
// ops/intersect.py mt_intersect. With `any_hit`, returns
// at the first hit.
__device__ __forceinline__ void intersect_leaf(const float* __restrict__ block,
                                               int count, const Ray& r,
                                               bool any_hit, float& t,
                                               int& prim, float& u, float& v) {
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
      if (any_hit) return;
    }
  }
}

template <bool kAnyHit>
__device__ __forceinline__ void traverse(const float* __restrict__ rows,
                                         const Ray& r, int depth, float& t,
                                         int& prim, float& u, float& v) {
  int stack[kMaxStack];
  int sp = 1;
  stack[0] = 0;  // root node row
  while (sp > 0) {
    int entry = stack[--sp];
    if (entry >= 0) {
      expand_node(rows + (size_t)entry * kRow, r, t, !kAnyHit, stack, sp,
                  depth);
    } else {
      int packed = -(entry + 1);
      intersect_leaf(rows + (size_t)(packed >> 4) * kRow, packed & 15, r,
                     kAnyHit, t, prim, u, v);
      if (kAnyHit && prim >= 0) return;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
trace_closest_kernel(const float* __restrict__ rows,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max,
                     const uint8_t* __restrict__ active, int n, int depth,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_max[i], u = 0.0f, v = 0.0f;
  int prim = -1;
  if (active[i]) {
    Ray r = load_ray(o, d, i);
    traverse<false>(rows, r, depth, t, prim, u, v);
  }
  t_out[i] = t;
  prim_out[i] = prim;
  u_out[i] = u;
  v_out[i] = v;
}

__global__ void __launch_bounds__(kThreads)
trace_anyhit_kernel(const float* __restrict__ rows,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const uint8_t* __restrict__ active, int n, int depth,
                    uint8_t* __restrict__ occluded) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_max[i], u = 0.0f, v = 0.0f;
  int prim = -1;
  if (active[i]) {
    Ray r = load_ray(o, d, i);
    traverse<true>(rows, r, depth, t, prim, u, v);
  }
  occluded[i] = prim >= 0 ? 1 : 0;
}

}  // namespace

// Plain C interface for ctypes. Each returns cudaGetLastError() after its
// launch (0 = launched); the caller checks it. n must be > 0.
extern "C" {

int gpt_max_stack() { return kMaxStack; }

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
