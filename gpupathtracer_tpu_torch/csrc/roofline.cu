// The roofline probes on Hopper: what the card does with no memory traffic,
// and what each phase of a tree walk costs without the stack machinery.
//
// Replaces the TPU's Pallas probes of tools/roofline.py:
//   :129 vpu_kernel            ilp chains of max((a * s + 0.25) * 0.9998, 0.125)
//   :177 mxu_kernel            acc += dot(a + acc[:, :1] * 1e-30, b)
//   :253 node_slab_kernel      the 8-child slab test of a node pop
//   :289 leaf_mt_kernel        the Moller-Trumbore test of a 10-triangle leaf
//   :332 cluster_dense_kernel  a dense cluster pop and its winner's u, v
// with the same arithmetic, term for term, in the rounding XLA gives the JAX
// probes on the CPU (ops/roofline.py holds the plain versions; both agree
// bit for bit, but for the bf16 tensor-core sums).
//
// A TPU probe is one [64, 128] or [16, 128] tile on one core: 2,048-8,192
// lanes, about 1% of what fills an H100 (132 SMs). Every probe here does
// the same tile's work `copies` times over, one block per 128 lanes of a
// copy, and writes [copies, *tile]; the rate counts every copy.
//
// What bounds each: the VPU, node, leaf and cluster probes are FP32
// instruction streams on registers and on 32-48 KB of rows or blocks that
// L1 or shared memory holds after the first pass (it stands in for the
// TPU's VMEM slice), so the card's FP32 issue rate bounds them, and the f32
// product's fused multiply-adds too (the H100's tensor cores have no full
// FP32 mode): its blocks stage their operands in shared memory once and
// hold 8 x 8 outputs a thread, so a k step is four 16-byte shared loads for
// 64 FFMA (section 2). The bf16 product runs wgmma on the tensor cores
// (section 3): both operands staged in shared memory once, the feedback
// added to A in registers. The feedback term acc[:, :1] means every
// iteration of a row band needs column 0 of the last one: an f32 block
// owns whole rows (only an N wider than 2048 splits them), a bf16 block
// whose column slab lacks column 0 computes it itself as well, with the
// same instructions, so the copies agree bit for bit.
//
// The cluster probe (:332 cluster_dense_kernel) is the floor that the
// cluster walks' pops are read against, so it has to run at the card's
// rate and not at its own. One thread a lane looping over the slots with
// scalar loads (the first port) reached 15% of its FP32 bound on an H100
// (NVIDIA H100 80GB HBM3, 700 W): 21 uniform loads a slot against 31
// counted operations, 16 warps an SM, and one dependent chain of divisions
// a warp. Here both blocks sit in shared memory; a slot's coefficients come
// as 16-byte loads of four neighbouring slots; two threads share a pair of
// rays, each taking every other group of four slots, so a load serves
// eight (ray, slot) pairs and eight divisions are in flight a thread; the
// two halves meet in a lexicographic (t, slot) shuffle. That runs at 48% of
// the bound (tc 128: 1.065 ms against 0.5152 for 64 pops x 33 copies of
// G = 16; tools/torch_walk_variants.py --groups cluster-probe). What is
// left is issue: the compiled slot is about 45 instructions (the IEEE
// division is seven and a slow-path check, the bound counts it as one;
// the compares, 5.25 loads) against the 31 counted.

#include <cuda_bf16.h>

#include "bvh_walk.cuh"
#include "wgmma.cuh"

// Built at the default arity only (ops/cuda_build.py passes no GPT_ARITY
// here): this source reads 8-wide node rows.
static_assert(bvh::kArity == 8, "this source reads 8-wide node rows");

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 128;
constexpr int kRows = 64;      // rows the node and leaf probes rotate over
constexpr int kLeafSize = 10;  // triangles of the leaf probe's row

// --- 1. VPU ------------------------------------------------------------------

// One thread per element of x [rows, 128] in each copy. XLA contracts the
// scale row and a * scale + 0.25 into fused multiply-adds; a * 0.9998 stays
// a multiply.
template <int kIlp>
__global__ void __launch_bounds__(kThreads)
vpu_kernel(const float* __restrict__ x, int per_copy, int total, int iters,
           float* __restrict__ out) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  int e = g % per_copy;
  float xe = x[e];
  float scale = __fmaf_rn(x[e % kLanes], 1e-6f, 0.9999f);
  float acc[kIlp];
#pragma unroll
  for (int k = 0; k < kIlp; ++k) acc[k] = xe * (float)(1.0 + 1e-4 * k);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kIlp; ++k)
      acc[k] = bvh::nan_max(__fmaf_rn(acc[k], scale, 0.25f) * 0.9998f, 0.125f);
  }
  float r = acc[0];
#pragma unroll
  for (int k = 1; k < kIlp; ++k) r = r + acc[k];
  out[g] = r;
}

// --- 2. matrix products ------------------------------------------------------

// f32, staged once for Hopper. A block owns a band of bm rows and a slab of
// bn columns of one copy, bn = N whenever N <= kMaxBn, so column 0 (the
// feedback) is the block's own; only a shape with N wider than that has
// other column slabs, whose blocks recompute column 0 of their rows (one
// thread a row, the same chain in the same order; nt is 256 there, so a
// block has more threads than rows). Before the iteration
// loop the block stages its band of a and b's slab in shared memory,
// k-major (a0[k][r], bs[k][c]); each iteration rebuilds only ap = a0 + fb
// there, with no global traffic. Thread (tx, ty) of nt x mt holds 8 x 8
// outputs in registers: rows ty * 4 + i and bm / 2 + ty * 4 + i, columns
// tx * 4 + j and bn / 2 + tx * 4 + j (i, j < 4), so a k step is four
// 16-byte shared loads (the lanes of a warp read few distinct words: a
// broadcast) for 64 FFMA. Per iteration and output, the sum over k is a
// chain of fused multiply-adds in k order from +0, then added to acc.
constexpr int kMaxBn = 2048;     // widest column slab a block owns
constexpr int kF32Threads = 256;  // most threads of a block

struct MxuPlan {
  int nt, mt, col_tiles, bands;
  size_t smem;
};

// Floats of shared memory a block of mt thread rows uses: a0 and ap
// (bm * k each), bs (k * bn), fb (bm) and, with several column slabs,
// b's column 0 (k).
size_t mxu_f32_smem(int mt, int k, int bn, int col_tiles) {
  size_t bm = 8 * (size_t)mt;
  return 4 * (2 * bm * k + (size_t)k * bn + bm + (col_tiles > 1 ? k : 0));
}

// The tiling of one shape: nt column threads cover min(N, kMaxBn) columns,
// and as many thread rows as fit 256 threads, the rows of a copy and the
// shared memory a block can have. nt = 0 when no block fits.
MxuPlan mxu_f32_plan(int m, int k, int n, size_t smem_max) {
  MxuPlan p{};
  p.nt = (min(n, kMaxBn) + 7) / 8;
  const int bn = 8 * p.nt;
  p.col_tiles = (n + bn - 1) / bn;
  p.mt = min(kF32Threads / p.nt, (m + 7) / 8);
  while (p.mt > 0 && mxu_f32_smem(p.mt, k, bn, p.col_tiles) > smem_max)
    --p.mt;
  if (p.mt == 0) {
    p.nt = 0;
    return p;
  }
  p.smem = mxu_f32_smem(p.mt, k, bn, p.col_tiles);
  p.bands = (m + 8 * p.mt - 1) / (8 * p.mt);
  return p;
}

__global__ void __launch_bounds__(kF32Threads, 1)
mxu_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
               int m, int k, int n, int iters, int nt, int mt,
               int col_tiles, int bands, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int bm = 8 * mt, bn = 8 * nt, threads = nt * mt;
  float* a0 = reinterpret_cast<float*>(smem4);
  float* ap = a0 + (size_t)bm * k;
  float* bs = ap + (size_t)bm * k;
  float* fb = bs + (size_t)k * bn;
  float* b0 = fb + bm;
  const int per_copy = bands * col_tiles;
  const int copy = blockIdx.x / per_copy, rest = blockIdx.x % per_copy;
  const int row0 = (rest / col_tiles) * bm;
  const int slab = rest % col_tiles, col0 = slab * bn;
  const int tid = threadIdx.x, tx = tid % nt, ty = tid / nt;
  const bool recompute = slab > 0;

  for (int e = tid; e < bm * k; e += threads) {
    const int r = e / k, kk = e % k;
    a0[kk * bm + r] = row0 + r < m ? a[(size_t)(row0 + r) * k + kk] : 0.0f;
  }
  for (int e = tid; e < k * bn; e += threads) {
    const int kk = e / bn, c = e % bn;
    bs[e] = col0 + c < n ? b[(size_t)kk * n + col0 + c] : 0.0f;
  }
  if (recompute)
    for (int kk = tid; kk < k; kk += threads) b0[kk] = b[(size_t)kk * n];

  // Row i of the thread's 8: local row ty * 4 + i (i < 4), bm / 2 + ...
  auto row_of = [&](int i) { return (i < 4 ? 0 : bm / 2) + ty * 4 + (i & 3); };
  float acc[8][8] = {}, acc0 = 0.0f;
  for (int it = 0; it < iters; ++it) {
    if (!recompute) {
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) fb[row_of(i)] = acc[i][0] * 1e-30f;
      }
    } else if (tid < bm) {
      fb[tid] = acc0 * 1e-30f;
    }
    __syncthreads();  // fb written; every thread is done with ap
    for (int e = tid; e < bm * k; e += threads) ap[e] = a0[e] + fb[e % bm];
    __syncthreads();
    float s[8][8] = {};
    const float* pa = ap + ty * 4;
    const float* pb = bs + tx * 4;
#pragma unroll 2
    for (int kk = 0; kk < k; ++kk) {
      const float4 alo = *reinterpret_cast<const float4*>(pa);
      const float4 ahi = *reinterpret_cast<const float4*>(pa + bm / 2);
      const float4 blo = *reinterpret_cast<const float4*>(pb);
      const float4 bhi = *reinterpret_cast<const float4*>(pb + bn / 2);
      const float av[8] = {alo.x, alo.y, alo.z, alo.w,
                           ahi.x, ahi.y, ahi.z, ahi.w};
      const float bv[8] = {blo.x, blo.y, blo.z, blo.w,
                           bhi.x, bhi.y, bhi.z, bhi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = __fmaf_rn(av[i], bv[j], s[i][j]);
      pa += bm;
      pb += bn;
    }
    if (recompute && tid < bm) {
      float s0 = 0.0f;
      for (int kk = 0; kk < k; ++kk) s0 = __fmaf_rn(ap[kk * bm + tid], b0[kk], s0);
      acc0 = acc0 + s0;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] + s[i][j];
  }
  float* o = out + (size_t)copy * m * n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + row_of(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + (j < 4 ? 0 : bn / 2) + tx * 4 + (j & 3);
      if (gr < m && gc < n) o[(size_t)gr * n + gc] = acc[i][j];
    }
  }
}

// --- 3. the bf16 product on wgmma -------------------------------------------
//
// What bounds it: 2 M K N bf16 operations an iteration at the tensor cores'
// 989 TFLOP/s; its operands are 64 KB to 200 KB a block and are read every
// iteration, so they must stay on chip. Only wgmma reaches that rate, and
// the feedback (a + bf16(acc[:, :1] * 1e-30), rounded to bf16 as JAX adds
// two bf16 arrays) changes A every iteration, so:
//   - a block is one warpgroup (128 threads) on a 64-row band and a column
//     slab of bn = 8, 64 or 128 columns (the narrowest that holds N, 128
//     above 64; a slab past N is zero-padded and its stores masked);
//   - once per block, b's slab goes by cp.async into row-major buffers and
//     from there, transposed, into a K-major tile in the 128-byte swizzle
//     (B^T: a row of 64 k a 128-byte line, 16-byte chunks XORed with the
//     row), which the wgmma descriptor names; then a's band goes by
//     cp.async into rows of K + 8 values (ldmatrix without bank conflicts),
//     K padded with zeros to a multiple of 128 (kPadK).
//     At 512^3 the slab (139 KB with column 0) and the band (65 KB) fill a
//     block's shared memory: one block an SM. A ring of K tiles streamed
//     every iteration would read the slab from L2 each time instead;
//   - every k step a warp loads its 16 x 16 slice of the band with one
//     ldmatrix, adds its two rows' feedback in f32 and rounds each pair
//     back with one cvt (a register A: no shared-memory rewrite, no block
//     barrier in the loop), and issues wgmma m64nNk16 with B from shared
//     memory. Four k steps make a group; two groups of A registers
//     alternate, so one group's loads and adds overlap the last one's
//     products (wgmma.wait_group 1);
//   - each iteration's sum starts from zero (scale-d 0 on its first k
//     step) and is added to acc in f32, as the TPU kernel's acc + dot;
//   - column 0 of the band: in slab 0 it is the tile's own; with several
//     slabs every block computes b's columns 0-7 as 8 more columns of its
//     wgmma (N = 136), so the blocks of a band need no exchange. Lane 4 g of
//     a warp holds column 0 of rows g and g + 8, which a shuffle brings to
//     the lanes that hold those rows' A registers.
constexpr int kWgThreads = 128;  // one warpgroup a block
constexpr int kBand = 64;        // wgmma's M: rows a block
constexpr int kPanel = 64;       // k of one 128-byte swizzle row
constexpr int kGroup = 4;        // k steps a wgmma group
// K padded with zeros to whole pairs of groups: no k step is conditional,
// so ptxas keeps the wgmma chain asynchronous (a branch around one makes it
// serialize them all).
constexpr int kPadK = 2 * kGroup * 16;

struct Bf16Plan {
  int bn, nw, slabs, slots;
  size_t smem;
};

// The tiling of one shape: slab width bn, wgmma width nw (bn, plus 8 for
// column 0 when the band has several slabs), staging buffers and shared
// memory (B^T, then the band, which the staging buffers use first), all
// at K padded to kPadK.
Bf16Plan bf16_plan(int k, int n) {
  Bf16Plan p{};
  p.bn = n <= 8 ? 8 : n <= 64 ? 64 : 128;
  p.slabs = (n + p.bn - 1) / p.bn;
  p.nw = p.bn + (p.slabs > 1 ? 8 : 0);
  const size_t kp = (k + kPadK - 1) / kPadK * kPadK;
  const size_t band = (size_t)kBand * (kp + 8) * 2;
  const size_t slot = (size_t)kPanel * p.nw * 2;
  p.slots = band >= 2 * slot ? 2 : 1;
  p.smem = 1024 + kp / kPanel * p.nw * 128 + max(band, p.slots * slot);
  return p;
}

// (a + f) rounded to bf16 for a pair of bf16 values packed in x.
__device__ __forceinline__ uint32_t fed2(uint32_t x, float f) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      __uint_as_float(x << 16) + f, __uint_as_float(x & 0xFFFF0000u) + f);
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <int kNw, bool kCol0>
__global__ void __launch_bounds__(kWgThreads)
mxu_wgmma_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b, int m, int k, int n,
                int iters, int slabs, int slots,
                float* __restrict__ out) {
  constexpr int kBn = kCol0 ? kNw - 8 : kNw;
  constexpr int kAcc = kNw / 2;
  constexpr int kC0 = kCol0 ? kBn / 8 : 0;  // register group of column 0
  extern __shared__ uint8_t bf16_smem[];
  uint8_t* bt =
      bf16_smem + ((1024 - wg::smem_addr(bf16_smem) % 1024) % 1024);
  const int kp = (k + kPadK - 1) / kPadK * kPadK;
  const int panels = kp / kPanel;
  uint8_t* region = bt + (size_t)panels * kNw * 128;
  const int per_copy = (m / kBand) * slabs;
  const int copy = blockIdx.x / per_copy, rest = blockIdx.x % per_copy;
  const int row0 = (rest / slabs) * kBand, col0 = (rest % slabs) * kBn;
  const int tid = threadIdx.x;

  // B^T: panel p (k in 64 p .. 64 p + 63) through staging slot p % slots,
  // [k][kNw] row-major: columns col0.. of the slab, then (kCol0) 0..7;
  // zeros past K and N.
  const int slot_elems = kPanel * kNw;
  auto stage = [&](int p) {
    if (p < panels) {
      __nv_bfloat16* buf =
          reinterpret_cast<__nv_bfloat16*>(region) + (p % slots) * slot_elems;
      for (int e = tid; e < kPanel * (kNw / 8); e += kWgThreads) {
        const int r = e / (kNw / 8), c = e % (kNw / 8) * 8;
        const int col = c < kBn ? col0 + c : c - kBn;
        const bool in = col < n && kPanel * p + r < k;
        wg::cp_async16(
            buf + r * kNw + c,
            b + (in ? (size_t)(kPanel * p + r) * n + col : 0), in ? 16 : 0);
      }
    }
    wg::cp_async_commit();  // empty past the last panel: a constant count
  };
  for (int p = 0; p < slots; ++p) stage(p);
  for (int p = 0; p < panels; ++p) {
    if (slots == 2)
      wg::cp_async_wait<1>();
    else
      wg::cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16* buf = reinterpret_cast<const __nv_bfloat16*>(region) +
                               (p % slots) * slot_elems;
    uint8_t* panel = bt + (size_t)p * kNw * 128;
    for (int e = tid; e < kPanel / 8 * kNw; e += kWgThreads) {
      const int row = e % kNw, c = e / kNw;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = (uint32_t)__bfloat16_as_ushort(
                   buf[(8 * c + 2 * q) * kNw + row]) |
               ((uint32_t)__bfloat16_as_ushort(
                    buf[(8 * c + 2 * q + 1) * kNw + row])
                << 16);
      *reinterpret_cast<uint4*>(panel + row * 128 + ((c ^ (row & 7)) << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();  // the slot is free again
    stage(p + slots);
  }
  wg::fence_async_shared();  // B^T, written here, is read by wgmma

  // a's band, rows of kp + 8 values, zeros past K.
  const int astride = kp + 8;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(region);
  for (int e = tid; e < kBand * (kp / 8); e += kWgThreads) {
    const int r = e / (kp / 8), c = e % (kp / 8) * 8;
    wg::cp_async16(as + r * astride + c,
                   a + (c < k ? (size_t)(row0 + r) * k + c : 0),
                   c < k ? 16 : 0);
  }
  wg::cp_async_commit();
  wg::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  // ldmatrix tiles: rows 0-7 / 8-15 of the warp's 16 at k 0-7, then k 8-15.
  const uint32_t a_addr = wg::smem_addr(
      as + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * astride +
      (lane >> 4) * 8);
  const uint32_t b_addr = wg::smem_addr(bt);
  const int steps = kp / 16;
  float acc[kAcc], s[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = s[i] = 0.0f;
  uint32_t ar0[kGroup][4], ar1[kGroup][4];
  // One group of k steps from step k0 on A registers ar: loads, feedback,
  // then the products; `wait`: the group two back, which used ar, is done
  // first.
  auto group = [&](uint32_t(&ar)[kGroup][4], int k0, bool wait, float f_lo,
                   float f_hi) {
    if (wait) wg::wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      wg::ldmatrix_x4(ar[j], a_addr + (k0 + j) * 32);
      ar[j][0] = fed2(ar[j][0], f_lo);
      ar[j][1] = fed2(ar[j][1], f_hi);
      ar[j][2] = fed2(ar[j][2], f_lo);
      ar[j][3] = fed2(ar[j][3], f_hi);
    }
    wg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int ks = k0 + j;
      wg::wgmma_rs(
          s, ar[j],
          wg::sw128_desc(b_addr + (ks / 4) * kNw * 128 + (ks % 4) * 32),
          ks > 0);
    }
    wg::wgmma_commit();
  };
  for (int it = 0; it < iters; ++it) {
    // acc[r, 0] of rows r_lo, r_hi sits in lane 4 * grp.
    const float c_lo = __shfl_sync(0xFFFFFFFFu, acc[4 * kC0], lane & ~3);
    const float c_hi = __shfl_sync(0xFFFFFFFFu, acc[4 * kC0 + 2], lane & ~3);
    const float f_lo = __bfloat162float(__float2bfloat16_rn(c_lo * 1e-30f));
    const float f_hi = __bfloat162float(__float2bfloat16_rn(c_hi * 1e-30f));
    group(ar0, 0, false, f_lo, f_hi);
    group(ar1, kGroup, false, f_lo, f_hi);
    for (int k0 = 2 * kGroup; k0 < steps; k0 += 2 * kGroup) {
      group(ar0, k0, true, f_lo, f_hi);
      group(ar1, k0 + kGroup, true, f_lo, f_hi);
    }
    wg::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      wg::fence_operand(s[i]);
      acc[i] = acc[i] + s[i];
    }
  }
  float* o = out + (size_t)copy * m * n;
  const int r_lo = row0 + 16 * warp + lane / 4;
#pragma unroll
  for (int g = 0; g < kBn / 8; ++g) {
    const int c = col0 + 8 * g + 2 * (lane % 4);
    if (c < n) {
      *reinterpret_cast<float2*>(o + (size_t)r_lo * n + c) =
          make_float2(acc[4 * g], acc[4 * g + 1]);
      *reinterpret_cast<float2*>(o + (size_t)(r_lo + 8) * n + c) =
          make_float2(acc[4 * g + 2], acc[4 * g + 3]);
    }
  }
}

// --- 4. traversal-phase floors -------------------------------------------------

// Lane l of a [3, G, 128] ray tile: a ray with the given inverse direction
// (the JAX probes take inv = 1 / d as an input; oi = o * inv as they do).
__device__ __forceinline__ bvh::Ray tile_ray(const float* __restrict__ o,
                                             const float* __restrict__ d,
                                             const float* __restrict__ inv,
                                             int lanes, int l) {
  bvh::Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = o[a * lanes + l];
    r.d[a] = d ? d[a * lanes + l] : 0.0f;
    r.inv[a] = inv ? inv[a * lanes + l] : 0.0f;
    r.oi[a] = r.o[a] * r.inv[a];
  }
  return r;
}

// The node pop's slab body (bvh_walk.cuh slab_test, the walk's own) against
// row i % 64; acc sums the entry distances of the entered children:
// t_cur = acc + 1e20 once a pop, then for each child in turn
// acc = acc + (hit ? tmin : 0).
//
// The probe is the floor that the walks' node pops are read against, so it
// has to run at the card's rate. The first port (one thread a lane, 128 a
// block) read a pop's 48 bounds as 48 scalar loads from global memory, every
// lane of the grid the same address, with the address arithmetic of
// i % 64 each pop, and reached 44.4% of its FP32 bound (NVIDIA H100 80GB
// HBM3, 700 W): 48 loads against 169 counted instructions. Here the 64 rows'
// used 48 floats sit in shared memory (12 KB, staged once a block), children
// 2m and 2m + 1 come as three 16-byte words that every thread of a warp
// reads at one address (a broadcast), so a pop is 12 loads for both of a
// thread's rays. The term is added under the hit predicate
// (`if (hit) acc += tmin`): acc starts at +0 and a sum that rounds to zero
// is +0, so acc is never -0 and adding +0 is the identity; NaN and inf add
// as before, so the bits are the select's.
//
// The sum is not order-free: a ray that starts inside a box enters it at a
// negative tmin, and a sum of partial sums rounds otherwise. So one thread
// adds a pop's eight terms in child order, and the next pop's t_cur waits
// for them. A thread carries kNodeRays = 2 rays, each word serving both,
// so a thread has two independent add chains. One and four rays a thread,
// two threads a lane (four children each, the terms met by shuffles), 128
// threads a block, four pops a loop step, the rows read from global memory
// and the parent's select were timed beside this design as text edits of
// it (tools/torch_walk_variants.py --groups node-probe, PERF.md section 6).
// This design runs at 69.4% of the bound (0.1257 ms against 0.0873 for 256
// pops x 33 copies of G = 16; the first port 0.1952-0.1974; NVIDIA H100
// 80GB HBM3, 700 W). The bound counts 169 instructions a pop, the JAX
// probe's; this body needs 161 (80 FMNMX, 48 FFMA, 24 FSETP, 9 FADD: no
// select), 66.2% at that count.
constexpr int kNodeRays = 2;
constexpr int kNodeThreads = 256;
constexpr int kNodeWords = bvh::kArity * 6 / 4;  // 16-byte words of a pop

// The boxes of children 2m and 2m + 1 of a pop's row (words w).
__device__ __forceinline__ void node_pair(const float4* w, int m,
                                          float (&b)[12]) {
  const float4 w0 = w[3 * m], w1 = w[3 * m + 1], w2 = w[3 * m + 2];
  b[0] = w0.x, b[1] = w0.y, b[2] = w0.z, b[3] = w0.w;
  b[4] = w1.x, b[5] = w1.y, b[6] = w1.z, b[7] = w1.w;
  b[8] = w2.x, b[9] = w2.y, b[10] = w2.z, b[11] = w2.w;
}

// One pop of row w for each of the thread's rays.
__device__ __forceinline__ void node_pop(const float4* w,
                                         const bvh::Ray (&r)[kNodeRays],
                                         float (&acc)[kNodeRays]) {
  float b[bvh::kArity / 2][12];
#pragma unroll
  for (int p = 0; p < bvh::kArity / 2; ++p) node_pair(w, p, b[p]);
#pragma unroll
  for (int k = 0; k < kNodeRays; ++k) {
    const float t_cur = acc[k] + 1e20f;
#pragma unroll
    for (int j = 0; j < bvh::kArity; ++j) {
      float tmin;
      if (bvh::slab_test(b[j / 2] + 6 * (j % 2), r[k], t_cur, tmin))
        acc[k] = acc[k] + tmin;
    }
  }
}

// Thread t carries rays t * kNodeRays + k. The last block's extra threads
// trace rays of the tile again and store nothing.
__global__ void __launch_bounds__(kNodeThreads)
node_slab_kernel(const float* __restrict__ rows, const float* __restrict__ o,
                 const float* __restrict__ inv, int lanes, int total,
                 int iters, float* __restrict__ out) {
  __shared__ float4 srows[kRows * kNodeWords];
  for (int e = threadIdx.x; e < kRows * kNodeWords; e += blockDim.x)
    srows[e] = bvh::load4(rows + (e / kNodeWords) * bvh::kRow +
                          4 * (e % kNodeWords));
  __syncthreads();
  const int ray = (blockIdx.x * blockDim.x + threadIdx.x) * kNodeRays;
  bvh::Ray r[kNodeRays];
  float acc[kNodeRays];
#pragma unroll
  for (int k = 0; k < kNodeRays; ++k) {
    r[k] = tile_ray(o, nullptr, inv, lanes, (ray + k) % lanes);
    acc[k] = 0.0f;
  }
  for (int i = 0; i < iters; ++i)
    node_pop(srows + (i & (kRows - 1)) * kNodeWords, r, acc);
#pragma unroll
  for (int k = 0; k < kNodeRays; ++k)
    if (ray + k < total) out[ray + k] = acc[k];
}

// The leaf pop's Moller-Trumbore body over the 10 triangles of row i % 64:
// bvh_walk.cuh intersect_leaf's instructions, with the determinant rounded
// as XLA rounds the JAX probe's, fma(e1z, pz, fma(e1x, px, e1y * py)).
//
// The probe is the floor that the MT walks' leaf pops are read against, so
// it has to run at the card's rate. One thread a lane reading a slot as 9
// scalar loads from global memory (the first port) reached 38.8% of its
// FP32 bound (NVIDIA H100 80GB HBM3, 700 W): 9 loads and their addresses a
// slot against 40 counted instructions, and one division chain a thread.
// Here the 64 rows' used 120 floats sit in shared memory (30 KB, staged
// once a block), a slot comes as three 16-byte loads that the threads of a
// warp read at two addresses (broadcasts), and kLeafSub threads share
// kLeafRays rays: thread q of a group tests slots q, q + kLeafSub, ... of
// every pop for each of its rays, so its five divisions a pop are
// independent and twice the threads are in flight. A lane's answer is the
// smallest valid t over every (pop, slot) it tests: each test is strict and
// NaN fails it, and its validity but for t < t_c does not depend on t_c,
// so the group's threads meet in a minimum. A lane's pops stay in order,
// each (lane, pop, slot) is tested once. That runs at 56.9% of the bound
// (0.1816 ms against 0.1033 for 128 pops x 33 copies of G = 16; the first
// port 0.2664), 58.6% on tools/torch_roofline.py's constant rays; one,
// two or four rays a thread, one or four threads a ray, 128 threads a
// block, the slots read from global memory and __frcp_rn were timed beside
// it (tools/torch_walk_variants.py --groups leaf-probe, PERF.md section 6).
// What is left is issue: the IEEE division (a reciprocal, its refinement
// and a slow-path check) counts as one of the slot's 40 instructions.
constexpr int kLeafSub = 2;
constexpr int kLeafRays = 1;
constexpr int kLeafThreads = 256;
constexpr int kLeafWords = kLeafSize * 3;  // 16-byte words a staged row

// One slot of the probe's body against t_c (the slot's 12 floats in s0,
// s1, s2, as bvh_walk.cuh mt_slot reads them).
__device__ __forceinline__ void leaf_probe_slot(const float4& s0,
                                                const float4& s1,
                                                const float4& s2,
                                                const bvh::Ray& r,
                                                float& t_c) {
  float p0x = s0.x, p0y = s0.y, p0z = s0.z;
  float e1x = s0.w, e1y = s1.x, e1z = s1.y;
  float e2x = s1.z, e2y = s1.w, e2z = s2.x;
  float px = __fmaf_rn(r.d[1], e2z, -(r.d[2] * e2y));
  float py = __fmaf_rn(r.d[2], e2x, -(r.d[0] * e2z));
  float pz = __fmaf_rn(r.d[0], e2y, -(r.d[1] * e2x));
  float det = __fmaf_rn(e1z, pz, __fmaf_rn(e1x, px, e1y * py));
  float idet = 1.0f / det;
  float tx = r.o[0] - p0x;
  float ty = r.o[1] - p0y;
  float tz = r.o[2] - p0z;
  float uu = __fmaf_rn(tz, pz, __fmaf_rn(tx, px, ty * py)) * idet;
  float qx = __fmaf_rn(ty, e1z, -(tz * e1y));
  float qy = __fmaf_rn(tz, e1x, -(tx * e1z));
  float qz = __fmaf_rn(tx, e1y, -(ty * e1x));
  float vv = __fmaf_rn(r.d[2], qz, __fmaf_rn(r.d[0], qx, r.d[1] * qy)) * idet;
  float tt = __fmaf_rn(e2z, qz, __fmaf_rn(e2x, qx, e2y * qy)) * idet;
  if (uu > 0.0f && uu < 1.0f && vv > 0.0f && uu + vv < 1.0f && tt > 0.0f &&
      tt < t_c)
    t_c = tt;
}

// A group of kLeafSub neighbouring lanes of a warp shares kLeafRays rays,
// ray group * kLeafRays + i in its slot i. The threads fill whole blocks
// (the last block's extra groups trace rays of the tile again and store
// nothing), so every warp is whole for the shuffles.
__global__ void __launch_bounds__(kLeafThreads)
leaf_mt_kernel(const float* __restrict__ rows, const float* __restrict__ o,
               const float* __restrict__ d, int lanes, int total, int iters,
               float* __restrict__ out) {
  __shared__ float4 srows[kRows * kLeafWords];
  for (int e = threadIdx.x; e < kRows * kLeafWords; e += blockDim.x)
    srows[e] = bvh::load4(rows + (e / kLeafWords) * bvh::kRow +
                          4 * (e % kLeafWords));
  __syncthreads();
  const int group = (blockIdx.x * blockDim.x + threadIdx.x) / kLeafSub;
  const int q = threadIdx.x % kLeafSub;
  bvh::Ray r[kLeafRays];
  float t_c[kLeafRays];
#pragma unroll
  for (int i = 0; i < kLeafRays; ++i) {
    r[i] = tile_ray(o, d, nullptr, lanes, (group * kLeafRays + i) % lanes);
    t_c[i] = 1e20f;
  }
  for (int it = 0; it < iters; ++it) {
    const float4* row = srows + (it % kRows) * kLeafWords;
#pragma unroll
    for (int j = 0; j < (kLeafSize + kLeafSub - 1) / kLeafSub; ++j) {
      const int k = q + j * kLeafSub;
      if (k < kLeafSize) {
        const float4 s0 = row[3 * k], s1 = row[3 * k + 1], s2 = row[3 * k + 2];
#pragma unroll
        for (int i = 0; i < kLeafRays; ++i)
          leaf_probe_slot(s0, s1, s2, r[i], t_c[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kLeafRays; ++i) {
#pragma unroll
    for (int off = 1; off < kLeafSub; off <<= 1) {
      const float other = __shfl_xor_sync(0xFFFFFFFFu, t_c[i], off);
      if (other < t_c[i]) t_c[i] = other;
    }
    if (q == 0 && group * kLeafRays + i < total)
      out[group * kLeafRays + i] = t_c[i];
  }
}

// The cluster pop's body: every slot's arithmetic term for term as the
// walks' (cluster_warp.cuh slot_t, bvh_walk.cuh dot_k3), then the winner's
// u, v recomputed (bvh_walk.cuh cluster_uv), on the two blocks of blk
// [16, 3 * tc] in turn. The JAX probe's one-hot capture matmul is exact: it
// gathers the winner's coefficients, which cluster_uv reads directly.
//
// kClusterSub threads share kClusterRays rays: thread q takes the groups of
// four neighbouring slots 4k..4k+3 with k = q, q + kClusterSub, ..., so the
// threads of a group read neighbouring 16-byte words and the groups of a
// warp the same ones (a broadcast). A group of slots is 21 16-byte loads
// from the block's copy in shared memory (7 rows x 3 thirds; row 7 is not
// read), for four slots and each of the thread's rays, whose divisions are
// independent. Each thread keeps its lowest slot among equal t (its slots
// ascend, the test is strict), and the threads of a group combine (t, slot)
// lexicographically. Timed against one, four and eight threads a ray, one
// ray a thread and 128 threads a block (PERF.md section 6).
constexpr int kClusterSub = 2;
constexpr int kClusterRays = 2;
constexpr int kClusterThreads = 256;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Component k of v; k is a constant once the loops that call it unroll.
__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Four slots' three-term sums fma(m2, x2, fma(m1, x1, m0 * x0)) (dot_k3)
// from the rows m[0..2] of one third, plus c, the folded constants of the
// origin terms, when `plus` is set.
__device__ __forceinline__ void dot4(const float4 (&m)[3], const float* x,
                                     const float4& c, bool plus,
                                     float (&out)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[k] = __fmaf_rn(at(m[2], k), x[2],
                       __fmaf_rn(at(m[1], k), x[1], at(m[0], k) * x[0]));
    if (plus) out[k] = out[k] + at(c, k);
  }
}

// One third's rows of four slots: m[a] = row a at slots j0..j0+3.
__device__ __forceinline__ void rows4(const float* p, int w, float4 (&m)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) m[a] = ld4(p + a * w);
}

// The smallest valid t of block `blk` for each of the thread's kClusterRays
// rays over the slots of thread q of the ray's group, then over the group's
// kClusterSub threads: (t, lowest slot at it) in every one of them;
// (+inf, 0) when no slot is valid, as the serial loop gives.
__device__ __forceinline__ void cluster_min_sub(
    const float* __restrict__ blk, int tc, const bvh::Ray (&r)[kClusterRays],
    int q, float (&best)[kClusterRays], int (&slot)[kClusterRays]) {
  const int w = 3 * tc;
  const float* wo = blk + 3 * w;
#pragma unroll
  for (int i = 0; i < kClusterRays; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    slot[i] = 0;
  }
  for (int j0 = 4 * q; j0 < tc; j0 += 4 * kClusterSub) {
    // md[t], mo[t]: third t's direction and origin rows; c[t] its constants.
    float4 md[3][3], mo[3][3], c[3];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      rows4(blk + t * tc + j0, w, md[t]);
      rows4(wo + t * tc + j0, w, mo[t]);
      c[t] = ld4(wo + 3 * w + t * tc + j0);
    }
#pragma unroll
    for (int i = 0; i < kClusterRays; ++i) {
      float dc[4], num[4], da[4], oa[4], db[4], ob[4];
      dot4(md[2], r[i].d, c[2], false, dc);
      dot4(mo[2], r[i].o, c[2], true, num);
      dot4(md[0], r[i].d, c[0], false, da);
      dot4(mo[0], r[i].o, c[0], true, oa);
      dot4(md[1], r[i].d, c[1], false, db);
      dot4(mo[1], r[i].o, c[1], true, ob);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float tt = num[k] / dc[k];
        const float uu = __fmaf_rn(tt, da[k], oa[k]);
        const float vv = __fmaf_rn(tt, db[k], ob[k]);
        if (uu > 0.0f && vv > 0.0f && uu + vv < 1.0f && tt > 0.0f &&
            tt < best[i]) {
          best[i] = tt;
          slot[i] = j0 + k;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kClusterRays; ++i) {
#pragma unroll
    for (int off = 1; off < kClusterSub; off <<= 1) {
      const float ot = __shfl_xor_sync(0xFFFFFFFFu, best[i], off);
      const int os = __shfl_xor_sync(0xFFFFFFFFu, slot[i], off);
      if (ot < best[i] || (ot == best[i] && os < slot[i])) {
        best[i] = ot;
        slot[i] = os;
      }
    }
  }
}

// Both blocks are staged in dynamic shared memory once a block (192 * tc
// bytes). A group of kClusterSub neighbouring lanes of a warp shares
// kClusterRays rays, ray group * kClusterRays + i in its slot i. The
// threads fill whole blocks (the last block's extra groups trace rays of
// the tile again and store nothing), so every warp is whole for the
// shuffles.
__global__ void __launch_bounds__(kClusterThreads)
cluster_kernel(const float* __restrict__ blk, const float* __restrict__ o,
               const float* __restrict__ d, int tc, int lanes, int total,
               int iters, int any_hit, float* __restrict__ out) {
  extern __shared__ float4 cluster_smem4[];
  float* sblk = reinterpret_cast<float*>(cluster_smem4);
  for (int e = threadIdx.x; e < 16 * 3 * tc; e += blockDim.x) sblk[e] = blk[e];
  __syncthreads();
  const int group = (blockIdx.x * blockDim.x + threadIdx.x) / kClusterSub;
  const int q = threadIdx.x % kClusterSub;
  bvh::Ray r[kClusterRays];
  float t_state[kClusterRays];
#pragma unroll
  for (int i = 0; i < kClusterRays; ++i) {
    r[i] = tile_ray(o, d, nullptr, lanes, (group * kClusterRays + i) % lanes);
    t_state[i] = 1e20f;
  }
  for (int it = 0; it < iters; ++it) {
    const float* block = sblk + (size_t)(it % 2) * 8 * 3 * tc;
    float tmin[kClusterRays];
    int slot[kClusterRays];
    cluster_min_sub(block, tc, r, q, tmin, slot);
#pragma unroll
    for (int i = 0; i < kClusterRays; ++i) {
      const bool improved = tmin[i] < t_state[i];
      if (any_hit) {
        t_state[i] = improved ? tmin[i] * 0.999f : t_state[i];
      } else {
        float u, v;
        bvh::cluster_uv(block, tc, slot[i], r[i], tmin[i], u, v);
        // tmin * 0.999 + u * 1e-9 + v * 1e-9 as XLA contracts it.
        const float res =
            __fmaf_rn(v, 1e-9f, __fmaf_rn(tmin[i], 0.999f, u * 1e-9f));
        t_state[i] = improved ? res : t_state[i];
      }
    }
  }
  if (q == 0) {
#pragma unroll
    for (int i = 0; i < kClusterRays; ++i)
      if (group * kClusterRays + i < total)
        out[group * kClusterRays + i] = t_state[i];
  }
}

int blocks_for(long long total) {
  return (int)((total + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface for ctypes. Each returns cudaGetLastError() after its
// launch (0 = launched, -1 = arguments no kernel takes); the caller checks
// it. Ray tiles are [3, g, 128], outputs [copies, *tile].
extern "C" {

int gpt_roofline_vpu(const float* x, int rows, int iters, int ilp, int copies,
                     float* out, void* stream) {
  int per = rows * kLanes, total = per * copies;
  cudaStream_t s = (cudaStream_t)stream;
  if (ilp == 1)
    vpu_kernel<1><<<blocks_for(total), kThreads, 0, s>>>(x, per, total, iters,
                                                         out);
  else if (ilp == 8)
    vpu_kernel<8><<<blocks_for(total), kThreads, 0, s>>>(x, per, total, iters,
                                                         out);
  else
    return -1;
  return (int)cudaGetLastError();
}

int gpt_roofline_mxu(int bf16, const void* a, const void* b, int m, int k,
                     int n, int iters, int copies, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bf16) {
    if (m % kBand || k % 16 || n % 8) return -1;
    const Bf16Plan p = bf16_plan(k, n);
    if (p.smem > (size_t)smem_max) return -1;
    auto kernel = p.nw == 8     ? mxu_wgmma_kernel<8, false>
                  : p.nw == 64  ? mxu_wgmma_kernel<64, false>
                  : p.nw == 128 ? mxu_wgmma_kernel<128, false>
                                : mxu_wgmma_kernel<136, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(m / kBand) * p.slabs * copies, kWgThreads, p.smem, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, m, k, n, iters,
        p.slabs, p.slots, out);
    return (int)cudaGetLastError();
  }
  const MxuPlan p = mxu_f32_plan(m, k, n, (size_t)smem_max);
  if (p.nt == 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      mxu_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  mxu_f32_kernel<<<p.bands * p.col_tiles * copies, p.nt * p.mt, p.smem, s>>>(
      (const float*)a, (const float*)b, m, k, n, iters, p.nt, p.mt,
      p.col_tiles, p.bands, out);
  return (int)cudaGetLastError();
}

int gpt_roofline_node_slab(const float* rows, const float* o,
                           const float* inv, int g, int iters, int copies,
                           float* out, void* stream) {
  const int lanes = g * kLanes, total = lanes * copies;
  const long long threads = (long long)(total + kNodeRays - 1) / kNodeRays;
  node_slab_kernel<<<(int)((threads + kNodeThreads - 1) / kNodeThreads),
                     kNodeThreads, 0, (cudaStream_t)stream>>>(
      rows, o, inv, lanes, total, iters, out);
  return (int)cudaGetLastError();
}

int gpt_roofline_leaf_mt(const float* rows, const float* o, const float* d,
                         int g, int iters, int copies, float* out,
                         void* stream) {
  const int lanes = g * kLanes, total = lanes * copies;
  const long long threads =
      (long long)(total + kLeafRays - 1) / kLeafRays * kLeafSub;
  leaf_mt_kernel<<<(int)((threads + kLeafThreads - 1) / kLeafThreads),
                   kLeafThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, lanes, total, iters, out);
  return (int)cudaGetLastError();
}

int gpt_roofline_cluster(const float* blk, const float* o, const float* d,
                         const float* inv, int tc, int g, int iters,
                         int any_hit, int copies, float* out, void* stream) {
  (void)inv;  // unused, as in the JAX probe
  if (tc < 4 || tc % 4) return -1;
  const int smem = 16 * 3 * tc * (int)sizeof(float);
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > smem_max) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int lanes = g * kLanes, total = lanes * copies;
  const long long threads =
      (long long)(total + kClusterRays - 1) / kClusterRays * kClusterSub;
  cluster_kernel<<<(int)((threads + kClusterThreads - 1) / kClusterThreads),
                   kClusterThreads, smem, (cudaStream_t)stream>>>(
      blk, o, d, tc, lanes, total, iters, any_hit, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
