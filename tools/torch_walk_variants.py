#!/usr/bin/env python3
"""Design variants of the port's walks, timed on the card against the
tree's own kernels (the experiments behind PERF.md section 6).

    python3 tools/torch_walk_variants.py [--variants a,b] [--reps 2]
        [--checkout NAME=DIR]
        [--groups walks,mega,mega-rows,mega-profile,subpacket,dense,
                  cluster-probe,ilv,bf16-probe,multi,leaf-probe,node-probe]

Each variant is the tree's csrc/ with a few text edits (VARIANTS), built
with ops/cuda_build.py's nvcc flags into _build/variants/<name>/ and
swapped into the wrappers in turn; --checkout NAME=DIR adds the variant
NAME, the csrc/ of another checkout (DIR is its root, for example a `git
archive` of the parent commit as "parent") built as it is, so that a
redesign is timed beside the design it replaces in one call. A variant
runs through the tree's wrappers, so its C interfaces must be the tree's;
a checkout runs through its own ops/ wrapper in the walks, dense, ilv and
multi groups (its C interface may differ). Groups of timings
(--groups):

  walks         on chip_smoke.py phase 3's rays (131,072 a scene, sponza
                1920x1080 and bathroom 1280x720): B1 closest and any-hit at
                64 and 128 threads a block, B4 closest and any-hit on the
                scenes' cluster tables (tc 128);
  mega          bathroom 256x144, 64 bounces, 4 spp (phase 8's
                regenerating case): the MT and the cluster megakernel;
  mega-rows     phase 10's MT rows (bathroom 1280x720 frame batch 64,
                table 800x600 64 bounces frame batch 128, table direct
                frame batch 8): the first chunk's kernel time a launch, and
                seconds a sample through the CLI over ROW_FRAMES frames;
  mega-profile  tools/torch_mega_profile.py --time: ns a pop;
  subpacket     B6 at K = 128, 256 and 2048 on phase 3's rays and on the
                A/B tool's 2^19 incoherent rays, closest and any-hit;
  dense         B5 on bathroom: phase 3's 131,072 rays and the A/B tool's
                2^19 incoherent rays (t_max 1e20, all active), closest and
                any-hit, both roundings; and sponza's first 8,192 of phase
                3's rays (chip_smoke.py's dense check), closest and any-hit;
  cluster-probe B9e at run_compact's G and copies (tools/torch_roofline.py),
                tc 128 closest and any-hit and tc 256, PROBE_ITERS pops;
  ilv           B7 at W = 2 and 4, closest and any-hit, on phase 3's rays of
                sponza and bathroom and on sponza's 2^19 incoherent rays
                (the A/B tool's, all active), B1 on the same rays beside it;
  bf16-probe    the bf16 product (B9b) at run_compact's two shapes, 128^3
                and 512^3, and copies, PROBE_ITERS iterations, torch.matmul
                on the same work (bf16 in, bf16 out) beside it;
  multi         B8 at Q = 2 and 4, closest and any-hit, on phase 3's rays of
                sponza and bathroom and on sponza's 2^19 incoherent rays,
                B1 on the same rays beside it (its redesigns are the
                multi-* variants);
  leaf-probe    B9d at chip_smoke.py phase R's case and at
                tools/torch_roofline.py run_phase_floors' case (its
                redesigns are the leaf-* variants);
  node-probe    B9c at the same two cases, each build's SASS loop by
                opcode (its design variants are the node-* variants).

Every variant runs beside the tree's build, in turns, and its outputs must
be bitwise the tree's (B6: t and occlusion, which its visit order does not
change, bitwise the per-ray kernel's; B5 and B9e: the tree's also bitwise
its plain version's, B9e's in every copy; B7: its hits and counts bitwise
B1's; B8: results and counts bitwise the tree's, t and occluded B1's where
no push was dropped; B9d and B9c: every copy bitwise its plain version,
also on the edge rows of tests/test_torch_kernel.py; the bf16
product: every copy equal and within chip_smoke.py's bound of its plain
version). Prints the ptxas line of each
kernel a variant changes. Needs the card and nvcc; nothing here imports
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_ORDER = """  if (ordered && total == 2) {
    order_two<kKeys>(hits, key, entry, skey);
  } else if (ordered && total > 2) {
    sort_children<kKeys>(key, slot, entry, skey);
  }
  if (ordered && total > 1) {"""
_WALK = """  int sp = root != kInvalid ? 1 : 0;
  stack[0] = root;
  while (sp > 0) {
    const int entry = stack[--sp * stride];
    if (entry >= 0) {
      if constexpr (kStats) ++pops->node;
      expand_node(rows + (size_t)entry * kRow, r, t, !kAnyHit, stack, stride,
                  sp, depth);"""
_HELD_WALK = """  int sp = 0, next = root;  // the start entry, held
  while (next != kInvalid || sp > 0) {
    const int entry = next != kInvalid ? next : stack[--sp * stride];
    next = kInvalid;
    if (entry >= 0) {
      if constexpr (kStats) ++pops->node;
      expand_node(rows + (size_t)entry * kRow, r, t, !kAnyHit, stack, stride,
                  sp, depth, nullptr, &next);"""

_MEGA_BOUNDS = "__launch_bounds__(kThreads) mega_kernel(MegaArgs g) {"
_MEGA_LAUNCH = """  mega_kernel<kModel, kNee, kRegen, kCluster, kStats>
      <<<blocks, kThreads, 0, stream>>>(args);"""
# The lane pick-up: the kernel's body becomes a lane's routine, and the
# kernel runs lanes until none is left, taking tickets from a counter that
# the launch zeroes; it launches as many blocks as stay resident.
_PICKUP = [
    ("""__global__ void __launch_bounds__(kThreads) mega_kernel(MegaArgs g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < g.n;
  unsigned int n_rays = 0;
  LaneStats ls;""", """__device__ __forceinline__ void mega_lane(const MegaArgs& g, const int i,
                                          unsigned int& n_rays) {
  const bool in = i < g.n;
  LaneStats ls;"""),
    ("""      atomicMax(row + 8, ls.ctr[0]);
    }
  }

  // Ray count""", """      atomicMax(row + 8, ls.ctr[0]);
    }
  }
}

__device__ unsigned long long mega_tickets;

template <int kModel, bool kNee, bool kRegen, bool kCluster,
          bool kStats = false>
__global__ void __launch_bounds__(kThreads) mega_kernel(MegaArgs g, int threads) {
  unsigned int n_rays = 0;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (;;) {
    mega_lane<kModel, kNee, kRegen, kCluster, kStats>(g, i, n_rays);
    if (kCluster) break;
    i = threads + (int)atomicAdd(&mega_tickets, 1ull);
    if (i >= g.n) break;
  }

  // Ray count"""),
    (_MEGA_LAUNCH, """  auto kernel = mega_kernel<kModel, kNee, kRegen, kCluster, kStats>;
  if (!kCluster) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    blocks = min(blocks, max(per_sm, 1) * sms);
  }
  void* tickets = nullptr;
  cudaGetSymbolAddress(&tickets, mega_tickets);
  cudaMemsetAsync(tickets, 0, sizeof(unsigned long long), stream);
  kernel<<<blocks, kThreads, 0, stream>>>(args, blocks * kThreads);""")]
# The interleave (B7) redesigns timed against the tree's B7 (PERF.md
# section 6), which they did not beat on phase 3's rays: kernels added
# before the multi-pop schedule's and launched by the tree's C functions
# (same interface; the ray counter is a __device__ int). Two loops:
# "fetch" runs bvh::walk_ilv as the tree does and, when all of a thread's
# walks have ended, takes W neighbouring rays from the counter; "slots"
# (the tree's walk step in a loop of its own) hands a slot whose walk
# ended the next ray at once, after one warp vote an iteration. Both
# launch as many blocks as stay resident (with refill); "slots" may keep
# its stacks in dynamic shared memory, [w][depth][blockDim], the block
# halved until they fit.
_ILV_ANCHOR = "// `depth` is the stack bound times Q."
_ILV_KERNELS = r"""constexpr int kIlvThreads = @THREADS@;
constexpr bool kIlvRefill = @REFILL@;
constexpr bool kIlvShared = @SHARED@;
constexpr bool kIlvOuter = @OUTER@;
__device__ int ilv_next;  // rays handed out, zeroed by each launch

struct IlvOut {
  float* t;
  int* prim;
  float* u;
  float* v;
  uint8_t* occluded;
  int* stats;
};

// `span` threads hold the first W * span rays (slot w of thread j: ray
// w * span + j); with kIlvRefill, ray W * span + c goes to the c-th free
// slot, c counted by *next (zero at launch).
template <int W, bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kMaxThreads)
trace_ilv_kernel(const float* __restrict__ rows, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ t_max,
                 const uint8_t* __restrict__ active, int n, int depth,
                 int span, int* __restrict__ next, IlvOut out) {
  extern __shared__ int ilv_stack[];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = blockDim.x;
  int ray[W], sp[W];
  bvh::Ray r[W];
  float t[W];
  bvh::MtLeaf<kAnyHit> leaf[W];
  bvh::Pops pops[W];
  int* stack[W];
  int local[kIlvShared ? 1 : W][kIlvShared ? 1 : bvh::kMaxStack];
  const int step = kIlvShared ? stride : 1;  // between a stack's entries
#pragma unroll
  for (int w = 0; w < W; ++w) {
    stack[w] = kIlvShared ? ilv_stack + w * depth * stride + threadIdx.x
                          : local[w];
    sp[w] = 0;
    ray[w] = -1;
  }
  // Slot w starts ray i: its root on the stack if the ray is active.
  auto begin = [&](int w, int i) {
    ray[w] = i;
    r[w] = bvh::load_ray(o, d, i);
    t[w] = t_max[i];
    leaf[w] = bvh::MtLeaf<kAnyHit>(rows);
    pops[w] = bvh::Pops();
    stack[w][0] = 0;  // root node row
    sp[w] = active[i] ? 1 : 0;
  };
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int i = w * span + j;
    if (j < span && i < n) begin(w, i);
  }
  bool more = kIlvRefill;  // rays may be left to take
  // The results of slot w's walk, by its ray's index.
  auto retire = [&](int w) {
    const int i = ray[w];
    if constexpr (kAnyHit) {
      out.occluded[i] = leaf[w].prim >= 0 ? 1 : 0;
    } else {
      out.t[i] = t[w];
      out.prim[i] = leaf[w].prim;
      out.u[i] = leaf[w].u;
      out.v[i] = leaf[w].v;
    }
    store_pops<kStats>(out.stats, 2, i, pops[w]);
    ray[w] = -1;
  };
  for (;;) {
    // A slot has work here if its walk ended or it may take a ray; the
    // warp skips the pass when no lane's slot has.
    bool todo = false;
#pragma unroll
    for (int w = 0; w < W; ++w) todo |= sp[w] == 0 && (ray[w] >= 0 || more);
    const bool pass = __any_sync(__activemask(), todo);
    bool held = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (pass && ray[w] >= 0 && sp[w] == 0) retire(w);
      if (pass && kIlvRefill && more) {
        const bool want = ray[w] < 0;
        const unsigned live = __activemask();
        const unsigned asks = __ballot_sync(live, want);
        if (asks) {
          const int lane = threadIdx.x % 32, lead = __ffs(asks) - 1;
          int base = 0;
          if (lane == lead) base = atomicAdd(next, __popc(asks));
          base = __shfl_sync(live, base, lead);
          if (want) {
            const int i =
                W * span + base + __popc(asks & ((1u << lane) - 1u));
            if (i < n)
              begin(w, i);
            else
              more = false;
          }
        }
      }
      held |= ray[w] >= 0;
    }
    if (!held) return;
    int entry[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      entry[w] = bvh::kInvalid;
      if (sp[w] > 0) {
        entry[w] = stack[w][--sp[w] * step];
        bvh::prefetch_entry(rows, entry[w]);
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int e = entry[w];
      if (e == bvh::kInvalid) continue;
      if (e >= 0) {
        if constexpr (kStats) ++pops[w].node;
        bvh::expand_node(rows + (size_t)e * bvh::kRow, r[w], t[w], !kAnyHit,
                         stack[w], step, sp[w], depth);
      } else {
        if constexpr (kStats) ++pops[w].leaf;
        if (leaf[w](-(e + 1), r[w], t[w]) && kAnyHit) sp[w] = 0;
      }
    }
  }
}

// The interleave as bvh::walk_ilv runs it (W walks in flight, each on a
// stack in local memory), inside a loop that fetches rays: slot w of
// thread j first walks ray w * span + j; when all its walks have ended the
// thread writes their results and, with kIlvRefill, takes W neighbouring
// rays from the counter (one atomicAdd for the lanes of the warp that are
// there), until none is left.
template <int W, bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kMaxThreads)
trace_ilv_fetch_kernel(const float* __restrict__ rows,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ t_max,
                       const uint8_t* __restrict__ active, int n, int depth,
                       int span, int* __restrict__ next, IlvOut out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  int base = j, gap = span;  // slot w walks ray base + w * gap
  bool own = j < span;
  for (;;) {
    int ray[W];
    bool on[W];
    bvh::Ray r[W];
    float t[W];
    bvh::MtLeaf<kAnyHit> leaf[W];
    bvh::Pops pops[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      int i = base + w * gap;
      const bool in = own && i < n;
      ray[w] = in ? i : -1;
      on[w] = in && active[i];
      i = in ? i : 0;
      t[w] = t_max[i];
      r[w] = bvh::load_ray(o, d, i);
      leaf[w].rows = rows;
    }
    const int root[W] = {};  // the variants walk from row 0
    bvh::walk_ilv<W, kAnyHit, bvh::MtLeaf<kAnyHit>, kStats>(rows, r, on, root,
                                                            depth, t, leaf,
                                                            pops);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int i = ray[w];
      if (i < 0) continue;
      if constexpr (kAnyHit) {
        out.occluded[i] = leaf[w].prim >= 0 ? 1 : 0;
      } else {
        out.t[i] = t[w];
        out.prim[i] = leaf[w].prim;
        out.u[i] = leaf[w].u;
        out.v[i] = leaf[w].v;
      }
      store_pops<kStats>(out.stats, 2, i, pops[w]);
    }
    if (!kIlvRefill) return;
    const unsigned live = __activemask();
    const int lane = threadIdx.x % 32, lead = __ffs(live) - 1;
    int got = 0;
    if (lane == lead) got = atomicAdd(next, W * __popc(live));
    base = W * span + __shfl_sync(live, got, lead) +
           W * __popc(live & ((1u << lane) - 1u));
    if (base >= n) return;
    gap = 1;
    own = true;
  }
}

// Launches an interleave kernel, w = 2 or 4 rays a thread; the rays it
// hands out are counted in ilv_next, zeroed here on the launch's stream.
template <bool kAnyHit>
int launch_ilv(const float* rows, const float* o, const float* d,
               const float* t_max, const uint8_t* active, int n, int depth,
               int w, IlvOut out, cudaStream_t stream) {
  const bool stats = out.stats != nullptr;
  auto kernel =
      kIlvOuter
          ? (w == 2 ? (stats ? trace_ilv_fetch_kernel<2, kAnyHit, true>
                             : trace_ilv_fetch_kernel<2, kAnyHit, false>)
             : w == 4 ? (stats ? trace_ilv_fetch_kernel<4, kAnyHit, true>
                               : trace_ilv_fetch_kernel<4, kAnyHit, false>)
                      : nullptr)
          : (w == 2 ? (stats ? trace_ilv_kernel<2, kAnyHit, true>
                             : trace_ilv_kernel<2, kAnyHit, false>)
             : w == 4 ? (stats ? trace_ilv_kernel<4, kAnyHit, true>
                               : trace_ilv_kernel<4, kAnyHit, false>)
                      : nullptr);
  if (!kernel) return -1;
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int threads = kIlvThreads;
  auto smem = [&] {
    return kIlvShared && !kIlvOuter ? (size_t)w * depth * threads * sizeof(int)
                                    : 0;
  };
  while (smem() > (size_t)smem_max && threads > 32) threads /= 2;
  if (smem() > (size_t)smem_max) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem());
  if (err != cudaSuccess) return (int)err;
  const int per_thread = (n + w - 1) / w;
  int blocks = (per_thread + threads - 1) / threads;
  if (kIlvRefill) {
    int resident = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        threads, smem());
    if (err != cudaSuccess) return (int)err;
    blocks = min(blocks, max(resident, 1) * sms);
  }
  const int span = min(blocks * threads, per_thread);
  int* next = nullptr;
  cudaGetSymbolAddress((void**)&next, ilv_next);
  err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem(), stream>>>(rows, o, d, t_max, active, n,
                                              depth, span, next, out);
  return (int)cudaGetLastError();
}

"""
_ILV_LAUNCHES = [
    ("""  kernel<<<blocks_for((n + w - 1) / w), kThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, t_max, active, n, depth, t, prim, u, v, stats, roots,
      packet);""",
     """  return launch_ilv<false>(rows, o, d, t_max, active, n, depth, w,
                           IlvOut{t, prim, u, v, nullptr, stats},
                           (cudaStream_t)stream);"""),
    ("""  kernel<<<blocks_for((n + w - 1) / w), kThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, t_max, active, n, depth, occluded, stats, roots, packet);""",
     """  return launch_ilv<true>(rows, o, d, t_max, active, n, depth, w,
                          IlvOut{nullptr, nullptr, nullptr, nullptr, occluded,
                                 stats},
                          (cudaStream_t)stream);""")]


# The multi-pop (B8) redesigns timed against the tree's B8 (PERF.md section
# 6), which none beat on phase 3's rays: node expansion made generic over
# the stack it pushes to (expand_row), a block appended to bvh_walk.cuh
# (walk_multi_split: the stack split between shared memory and a local
# array, SplitStack; with kWin > 0 the popped rows' 224-byte heads loaded
# into registers kWin at a time, each pop's registers taking the next head
# as it is done, and a leaf's first slots tested from its head), and the
# multi-pop kernels of traverse.cu launched with it (same C interface).
_EXPAND_HEAD = """template <bool kKeys = false>
__device__ __forceinline__ int expand_node(const float* __restrict__ row,
                                           const Ray& r, float t,
                                           bool ordered, int* stack,
                                           int stride, int& sp, int depth,
                                           float* keys = nullptr) {
  NodeRow n;
  load_node(row, n);
  float key[kArity], skey[kKeys ? kArity : 1];"""
_EXPAND_ROW = """template <bool kKeys = false, class Stack>
__device__ __forceinline__ int expand_row(const NodeRow& n, const Ray& r,
                                          float t, bool ordered, Stack& stack,
                                          int& sp, int depth,
                                          float* keys = nullptr) {
  float key[kArity], skey[kKeys ? kArity : 1];"""
_EXPAND_TAIL = """  sp = min(sp + total, depth);
  return dropped;
}
"""
_EXPAND_NODE = _EXPAND_TAIL + """
// A stack as expand_row pushes to it: entry p at p[p * stride].
struct StridedStack {
  int* p;
  int stride;
  __device__ __forceinline__ int get(int i) const { return p[i * stride]; }
  __device__ __forceinline__ void set(int i, int v) const {
    p[i * stride] = v;
  }
};

template <bool kKeys = false>
__device__ __forceinline__ int expand_node(const float* __restrict__ row,
                                           const Ray& r, float t,
                                           bool ordered, int* stack,
                                           int stride, int& sp, int depth,
                                           float* keys = nullptr) {
  NodeRow n;
  load_node(row, n);
  StridedStack st{stack, stride};
  return expand_row<kKeys>(n, r, t, ordered, st, sp, depth, keys);
}
"""
_MULTI_SPLIT = """// A row's first 224 bytes as fourteen 16-byte words: a node row's boxes
// and entries, or a leaf's slots 0-3.
constexpr int kHeadWords = 14;
constexpr int kHeadSlots = 4;

__device__ __forceinline__ void unpack_node(const float4 (&v)[kHeadWords],
                                            NodeRow& n) {
#pragma unroll
  for (int q = 0; q < 12; ++q) {
    n.b[4 * q] = v[q].x;
    n.b[4 * q + 1] = v[q].y;
    n.b[4 * q + 2] = v[q].z;
    n.b[4 * q + 3] = v[q].w;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    n.e[4 * q] = __float_as_int(v[12 + q].x);
    n.e[4 * q + 1] = __float_as_int(v[12 + q].y);
    n.e[4 * q + 2] = __float_as_int(v[12 + q].z);
    n.e[4 * q + 3] = __float_as_int(v[12 + q].w);
  }
}

// Entries below kLow in shared memory at low[p * stride] ([kLow][blockDim]
// a block), the deeper ones in a local array (kLow = 0: all local).
template <int kLow>
struct SplitStack {
  int* low;
  int stride;
  int high[kMaxStack > kLow ? kMaxStack - kLow : 1];
  __device__ __forceinline__ int get(int i) const {
    if constexpr (kLow == 0) return high[i];
    return i < kLow ? low[i * stride] : high[i - kLow];
  }
  __device__ __forceinline__ void set(int i, int v) {
    if constexpr (kLow == 0) {
      high[i] = v;
    } else if (i < kLow) {
      low[i * stride] = v;
    } else {
      high[i - kLow] = v;
    }
  }
};

// The head of a popped entry's row: all fourteen words of a node row, the
// words of a leaf's first min(count, kHeadSlots) slots, none for kInvalid.
__device__ __forceinline__ void load_head(const float* __restrict__ rows,
                                          int entry,
                                          float4 (&h)[kHeadWords]) {
  int row = entry, words = entry == kInvalid ? 0 : kHeadWords;
  if (entry < 0) {
    const int packed = -(entry + 1);
    row = packed >> 4;
    words = 3 * min(packed & 15, kHeadSlots);
  }
  const float* p = rows + (size_t)(words ? row : 0) * kRow;
#pragma unroll
  for (int k = 0; k < kHeadWords; ++k)
    if (k < words) h[k] = load4(p + 4 * k);
}

// MtLeaf's leaf routine with the leaf's first slots in h: the same slots
// in the same order, the rest read from the table.
template <bool kAnyHit>
__device__ __forceinline__ bool leaf_head(MtLeaf<kAnyHit>& leaf, int packed,
                                          const Ray& r, float& t,
                                          const float4 (&h)[kHeadWords]) {
  const float* block = leaf.rows + (size_t)(packed >> 4) * kRow;
  const int count = packed & 15;
  for (int k = 0; k < count; ++k) {
    const float* s = block + (k / kTrisPerRow) * kRow + (k % kTrisPerRow) * 12;
    float4 s0, s1, s2;
    if (k < kHeadSlots) {
#pragma unroll
      for (int j = 0; j < kHeadSlots; ++j) {
        if (j == k) {
          s0 = h[3 * j];
          s1 = h[3 * j + 1];
          s2 = h[3 * j + 2];
        }
      }
    } else {
      s0 = load4(s);
      s1 = load4(s + 4);
      s2 = load4(s + 8);
    }
    float tt, uu, vv;
    if (mt_slot(s0, s1, s2, r, t, tt, uu, vv)) {
      t = tt;
      leaf.prim = __float_as_int(s2.y);
      leaf.u = uu;
      leaf.v = vv;
      leaf.slot = s;
      if (kAnyHit) break;
    }
  }
  return leaf.prim >= 0;
}

// walk_multi's schedule on a SplitStack. Node expansions read t_entry and
// only push; leaves read and write t and never touch the stack; so with
// kWin > 0 the pops run in pop order as their heads arrive (an any-hit
// walk that hits still expands the iteration's remaining nodes, for the
// counts), and with kWin = 0 as walk_multi runs them.
template <int Q, bool kAnyHit, bool kStats, int kWin, class Stack>
__device__ __forceinline__ int walk_multi_split(
    const float* __restrict__ rows, const Ray& r, int depth, float& t,
    MtLeaf<kAnyHit>& leaf, Pops* pops, Stack& stack) {
  int sp = 1, dropped = 0;
  stack.set(0, 0);  // root node row
  while (sp > 0) {
    int entry[Q];
    int n = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (sp > 0) {
        entry[q] = stack.get(--sp);
        if constexpr (kWin == 0) prefetch_entry(rows, entry[q]);
        n = q + 1;
      }
    }
    const float t_entry = t;
    if constexpr (kWin == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (q < n && entry[q] >= 0) {
          if constexpr (kStats) ++pops->node;
          NodeRow nr;
          load_node(rows + (size_t)entry[q] * kRow, nr);
          dropped += expand_row(nr, r, t_entry, !kAnyHit, stack, sp, depth);
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (q < n && entry[q] < 0) {
          if constexpr (kStats) ++pops->leaf;
          if (leaf(-(entry[q] + 1), r, t) && kAnyHit) return dropped;
        }
      }
    } else {
      float4 h[kWin][kHeadWords];
#pragma unroll
      for (int q = 0; q < kWin; ++q)
        load_head(rows, q < n ? entry[q] : kInvalid, h[q]);
      bool hit = false;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int e = q < n ? entry[q] : kInvalid;
        if (e >= 0 && e != kInvalid) {
          if constexpr (kStats) ++pops->node;
          NodeRow nr;
          unpack_node(h[q % kWin], nr);
          dropped += expand_row(nr, r, t_entry, !kAnyHit, stack, sp, depth);
        } else if (e < 0 && !hit) {
          if constexpr (kStats) ++pops->leaf;
          hit = leaf_head(leaf, -(e + 1), r, t, h[q % kWin]) && kAnyHit;
        }
        if (q + kWin < Q)
          load_head(rows, q + kWin < n ? entry[q + kWin] : kInvalid,
                    h[q % kWin]);
      }
      if (hit) return dropped;
    }
  }
  return dropped;
}

}  // namespace bvh"""
_MULTI_KNOBS = """constexpr int kMinBlocks = 4;
constexpr int kMultiSharedDepth = @SHARED@;
constexpr int kMultiThreads = @THREADS@;
constexpr int kMultiMinBlocks = @MIN_BLOCKS@;
constexpr int kMultiWindow = @WINDOW@;
"""
_MULTI_WALK = """// `depth` is the stack bound times Q.
template <int Q, bool kAnyHit, bool kStats>
__device__ __forceinline__ int multi_walk(const float* __restrict__ rows,
                                          const float* __restrict__ o,
                                          const float* __restrict__ d, int i,
                                          int depth, float& t,
                                          bvh::MtLeaf<kAnyHit>& leaf,
                                          bvh::Pops* pops) {
  extern __shared__ int multi_stack[];
  bvh::SplitStack<kMultiSharedDepth> stack;
  stack.low = multi_stack + threadIdx.x;
  stack.stride = blockDim.x;
  return bvh::walk_multi_split<Q, kAnyHit, kStats,
                               (kMultiWindow < Q ? kMultiWindow : Q)>(
      rows, bvh::load_ray(o, d, i), depth, t, leaf, pops, stack);
}
"""
_MULTI_LAUNCH = """// Launches one of B8's kernels with the shared part of its stacks.
template <class... Params, class... Args>
int launch_multi(void (*kernel)(Params...), int n, int depth,
                 cudaStream_t stream, Args... args) {
  return launch_b1(kernel, n, min(depth, kMultiSharedDepth), kMultiThreads,
                   stream, args...);
}

}  // namespace
"""


def _multi(shared: int, threads: int, min_blocks: int, window: int) -> dict:
    """The edits of csrc/bvh_walk.cuh and csrc/traverse.cu that make one B8
    redesign: its stack's first `shared` entries in shared memory, `threads`
    a block, __launch_bounds__(threads, min_blocks), `window` popped rows'
    heads in registers."""
    knobs = _MULTI_KNOBS
    for key, value in (("@SHARED@", shared), ("@THREADS@", threads),
                       ("@MIN_BLOCKS@", min_blocks), ("@WINDOW@", window)):
        knobs = knobs.replace(key, str(value))
    walk = []
    for q in ("false", "true"):
        walk.append((f"""    dropped = bvh::walk_multi<Q, {q}, bvh::MtLeaf<{q}>, kStats>(
        rows, bvh::load_ray(o, d, i), depth, t, leaf, &pops,
        root_of(roots, packet, i));""",
                     f"""    dropped = multi_walk<Q, {q}, kStats>(rows, o, d, i, depth, t, leaf,
                                         &pops);"""))
    return {
        "bvh_walk.cuh": [
            (_EXPAND_HEAD, _EXPAND_ROW),
            ("        stack[pos * stride] = entry[k];",
             "        stack.set(pos, entry[k]);"),
            ("        stack[pos * stride] = entry[j];",
             "        stack.set(pos, entry[j]);"),
            (_EXPAND_TAIL, _EXPAND_NODE),
            ("}  // namespace bvh", _MULTI_SPLIT)],
        "traverse.cu": [
            ("constexpr int kMinBlocks = 4;\n", knobs),
            ("// `depth` is the stack bound times Q.\n", _MULTI_WALK),
            ("__launch_bounds__(kThreads)\ntrace_closest_multi_kernel(",
             "__launch_bounds__(kMultiThreads, kMultiMinBlocks)\n"
             "trace_closest_multi_kernel("),
            ("__launch_bounds__(kThreads)\ntrace_anyhit_multi_kernel(",
             "__launch_bounds__(kMultiThreads, kMultiMinBlocks)\n"
             "trace_anyhit_multi_kernel("),
            *walk,
            ("}  // namespace\n", _MULTI_LAUNCH),
            ("""  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, t_max, active, n, depth, t, prim, u, v, stats, roots,
      packet);
  return (int)cudaGetLastError();""",
             """  return launch_multi(kernel, n, depth, (cudaStream_t)stream, rows, o, d,
                      t_max, active, n, depth, t, prim, u, v, stats, roots,
                      packet);"""),
            ("""  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      rows, o, d, t_max, active, n, depth, occluded, stats, roots, packet);
  return (int)cudaGetLastError();""",
             """  return launch_multi(kernel, n, depth, (cudaStream_t)stream, rows, o, d,
                      t_max, active, n, depth, occluded, stats, roots,
                      packet);""")]}


def _ilv(fetch: bool, refill: bool = True, shared: bool = False,
         threads: int = 128) -> dict:
    """The edits of csrc/traverse.cu that make one interleave redesign."""
    code = _ILV_KERNELS
    for key, value in (("@THREADS@", str(threads)), ("@OUTER@", fetch),
                       ("@REFILL@", refill), ("@SHARED@", shared)):
        code = code.replace(key, str(value).lower())
    return {"traverse.cu": [(_ILV_ANCHOR, code + _ILV_ANCHOR)] +
            _ILV_LAUNCHES}


def _leaf(old: str, new: str) -> dict:
    """One edit of B9d's (or B9c's) kernel in csrc/roofline.cu."""
    return {"roofline.cu": [(old, new)]}


# B9c with two threads a lane: thread q of a pair tests children 4q .. 4q + 3
# and both add the pair's eight terms in child order.
_NODE_SUB_2 = {"roofline.cu": [
    ("void node_pop(const float4* w,\n",
     "void node_pop(const float4* w, int q, int lead,\n"),
    ("""  float b[bvh::kArity / 2][12];
#pragma unroll
  for (int p = 0; p < bvh::kArity / 2; ++p) node_pair(w, p, b[p]);""",
     """  float b[2][12];
#pragma unroll
  for (int p = 0; p < 2; ++p) node_pair(w, 2 * q + p, b[p]);"""),
    ("""#pragma unroll
    for (int j = 0; j < bvh::kArity; ++j) {
      float tmin;
      if (bvh::slab_test(b[j / 2] + 6 * (j % 2), r[k], t_cur, tmin))
        acc[k] = acc[k] + tmin;
    }""",
     """    float term[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float tmin;
      const bool hit =
          bvh::slab_test(b[c / 2] + 6 * (c % 2), r[k], t_cur, tmin);
      term[c] = hit ? tmin : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[k] = acc[k] + __shfl_sync(0xFFFFFFFFu, term[c], lead + s);"""),
    ("  const int ray = (blockIdx.x * blockDim.x + threadIdx.x) * kNodeRays;",
     "  const int ray = (blockIdx.x * blockDim.x + threadIdx.x) / 2 * "
     "kNodeRays;\n  const int q = threadIdx.x % 2, lead = threadIdx.x % 32 - q;"),
    ("node_pop(srows + (i & (kRows - 1)) * kNodeWords, r, acc);",
     "node_pop(srows + (i & (kRows - 1)) * kNodeWords, q, lead, r, acc);"),
    ("    if (ray + k < total) out[ray + k] = acc[k];",
     "    if (q == 0 && ray + k < total) out[ray + k] = acc[k];"),
    ("(long long)(total + kNodeRays - 1) / kNodeRays;",
     "(long long)(total + kNodeRays - 1) / kNodeRays * 2;"),
]}


# Sources a --checkout build takes, each built as it is.
CHECKOUT_SOURCES = ("traverse", "cluster_traverse", "megakernel",
                    "subpacket_traverse", "roofline", "dense_intersect")

# name -> (what it changes, sources it rebuilds, {file: [(old, new)]}).
VARIANTS = {
    "unbounded": (
        "B1 without its register cap (kMinBlocks)", ("traverse",),
        {"traverse.cu": [("__launch_bounds__(kMaxThreads, kMinBlocks)",
                          "__launch_bounds__(kMaxThreads)")]}),
    "local-stack": (
        "B1's stack in a local array, not shared memory", ("traverse",),
        {"traverse.cu": [("extern __shared__ int stack[];",
                          "int stack[bvh::kMaxStack];"),
                         ("stack + threadIdx.x, blockDim.x", "stack, 1")]}),
    "network-only": (
        "every node with two or more entered children ordered by the "
        "network (no two-child compare)",
        ("traverse", "cluster_traverse", "megakernel"),
        {"bvh_walk.cuh": [(_ORDER, """  if (ordered && total > 1) {
    sort_children<kKeys>(key, slot, entry, skey);""")]}),
    "network-always": (
        "every ordered node through the network, one child or none too",
        ("traverse", "cluster_traverse", "megakernel"),
        {"bvh_walk.cuh": [(_ORDER, """  if (ordered) {
    sort_children<kKeys>(key, slot, entry, skey);""")]}),
    "held-child": (
        "the walk keeps the child it pops next in a register, unpushed",
        ("traverse", "megakernel"),
        {"bvh_walk.cuh": [
            ("""                                           float* keys = nullptr) {
  NodeRow n;""", """                                           float* keys = nullptr,
                                           int* next = nullptr) {
  NodeRow n;"""),
            ("""      if (k < total && pos < depth) {
        stack[pos * stride] = entry[k];""", """      if (k < total && pos < depth && next && k == 0) {
        *next = entry[k];
      } else if (k < total && pos < depth) {
        stack[pos * stride] = entry[k];"""),
            ("""      if (((hits >> j) & 1u) && pos < depth) {
        stack[pos * stride] = entry[j];""", """      if (((hits >> j) & 1u) && pos < depth && next &&
          pos == sp + total - 1) {
        *next = entry[j];
      } else if (((hits >> j) & 1u) && pos < depth) {
        stack[pos * stride] = entry[j];"""),
            ("""  sp = min(sp + total, depth);
  return dropped;""", """  sp = min(sp + total, depth) - (next && *next != kInvalid ? 1 : 0);
  return dropped;"""),
            (_WALK, _HELD_WALK)]}),
    "mega-shared-stack": (
        "the MT megakernel's walks on a stack in dynamic shared memory, "
        "[depth][threads] (B1's layout), sized by the scene's bound",
        ("megakernel",),
        {"megakernel.cu": [
            ("    int stack[bvh::kMaxStack];\n",
             "    extern __shared__ int mega_stack[];\n"
             "    int* stack = mega_stack + threadIdx.x;\n"),
            ("g.depth, t, leaf, pops, stack, 1);",
             "g.depth, t, leaf, pops, stack, blockDim.x);"),
            (_MEGA_LAUNCH, """  auto kernel = mega_kernel<kModel, kNee, kRegen, kCluster, kStats>;
  const int smem = kCluster ? 0 : args.depth * kThreads * (int)sizeof(int);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return (int)cudaGetLastError();
  kernel<<<blocks, kThreads, smem, stream>>>(args);""")]}),
    "mega-pickup": (
        "the MT megakernel with as many threads as stay resident, each "
        "picking up the next lane when its lane ends",
        ("megakernel",), {"megakernel.cu": _PICKUP}),
    "mega-pickup-cap": (
        "mega-pickup with the registers capped for five blocks of 128 an "
        "SM (102)", ("megakernel",),
        {"megakernel.cu": _PICKUP + [(
            "__launch_bounds__(kThreads) mega_kernel(MegaArgs g, int threads)",
            "__launch_bounds__(kThreads, kCluster ? 1 : 5)\n"
            "    mega_kernel(MegaArgs g, int threads)")]}),
    "mega-threads-64": (
        "the megakernel at 64 threads a block", ("megakernel",),
        {"megakernel.cu": [("constexpr int kThreads = 128;",
                            "constexpr int kThreads = 64;")]}),
    "mega-min-blocks-5": (
        "the MT megakernel's registers capped for five blocks of 128 an SM "
        "(102)", ("megakernel",),
        {"megakernel.cu": [(_MEGA_BOUNDS, "__launch_bounds__(kThreads, "
                            "kCluster ? 1 : 5) mega_kernel(MegaArgs g) {")]}),
    "mega-min-blocks-6": (
        "the MT megakernel's registers capped for six blocks of 128 an SM "
        "(85)", ("megakernel",),
        {"megakernel.cu": [(_MEGA_BOUNDS, "__launch_bounds__(kThreads, "
                            "kCluster ? 1 : 6) mega_kernel(MegaArgs g) {")]}),
    "subpacket-multi": (
        "B6 with every K through the kMulti instantiations (each turn "
        "loads its sub-packet's rays and stores its results)",
        ("subpacket_traverse",),
        {"subpacket_traverse.cu": [("const bool multi = group > kMaxWarps;",
                                    "const bool multi = true;")]}),
    "cluster-sub-4": (
        "B9e with four threads a ray pair", ("roofline",),
        {"roofline.cu": [("constexpr int kClusterSub = 2;",
                          "constexpr int kClusterSub = 4;")]}),
    "cluster-128": (
        "B9e with 128 threads a block", ("roofline",),
        {"roofline.cu": [("constexpr int kClusterThreads = 256;",
                          "constexpr int kClusterThreads = 128;")]}),
    "cluster-one-ray": (
        "B9e with one ray a thread", ("roofline",),
        {"roofline.cu": [("constexpr int kClusterRays = 2;",
                          "constexpr int kClusterRays = 1;")]}),
    "cluster-sub-1": (
        "B9e with one thread for a ray pair", ("roofline",),
        {"roofline.cu": [("constexpr int kClusterSub = 2;",
                          "constexpr int kClusterSub = 1;")]}),
    "cluster-sub-8": (
        "B9e with eight threads a ray pair", ("roofline",),
        {"roofline.cu": [("constexpr int kClusterSub = 2;",
                          "constexpr int kClusterSub = 8;")]}),
    "cluster-cap": (
        "B9e's registers capped for four blocks of 256 an SM (64)",
        ("roofline",),
        {"roofline.cu": [("__launch_bounds__(kClusterThreads)\n",
                          "__launch_bounds__(kClusterThreads, 4)\n")]}),
    "dense-one-ray": (
        "B5 closest with one ray a thread", ("dense_intersect",),
        {"dense_intersect.cu": [("constexpr int kRays = kAnyHit ? 1 : 2;",
                                 "constexpr int kRays = 1;")]}),
    "dense-four-rays": (
        "B5 closest with four rays a thread", ("dense_intersect",),
        {"dense_intersect.cu": [("constexpr int kRays = kAnyHit ? 1 : 2;",
                                 "constexpr int kRays = kAnyHit ? 1 : 4;"),
                                ("constexpr int kMaxBlockRays = 2 * kThreads;",
                                 "constexpr int kMaxBlockRays = 4 * kThreads;")
                                ]}),
    "dense-anyhit-two-rays": (
        "B5 any-hit with two rays a thread", ("dense_intersect",),
        {"dense_intersect.cu": [("constexpr int kRays = kAnyHit ? 1 : 2;",
                                 "constexpr int kRays = 2;")]}),
    "dense-unroll-4": (
        "B5 with four triangles unrolled in both modes", ("dense_intersect",),
        {"dense_intersect.cu": [("constexpr int kUnroll = kAnyHit ? 4 : 2;",
                                 "constexpr int kUnroll = 4;")]}),
    "dense-256-threads": (
        "B5 with 256 threads a block", ("dense_intersect",),
        {"dense_intersect.cu": [("constexpr int kThreads = 128;",
                                 "constexpr int kThreads = 256;")]}),
    "dense-stage-64": (
        "B5 staging 64 triangles at a time", ("dense_intersect",),
        {"dense_intersect.cu": [("constexpr int kStage = 128;",
                                 "constexpr int kStage = 64;")]}),
    "dense-no-split": (
        "B5 never splitting the triangle range across blocks",
        ("dense_intersect",),
        {"dense_intersect.cu": [("  const int parts = max(1, min(",
                                 "  const int parts = 1 + 0 * max(1, min(")]}),
    "ilv-fetch": (
        "B7's walk in a loop that fetches W neighbouring rays when a "
        "thread's walks have all ended", ("traverse",), _ilv(True)),
    "ilv-fetch-64": ("ilv-fetch at 64 threads a block", ("traverse",),
                     _ilv(True, threads=64)),
    "ilv-fetch-256": ("ilv-fetch at 256 threads a block", ("traverse",),
                      _ilv(True, threads=256)),
    "ilv-slots": (
        "B7's walk step in a loop that hands a slot whose walk ended the "
        "next ray at once", ("traverse",), _ilv(False)),
    "ilv-slots-64": ("ilv-slots at 64 threads a block", ("traverse",),
                     _ilv(False, threads=64)),
    "ilv-slots-shared": (
        "ilv-slots at 64 threads a block, its stacks in shared memory",
        ("traverse",), _ilv(False, shared=True, threads=64)),
    "ilv-slots-shared-no-refill": (
        "ilv-slots-shared without refill: slot w of thread j walks ray "
        "w T + j and nothing else", ("traverse",),
        _ilv(False, refill=False, shared=True, threads=64)),
    "ilv-cap-64": (
        "B7's registers capped at 64 a thread (eight blocks of 128 an SM)",
        ("traverse",),
        {"traverse.cu": [(f"__launch_bounds__(kThreads)\n{k}(",
                          f"__launch_bounds__(kThreads, 8)\n{k}(")
                         for k in ("trace_closest_ilv_kernel",
                                   "trace_anyhit_ilv_kernel")]}),
    "bf16-hadd2": (
        "the bf16 product's feedback added as bf16 pairs (add.rn.bf16x2, "
        "one rounding; a timing of the f32 add's cost, not a design: JAX "
        "rounds to f32 first)", ("roofline",),
        {"roofline.cu": [("""  const __nv_bfloat162 r = __floats2bfloat162_rn(
      __uint_as_float(x << 16) + f, __uint_as_float(x & 0xFFFF0000u) + f);""",
                          """  const __nv_bfloat162 r = __hadd2(
      *reinterpret_cast<const __nv_bfloat162*>(&x), __float2bfloat162_rn(f));""")]}),
    "bf16-group-2": (
        "the bf16 product with two k steps a wgmma group", ("roofline",),
        {"roofline.cu": [("constexpr int kGroup = 4;",
                          "constexpr int kGroup = 2;")]}),
    "multi-shared": (
        "B8's whole stack in shared memory, [depth][blockDim] (B1's), 64 "
        "threads, 64 registers", ("traverse",), _multi(192, 64, 16, 0)),
    "multi-split-16": (
        "B8's stack split: its first 16 entries in shared memory (4 KB a "
        "block), the rest local; 64 threads, 64 registers", ("traverse",),
        _multi(16, 64, 16, 0)),
    "multi-split-32": ("multi-split-16 at 32 entries (8 KB a block)",
                       ("traverse",), _multi(32, 64, 16, 0)),
    "multi-split-64": ("multi-split-16 at 64 entries (16 KB a block)",
                       ("traverse",), _multi(64, 64, 16, 0)),
    "multi-split-32-uncapped": ("multi-split-32 without a register cap",
                                ("traverse",), _multi(32, 64, 1, 0)),
    "multi-split-32-128": ("multi-split-32 at 128 threads a block",
                           ("traverse",), _multi(32, 128, 8, 0)),
    "multi-split-32-256": ("multi-split-32 at 256 threads a block",
                           ("traverse",), _multi(32, 256, 4, 0)),
    "multi-local-128": (
        "the redesign's code with the parent's layout: the stack local, 128 "
        "threads, no register cap", ("traverse",), _multi(0, 128, 1, 0)),
    "multi-local-256": (
        "the stack local, 256 threads a block, 64 registers", ("traverse",),
        _multi(0, 256, 4, 0)),
    "multi-window-1": (
        "multi-split-32 with the next popped row's head in registers (pops "
        "in pop order), no register cap", ("traverse",), _multi(32, 64, 1, 1)),
    "multi-window-2": (
        "multi-split-32 with two popped rows' heads in registers, no "
        "register cap", ("traverse",), _multi(32, 64, 1, 2)),
    "multi-window-2-shared": (
        "two popped rows' heads in registers, the whole stack in shared "
        "memory, no register cap", ("traverse",), _multi(192, 64, 1, 2)),
    "leaf-sub-1": ("B9d with one thread a ray (no slot split)",
                   ("roofline",), _leaf("kLeafSub = 2", "kLeafSub = 1")),
    "leaf-sub-4": ("B9d with four threads sharing a ray's slots",
                   ("roofline",), _leaf("kLeafSub = 2", "kLeafSub = 4")),
    "leaf-rays-2": ("B9d with two rays a thread", ("roofline",),
                    _leaf("kLeafRays = 1", "kLeafRays = 2")),
    "leaf-rays-4": ("B9d with four rays a thread", ("roofline",),
                    _leaf("kLeafRays = 1", "kLeafRays = 4")),
    "leaf-128": ("B9d with 128 threads a block", ("roofline",),
                 _leaf("kLeafThreads = 256", "kLeafThreads = 128")),
    "leaf-frcp": (
        "B9d's division as __frcp_rn (a correctly rounded reciprocal: the "
        "same bits)", ("roofline",),
        _leaf("  float idet = 1.0f / det;\n  float tx = r.o[0] - p0x;",
              "  float idet = __frcp_rn(det);\n  float tx = r.o[0] - p0x;")),
    "leaf-global": (
        "B9d reading its slots from the table in global memory (L1), not "
        "the staged rows", ("roofline",),
        _leaf("    const float4* row = srows + (it % kRows) * kLeafWords;",
              "    const float4* row = reinterpret_cast<const float4*>(\n"
              "        rows + (it % kRows) * bvh::kRow);")),
    "node-sub-2": (
        "B9c with two threads a lane, four children each, the terms "
        "exchanged by shuffles and added in child order by both",
        ("roofline",), _NODE_SUB_2),
    "node-rays-1": ("B9c with one ray a thread", ("roofline",),
                    _leaf("kNodeRays = 2", "kNodeRays = 1")),
    "node-rays-4": ("B9c with four rays a thread", ("roofline",),
                    _leaf("kNodeRays = 2", "kNodeRays = 4")),
    "node-128": ("B9c with 128 threads a block", ("roofline",),
                 _leaf("kNodeThreads = 256", "kNodeThreads = 128")),
    "node-rays-1-128": (
        "B9c with one ray a thread and 128 threads a block (the first "
        "redesign)", ("roofline",),
        {"roofline.cu": [("kNodeRays = 2", "kNodeRays = 1"),
                         ("kNodeThreads = 256", "kNodeThreads = 128")]}),
    "node-unroll-4": ("B9c with four pops a loop step (one row address, "
                      "the others at constant offsets)", ("roofline",),
                      _leaf("""  for (int i = 0; i < iters; ++i)
    node_pop(srows + (i & (kRows - 1)) * kNodeWords, r, acc);""",
                            """  int i = 0;
  for (; i + 4 <= iters; i += 4) {
    const float4* w = srows + (i & (kRows - 1)) * kNodeWords;
#pragma unroll
    for (int u = 0; u < 4; ++u) node_pop(w + u * kNodeWords, r, acc);
  }
  for (; i < iters; ++i)
    node_pop(srows + (i & (kRows - 1)) * kNodeWords, r, acc);""")),
    "node-global": (
        "B9c reading its boxes as 16-byte loads from the table in global "
        "memory (L1), not the staged rows", ("roofline",),
        {"roofline.cu": [
            ("w[3 * m], w1 = w[3 * m + 1], w2 = w[3 * m + 2];",
             "__ldg(w + 3 * m), w1 = __ldg(w + 3 * m + 1),\n"
             "               w2 = __ldg(w + 3 * m + 2);"),
            ("""  __shared__ float4 srows[kRows * kNodeWords];
  for (int e = threadIdx.x; e < kRows * kNodeWords; e += blockDim.x)
    srows[e] = bvh::load4(rows + (e / kNodeWords) * bvh::kRow +
                          4 * (e % kNodeWords));
  __syncthreads();""",
             "  const float4* srows = reinterpret_cast<const float4*>(rows);"),
            ("node_pop(srows + (i & (kRows - 1)) * kNodeWords, r, acc);",
             "node_pop(srows + (i & (kRows - 1)) * (bvh::kRow / 4), r, acc);"),
        ]}),
    "node-select": (
        "B9c adding the parent's select, acc + (hit ? tmin : 0), not the "
        "term under the hit predicate", ("roofline",),
        _leaf("""      if (bvh::slab_test(b[j / 2] + 6 * (j % 2), r[k], t_cur, tmin))
        acc[k] = acc[k] + tmin;""",
              """      const bool hit =
          bvh::slab_test(b[j / 2] + 6 * (j % 2), r[k], t_cur, tmin);
      acc[k] = acc[k] + (hit ? tmin : 0.0f);""")),
    "b4-four-blocks": (
        "B4 closest with 48 KB of idle shared memory a block (four blocks "
        "an SM)", ("cluster_traverse",),
        {"cluster_traverse.cu": [(
            """  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, cl, refs,""",
            """  kernel<<<blocks, kThreads, 48 * 1024, (cudaStream_t)stream>>>(
      rows, cl, refs,""")]}),
}
# The kernels whose ptxas lines a variant's build prints: these and every
# MT megakernel instantiation (cluster=0).
KERNELS = ("trace_closest_kernel<0>", "trace_anyhit_kernel<0>",
           "trace_cluster_closest_kernel<0, 0>",
           "trace_cluster_anyhit_kernel<0>",
           "mega_kernel<beckmann, nee=1, regen=1, cluster=1, stats=0>",
           "subpacket_kernel<0, 0>", "subpacket_kernel<1, 0>",
           "subpacket_kernel<0, 1>", "subpacket_kernel<1, 1>",
           "subpacket_kernel<0>", "subpacket_kernel<1>", "cluster_kernel",
           "dense_kernel<0, 1>", "dense_kernel<1, 1>",
           "trace_ilv_fetch_kernel<2, 0, 0>",
           "trace_ilv_fetch_kernel<2, 1, 0>",
           "trace_ilv_kernel<2, 0, 0>", "trace_ilv_kernel<2, 1, 0>",
           "trace_ilv_kernel<4, 0, 0>", "trace_ilv_kernel<4, 1, 0>",
           "trace_closest_ilv_kernel<2, 0>", "trace_anyhit_ilv_kernel<2, 0>",
           "trace_closest_ilv_kernel<4, 0>", "trace_anyhit_ilv_kernel<4, 0>",
           "mxu_bf16_kernel", "mxu_wgmma_kernel<128, 0>",
           "mxu_wgmma_kernel<136, 1>", "trace_closest_multi_kernel<2, 0>",
           "trace_anyhit_multi_kernel<2, 0>",
           "trace_closest_multi_kernel<4, 0>",
           "trace_anyhit_multi_kernel<4, 0>", "leaf_mt_kernel",
           "node_slab_kernel")


def _printed(line: str) -> bool:
    name = line.split(":")[0]
    return name in KERNELS or (name.startswith("mega_kernel<")
                               and "cluster=0" in name)


def build_variant(name: str, checkouts: dict,
                  needed=CHECKOUT_SOURCES) -> dict:
    """nvcc builds of one variant, or of a checkout's csrc/ (``checkouts``:
    name -> root; its ``needed`` sources): {source: library path}."""
    import chip_smoke
    from gpupathtracer_tpu_torch.ops import cuda_build

    if name in checkouts:
        csrc = os.path.join(checkouts[name], "gpupathtracer_tpu_torch",
                            "csrc")
        sources, edits = needed, {}
    else:
        csrc = cuda_build.CSRC
        _, sources, edits = VARIANTS[name]
    d = os.path.join(cuda_build.BUILD_DIR, "variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for f, reps in edits.items():
        path = os.path.join(d, f)
        text = open(path).read()
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"variant {name}: {f} has no {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
    libs = {}
    for s in sources:
        so = os.path.join(d, s + ".so")
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                               "-o", so, os.path.join(d, s + ".cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed on {s}:\n"
                               f"{proc.stderr}")
        for line in chip_smoke._ptxas_summary(proc.stderr):
            if _printed(line):
                print(f"[{name}] ptxas {line}", flush=True)
        libs[s] = so
    return libs


class Swapped:
    """A wrapper module running a variant's library for the duration."""

    def __init__(self, module, so):
        self.module, self.so = module, so

    def __enter__(self):
        from gpupathtracer_tpu_torch.ops import cuda_build
        # The traversal wrappers keep a library per arity (_libs); a
        # checkout's may keep one (_lib). The variant serves arity 8.
        per_arity = hasattr(self.module, "_libs")
        self.saved = (dict(self.module._libs) if per_arity
                      else self.module._lib)
        build = cuda_build.build
        cuda_build.build = lambda name, *_: (self.so, "")
        try:
            if per_arity:
                self.module._libs.clear()
            else:
                self.module._lib = None
            self.module._library()
        finally:
            cuda_build.build = build

    def __exit__(self, *exc):
        if hasattr(self.module, "_libs"):
            self.module._libs.clear()
            self.module._libs.update(self.saved)
        else:
            self.module._lib = self.saved


def runs(libs: dict, source: str, module, own_wrapper: bool = False):
    """(label, context, wrapper module) for the tree's build and each
    variant that rebuilt ``source``; with ``own_wrapper`` a checkout runs
    through its own copy of ``module``'s file (CHECKOUT_ROOTS)."""
    import contextlib
    out = [("tree", contextlib.nullcontext(), module)]
    for name, built in libs.items():
        if source in built:
            mod = module
            if own_wrapper and name in CHECKOUT_ROOTS:
                mod = _checkout_module(CHECKOUT_ROOTS[name], module)
            out.append((name, Swapped(mod, built[source]), mod))
    return out


# name -> root of each --checkout.
CHECKOUT_ROOTS: dict = {}


def _checkout_module(root: str, module):
    """The checkout's own copy of a wrapper module (same package path),
    loaded beside the tree's under another name; its imports resolve to
    the tree's package."""
    import importlib.util

    rel = module.__name__.replace(".", os.sep) + ".py"
    spec = importlib.util.spec_from_file_location(
        f"_checkout_{abs(hash(root))}_{module.__name__.split('.')[-1]}",
        os.path.join(root, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_walks(libs: dict, reps: int, device) -> None:
    """B1 and B4 on phase 3's rays of sponza and bathroom."""
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.scene import load_scene

    for name, w, h in (("sponza", 1920, 1080), ("bathroom", 1280, 720)):
        cfg = cs._scene_cfg(name, w, h)
        scene, meta = load_scene(cfg, device)
        o, d, t_occ, on = cs._test_rays(scene, meta, cfg, device)
        far = torch.full((o.shape[0],), 1e20, device=device)
        rows = scene.node_rows
        kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
        ref = (kt.closest(rows, o, d, far, on, **kw),
               kt.anyhit(rows, o, d, t_occ, on, **kw))
        for rep in range(reps):
            for label, ctx, mod in runs(libs, "traverse", kt,
                                        own_wrapper=True):
                with ctx:
                    for th in (64, 128):
                        cs._hold_hits(f"{label} B1", mod.closest(
                            rows, o, d, far, on, threads=th, **kw), ref[0])
                        cs._hold_occluded(f"{label} B1", mod.anyhit(
                            rows, o, d, t_occ, on, threads=th, **kw), ref[1])
                        ms_c = cs._events_ms(lambda: mod.closest(
                            rows, o, d, far, on, threads=th, **kw), 20)
                        ms_a = cs._events_ms(lambda: mod.anyhit(
                            rows, o, d, t_occ, on, threads=th, **kw), 20)
                        print(f"[{name}] B1 {label}, {th} threads, rep {rep}:"
                              f" closest {ms_c:.4f} ms, any-hit {ms_a:.4f} ms",
                              flush=True)
        cfg = cs._scene_cfg(name, w, h, cluster_tris=128)
        cscene, cmeta = load_scene(cfg, device)
        tabs = (cscene.node_rows, cscene.cluster_rows)
        refs = cscene.cluster_refs
        kw = dict(stack_depth=cmeta.stack_depth)
        ref = (kc.closest_cluster(*tabs, refs, o, d, far, on, **kw),
               kc.anyhit_cluster(*tabs, o, d, t_occ, on, **kw))
        for rep in range(reps):
            for label, ctx, mod in runs(libs, "cluster_traverse", kc,
                                        own_wrapper=True):
                with ctx:
                    cs._hold_hits(f"{label} B4", mod.closest_cluster(
                        *tabs, refs, o, d, far, on, **kw), ref[0])
                    cs._hold_occluded(f"{label} B4", mod.anyhit_cluster(
                        *tabs, o, d, t_occ, on, **kw), ref[1])
                    ms_c = cs._events_ms(lambda: mod.closest_cluster(
                        *tabs, refs, o, d, far, on, **kw), 10)
                    ms_a = cs._events_ms(lambda: mod.anyhit_cluster(
                        *tabs, o, d, t_occ, on, **kw), 10)
                print(f"[{name}] B4 {label}, rep {rep}: closest {ms_c:.4f} "
                      f"ms, any-hit {ms_a:.4f} ms", flush=True)


def time_mega(libs: dict, reps: int, device) -> None:
    """The MT and cluster megakernels on bathroom 256x144, 64 bounces,
    4 spp (chip_smoke.py phase 8's regenerating case)."""
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.math.camera import generate_image_plane
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.scene import load_scene

    w, h = 256, 144
    for ct in (0, 128):
        cfg = cs._scene_cfg("bathroom", w, h, skybox="GENERATE COLOR BLACK",
                            microfacet="beckmann", cluster_tris=ct)
        scene, meta = load_scene(cfg, device)
        lane = torch.arange(w * h, device=device)
        args, kw = mk.prepare_mega(
            scene, mk.pack_mega_tables(scene),
            generate_image_plane(cfg.camera, device), (lane % w).float(),
            (lane // w).float(), random.PRNGKey(7, device), width=w,
            height=h, stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
            max_bounces=64, nee=True, model="beckmann",
            n_mats=meta.num_materials,
            n_lights=int(scene.light_rows.shape[0]),
            packet_size=cfg.pallas_packet_size, spp=4)
        ref = mk.trace_mega(*args, **kw)[0]
        leaf = "cluster" if ct else "MT"
        for rep in range(reps):
            for label, ctx, _ in runs(libs, "megakernel", mk):
                with ctx:
                    got = mk.trace_mega(*args, **kw)[0]
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.int32),
                                       ref.view(torch.int32)):
                        raise AssertionError(f"{label}: megakernel lanes "
                                             f"differ from the tree's")
                    ms = cs._events_ms(lambda: mk.trace_mega(*args, **kw), 5)
                print(f"[bathroom 256x144] {leaf} megakernel {label}, rep "
                      f"{rep}: {ms:.3f} ms", flush=True)


def _mega_row_args(device, name, args, batch, frames):
    """trace_mega's arguments for the first chunk of a megakernel row's
    first frame, as the Renderer builds them (chip_smoke.py phase 9)."""
    import chip_smoke as cs
    from gpupathtracer_tpu_torch import cli
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.render import Renderer

    cfg = cli.build_config(cli.parse_args(cs._mega_argv(args, batch,
                                                        frames)))
    r = Renderer(cfg, device)
    if not r.use_mega:
        raise AssertionError(f"[{name}] the scene is not mega-eligible")
    sl = slice(0, r.chunk)
    return mk.prepare_mega(
        r.scene, r.mega_tables, r.camera, r.pixel_x[sl], r.pixel_y[sl],
        r.chunk_key(0), sample_idx=0, spp=batch,
        **r.mega_statics(cfg.integrator))


def time_mega_rows(libs: dict, reps: int, device) -> None:
    """Phase 10's MT rows: the first chunk's kernel time a launch (CUDA
    events) and seconds a sample through the CLI over ROW_FRAMES frames
    (the host clock around each frame, the CLI's render_seconds)."""
    import tempfile

    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch import cli
    from gpupathtracer_tpu_torch.ops import megakernel as mk

    for name, args, batch, _ in cs.MEGA_RUNS:
        margs, kw = _mega_row_args(device, name, args, batch, ROW_FRAMES)
        ref = mk.trace_mega(*margs, **kw)
        for rep in range(reps):
            for label, ctx, _ in runs(libs, "megakernel", mk):
                with ctx, tempfile.TemporaryDirectory() as tmp:
                    got = mk.trace_mega(*margs, **kw)
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0].view(torch.int32),
                                        ref[0].view(torch.int32))
                            and int(got[1]) == int(ref[1])):
                        raise AssertionError(f"{label}: {name} lanes differ "
                                             f"from the tree's")
                    ms = cs._events_ms(lambda: mk.trace_mega(*margs, **kw),
                                       2)
                    sj = os.path.join(tmp, "stats.json")
                    rc = cli.main(cs._mega_argv(args, batch, ROW_FRAMES) + [
                        "--out", os.path.join(tmp, "f.png"),
                        "--stats-json", sj])
                    if rc:
                        raise AssertionError(f"[{name}] CLI returned {rc}")
                    with open(sj) as f:
                        st = json.load(f)
                print(f"[{name}] MT megakernel {label}, rep {rep}: kernel "
                      f"{ms:.3f} ms a launch of {batch} samples "
                      f"({ms / batch:.4f} ms a sample); CLI "
                      f"{st['render_seconds'] / (ROW_FRAMES * batch):.6f} "
                      f"s/sample over {ROW_FRAMES} frames, "
                      f"{st['mrays_per_sec']:.1f} Mrays/s", flush=True)


def time_mega_profile(libs: dict, reps: int, device) -> None:
    """tools/torch_mega_profile.py --time under each megakernel build."""
    from gpupathtracer_tpu_torch.ops import megakernel as mk

    import chip_smoke as cs
    prof = cs._tool_module("torch_mega_profile")
    for rep in range(reps):
        for label, ctx, _ in runs(libs, "megakernel", mk):
            with ctx:
                out = prof.main(["--time"])
            print(f"[mega profile] {label}, rep {rep}: "
                  f"{out.get('ns_per_pop', 0):.4f} ns a pop, "
                  f"{out.get('ms_per_sample', 0):.3f} ms a sample",
                  flush=True)


SUBPACKET_KS = (128, 256, 2048)
# Frames of each CLI run of the mega-rows group.
ROW_FRAMES = 8


def time_subpacket(libs: dict, reps: int, device) -> None:
    """B6 at SUBPACKET_KS on phase 3's 131,072 rays and on the A/B tool's
    2^19 incoherent rays (all active, t_max 1e20), closest and any-hit;
    t (closest) and occlusion bitwise the per-ray kernel's."""
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops import subpacket_traverse as sp
    from gpupathtracer_tpu_torch.scene import load_scene

    bench = cs._tool_module("torch_kernel_bench")
    for name, w, h in (("sponza", 1920, 1080), ("bathroom", 1280, 720)):
        cfg = cs._scene_cfg(name, w, h)
        scene, meta = load_scene(cfg, device)
        kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
        o, d, t_occ, on = cs._test_rays(scene, meta, cfg, device)
        n = o.shape[0]
        sets = {"phase 3": (o, d, torch.full((n,), 1e20, device=device),
                            t_occ, on)}
        o2, d2 = bench.make_rays(f"proc:{name}", scene, meta, 1 << 19,
                                 device)["incoherent"]
        far2 = torch.full((1 << 19,), 1e20, device=device)
        sets["2^19 incoherent"] = (o2, d2, far2, far2,
                                   torch.ones_like(far2, dtype=torch.bool))
        for tag, (o_, d_, far, tocc, act) in sets.items():
            m = o_.shape[0]
            ref = (kt.closest(scene.node_rows, o_, d_, far, act, **kw)[0],
                   kt.anyhit(scene.node_rows, o_, d_, tocc, act, **kw))
            for rep in range(reps):
                for label, ctx, _ in runs(libs, "subpacket_traverse", sp):
                    line = []
                    with ctx:
                        for K in SUBPACKET_KS:
                            for any_hit, tm in ((False, far), (True, tocc)):
                                args = (scene.node_rows,
                                        o_.reshape(m // K, K, 3),
                                        d_.reshape(m // K, K, 3),
                                        tm.reshape(m // K, K),
                                        act.reshape(m // K, K))
                                out = sp.traverse_subpacket(
                                    *args, any_hit=any_hit, **kw)
                                torch.cuda.synchronize()
                                same = (torch.equal(out[1].reshape(-1) >= 0,
                                                    ref[1]) if any_hit else
                                        torch.equal(cs._bits(
                                            out[0].reshape(-1)),
                                            cs._bits(ref[0])))
                                if not same:
                                    raise AssertionError(
                                        f"{label} B6 K={K} differs from the "
                                        f"per-ray kernel")
                                ms = cs._events_ms(
                                    lambda: sp.traverse_subpacket(
                                        *args, any_hit=any_hit, **kw), 5)
                                line.append(f"K={K} "
                                            f"{'any-hit' if any_hit else 'closest'}"
                                            f" {ms:.4f}")
                    print(f"[{name} {tag}, {m} rays] B6 {label}, rep {rep}: "
                          + ", ".join(line) + " ms", flush=True)


def time_dense(libs: dict, reps: int, device) -> None:
    """B5 on bathroom (phase 3's rays and the A/B tool's 2^19 incoherent
    rays, both roundings) and on sponza's first DENSE_SPONZA_RAYS of phase
    3's rays (use_mxu), closest and any-hit; the tree's output bitwise the
    plain version's, every other build's bitwise the tree's."""
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch.ops import dense_intersect as pd
    from gpupathtracer_tpu_torch.scene import load_scene

    bench = cs._tool_module("torch_kernel_bench")
    for name, w, h in (("bathroom", 1280, 720), ("sponza", 1920, 1080)):
        cfg = cs._scene_cfg(name, w, h)
        scene, meta = load_scene(cfg, device)
        wd, wo = (torch.as_tensor(x, device=device)
                  for x in pd.pack_dense_tris(scene.tri_geom.cpu().numpy()))
        o, d, t_occ, on = cs._test_rays(scene, meta, cfg, device)
        if name == "sponza":
            n = cs.DENSE_SPONZA_RAYS
            o, d, t_occ, on = (x[:n].contiguous() for x in (o, d, t_occ, on))
        far = torch.full((o.shape[0],), 1e20, device=device)
        sets = [("phase 3", (o, d, far, on), (o, d, t_occ, on))]
        roundings = (True,)
        if name == "bathroom":
            roundings = (True, False)
            o2, d2 = bench.make_rays(f"proc:{name}", scene, meta, 1 << 19,
                                     device)["incoherent"]
            far2 = torch.full((1 << 19,), 1e20, device=device)
            all2 = torch.ones(1 << 19, dtype=torch.bool, device=device)
            sets.append(("2^19 incoherent", (o2, d2, far2, all2),
                         (o2, d2, far2, all2)))
        for tag, closest_args, anyhit_args in sets:
            for use_mxu in roundings:
                for any_hit, args in ((False, closest_args),
                                      (True, anyhit_args)):
                    kw = dict(any_hit=any_hit, use_mxu=use_mxu)
                    ref = pd.dense_intersect_plain(wd, wo, *args, **kw)
                    mode = "any-hit" if any_hit else "closest"
                    for rep in range(reps):
                        line = []
                        for label, ctx, mod in runs(libs, "dense_intersect",
                                                    pd, own_wrapper=True):
                            with ctx:
                                got = mod.dense_intersect(wd, wo, *args, **kw)
                                torch.cuda.synchronize()
                                if not all(torch.equal(cs._bits(g), cs._bits(r))
                                           for g, r in zip(got, ref)):
                                    raise AssertionError(
                                        f"{label} B5 {mode} differs from the "
                                        f"plain version on {name} {tag}")
                                ms = cs._events_ms(lambda: mod.dense_intersect(
                                    wd, wo, *args, **kw), 5)
                            line.append(f"{label} {ms:.4f}")
                        print(f"[{name} {tag}, {args[0].shape[0]} rays] B5 "
                              f"{mode} use_mxu={use_mxu}, rep {rep}: "
                              + ", ".join(line) + " ms", flush=True)


def time_cluster_probe(libs: dict, reps: int, device) -> None:
    """B9e at tools/torch_roofline.py run_compact's G, copies and cases,
    chip_smoke.py's timed iterations; every copy bitwise the plain
    version at its check iterations, in every build."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch.ops import roofline as rl

    tool = cs._tool_module("torch_roofline")
    tool.set_device(device)
    g = tool.COMPACT_G
    rng = np.random.RandomState(11)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    o = t(rng.uniform(-0.5, 1.5, (3, g, 128)))
    d = torch.nn.functional.normalize(t(rng.normal(size=(3, g, 128))), dim=0)
    inv = 1.0 / d
    copies = tool.copies_for(g * 128 // rl.THREADS)
    iters = cs.PROBE_ITERS["roofline_cluster_dense"]
    for tc, any_hit in tool.COMPACT_CLUSTER:
        blk = t(rng.uniform(-1, 1, (16, 3 * tc)))
        want = rl.cluster_dense_plain(blk, o, d, inv,
                                      iters=cs.PROBE_CHECK_ITERS,
                                      any_hit=any_hit).view(torch.int32)
        work = g * 128 * (tc * rl.CLUSTER_SLOT + rl.CLUSTER_EPILOGUE)
        bound = 1e3 * work * iters * copies / cs.PEAK_FP32_INSTR
        mode = "any-hit" if any_hit else "closest"
        for rep in range(reps):
            line = []
            for label, ctx, _ in runs(libs, "roofline", rl):
                with ctx:
                    got = rl.cluster_dense(blk, o, d, inv,
                                           iters=cs.PROBE_CHECK_ITERS,
                                           any_hit=any_hit, copies=copies)
                    torch.cuda.synchronize()
                    if not all(torch.equal(c.view(torch.int32), want)
                               for c in got):
                        raise AssertionError(f"{label} B9e tc {tc} {mode}: a "
                                             f"copy differs from the plain "
                                             f"version")
                    ms = cs._events_ms(lambda: rl.cluster_dense(
                        blk, o, d, inv, iters=iters, any_hit=any_hit,
                        copies=copies), 3)
                line.append(f"{label} {ms:.4f} ({bound / ms:.1%})")
            print(f"[B9e G={g} x{copies} tc={tc} {mode}, {iters} pops] rep "
                  f"{rep}, bound {bound:.4f} ms: " + ", ".join(line) + " ms",
                  flush=True)


def time_ilv(libs: dict, reps: int, device) -> None:
    """B7 at W = 2 and 4, closest and any-hit, on phase 3's rays of sponza
    and bathroom and on sponza's 2^19 incoherent rays (t_max 1e20, all
    active), B1 beside it; every build's hits bitwise B1's."""
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.scene import load_scene

    bench = cs._tool_module("torch_kernel_bench")
    for name, w, h in (("sponza", 1920, 1080), ("bathroom", 1280, 720)):
        cfg = cs._scene_cfg(name, w, h)
        scene, meta = load_scene(cfg, device)
        rows = scene.node_rows
        kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
        o, d, t_occ, on = cs._test_rays(scene, meta, cfg, device)
        far = torch.full((o.shape[0],), 1e20, device=device)
        sets = {"phase 3": (o, d, far, t_occ, on)}
        if name == "sponza":
            o2, d2 = bench.make_rays(f"proc:{name}", scene, meta, 1 << 19,
                                     device)["incoherent"]
            far2 = torch.full((1 << 19,), 1e20, device=device)
            sets["2^19 incoherent"] = (o2, d2, far2, far2, torch.ones_like(
                far2, dtype=torch.bool))
        for tag, (o_, d_, tc, ta, act) in sets.items():
            b1 = (kt.closest(rows, o_, d_, tc, act, **kw),
                  kt.anyhit(rows, o_, d_, ta, act, **kw))
            for rep in range(reps):
                ms_c = cs._events_ms(lambda: kt.closest(rows, o_, d_, tc, act,
                                                        **kw), 10)
                ms_a = cs._events_ms(lambda: kt.anyhit(rows, o_, d_, ta, act,
                                                       **kw), 10)
                line = [f"B1 {ms_c:.4f} / {ms_a:.4f}"]
                for label, ctx, mod in runs(libs, "traverse", kt,
                                            own_wrapper=True):
                    with ctx:
                        for wv in (2, 4):
                            cs._hold_hits(f"{label} B7 W={wv}", mod.closest(
                                rows, o_, d_, tc, act, interleave=wv, **kw),
                                b1[0])
                            cs._hold_occluded(f"{label} B7 W={wv}", mod.anyhit(
                                rows, o_, d_, ta, act, interleave=wv, **kw),
                                b1[1])
                            ms_c = cs._events_ms(lambda: mod.closest(
                                rows, o_, d_, tc, act, interleave=wv, **kw),
                                10)
                            ms_a = cs._events_ms(lambda: mod.anyhit(
                                rows, o_, d_, ta, act, interleave=wv, **kw),
                                10)
                            line.append(f"{label} W={wv} {ms_c:.4f} / "
                                        f"{ms_a:.4f}")
                print(f"[{name} {tag}, {o_.shape[0]} rays] closest / any-hit "
                      f"ms, rep {rep}: " + ", ".join(line), flush=True)


def time_bf16_probe(libs: dict, reps: int, device) -> None:
    """The bf16 product at run_compact's bf16 shapes and copies,
    chip_smoke.py's timed iterations, beside torch.matmul (bf16) on the same
    work; every copy within chip_smoke.py's bound of the plain version at
    its check iterations, in every build."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch.ops import roofline as rl

    tool = cs._tool_module("torch_roofline")
    tool.set_device(device)
    rng = np.random.RandomState(11)
    iters = cs.PROBE_ITERS["roofline_mxu_bf16"]
    for _, m, k, n, dtype, _, _ in tool.COMPACT_MXU:
        if dtype != "bfloat16":
            continue
        a, b = (torch.as_tensor(rng.uniform(-1, 1, s).astype(np.float32),
                                device=device).bfloat16()
                for s in ((m, k), (k, n)))
        copies = tool.copies_for(-(-m // 64) * -(-n // 64))
        want = rl.mxu_plain(a, b, iters=cs.PROBE_CHECK_ITERS)
        tol = (cs.BF16_BOUND * cs.PROBE_CHECK_ITERS *
               float(a.float().abs().sum(1).max() * b.float().abs().max()))
        bound = 1e3 * 2 * m * k * n * iters * copies / cs.PEAK_BF16_FLOPS
        big = a.expand(copies, m, k).reshape(-1, k)
        for rep in range(reps):
            lib = cs._events_ms(
                lambda: [torch.matmul(big, b) for _ in range(iters)], 3)
            line = []
            for label, ctx, _ in runs(libs, "roofline", rl):
                with ctx:
                    got = rl.mxu(a, b, iters=cs.PROBE_CHECK_ITERS,
                                 copies=copies)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    if err > tol or not all(torch.equal(got[0], c)
                                            for c in got):
                        raise AssertionError(f"{label} B9b bf16 [{m},{k}]x"
                                             f"[{k},{n}]: max |diff| {err:.3g}"
                                             f" (bound {tol:.3g}), or copies "
                                             f"differ")
                    ms = cs._events_ms(lambda: rl.mxu(a, b, iters=iters,
                                                      copies=copies), 3)
                line.append(f"{label} {ms:.4f} ({bound / ms:.1%}, max |diff| "
                            f"{err:.3g})")
            print(f"[B9b bf16 [{m},{k}]x[{k},{n}] x{copies}, {iters} "
                  f"iterations] rep {rep}, bound {bound:.4f} ms, torch.matmul "
                  f"{lib:.4f} ms: " + ", ".join(line), flush=True)


def time_multi(libs: dict, reps: int, device) -> None:
    """B8 at Q = 2 and 4, closest and any-hit, on phase 3's rays of sponza
    and bathroom and on sponza's 2^19 incoherent rays (t_max 1e20, all
    active), B1 beside it. The stack bound is the scene's, at most 192 / Q
    (sponza's 58 at Q = 4 would need 232 entries). Every build's results
    and [N, 3] counts bitwise the tree's; t and occluded bitwise B1's in
    every lane that dropped no push."""
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.scene import load_scene

    bench = cs._tool_module("torch_kernel_bench")
    for name, w, h in (("sponza", 1920, 1080), ("bathroom", 1280, 720)):
        cfg = cs._scene_cfg(name, w, h)
        scene, meta = load_scene(cfg, device)
        rows = scene.node_rows
        o, d, t_occ, on = cs._test_rays(scene, meta, cfg, device)
        far = torch.full((o.shape[0],), 1e20, device=device)
        sets = {"phase 3": (o, d, far, t_occ, on)}
        if name == "sponza":
            o2, d2 = bench.make_rays(f"proc:{name}", scene, meta, 1 << 19,
                                     device)["incoherent"]
            far2 = torch.full((1 << 19,), 1e20, device=device)
            sets["2^19 incoherent"] = (o2, d2, far2, far2, torch.ones_like(
                far2, dtype=torch.bool))
        for tag, (o_, d_, tc, ta, act) in sets.items():
            kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
            b1 = (kt.closest(rows, o_, d_, tc, act, **kw),
                  kt.anyhit(rows, o_, d_, ta, act, **kw))
            qs = {q: dict(kw, multi_pop=q, stack_depth=min(
                meta.stack_depth, kt.MAX_STACK // q)) for q in kt.VARIANTS}
            ref = {q: (kt.closest(rows, o_, d_, tc, act, with_stats=True,
                                  **k),
                       kt.anyhit(rows, o_, d_, ta, act, with_stats=True,
                                 **k)) for q, k in qs.items()}
            for q, (c, a) in ref.items():
                for got, st, want in ((c[0], c[4], b1[0][0]),
                                      (a[0], a[1], b1[1])):
                    kept = st[:, 2] == 0
                    if not torch.equal(cs._bits(got)[kept],
                                       cs._bits(want)[kept]):
                        raise AssertionError(f"[{name} {tag}] B8 Q={q} "
                                             f"differs from B1")
            for rep in range(reps):
                ms_c = cs._events_ms(lambda: kt.closest(rows, o_, d_, tc, act,
                                                        **kw), 10)
                ms_a = cs._events_ms(lambda: kt.anyhit(rows, o_, d_, ta, act,
                                                       **kw), 10)
                line = [f"B1 {ms_c:.4f} / {ms_a:.4f}"]
                for label, ctx, mod in runs(libs, "traverse", kt,
                                            own_wrapper=True):
                    with ctx:
                        for q, k in qs.items():
                            cs._hold_stats(f"{label} B8 Q={q} closest",
                                           mod.closest(rows, o_, d_, tc, act,
                                                       with_stats=True, **k),
                                           ref[q][0])
                            cs._hold_stats(f"{label} B8 Q={q} any-hit",
                                           mod.anyhit(rows, o_, d_, ta, act,
                                                      with_stats=True, **k),
                                           ref[q][1])
                            cs._hold_hits(f"{label} B8 Q={q} closest",
                                          mod.closest(rows, o_, d_, tc, act,
                                                      **k), ref[q][0][:4])
                            cs._hold_occluded(f"{label} B8 Q={q} any-hit",
                                              mod.anyhit(rows, o_, d_, ta, act,
                                                         **k), ref[q][1][0])
                            ms_c = cs._events_ms(lambda: mod.closest(
                                rows, o_, d_, tc, act, **k), 10)
                            ms_a = cs._events_ms(lambda: mod.anyhit(
                                rows, o_, d_, ta, act, **k), 10)
                            line.append(f"{label} Q={q} {ms_c:.4f} / "
                                        f"{ms_a:.4f}")
                print(f"[{name} {tag}, {o_.shape[0]} rays] closest / any-hit "
                      f"ms, rep {rep}: " + ", ".join(line), flush=True)


def time_floor_probe(libs: dict, reps: int, device, node: bool) -> None:
    """B9c (node) or B9d at chip_smoke.py phase R's case (run_compact's G
    and copies, seeded random rows and rays, PROBE_ITERS pops) and at
    tools/torch_roofline.py run_phase_floors' case (its constant rays and
    seed-0 rows, run_compact's 4,096 pops), each with its bound; every copy
    bitwise the plain version at PROBE_CHECK_ITERS and at WRAP_ITERS pops,
    and on tests/test_torch_kernel.py's edge rows at WRAP_ITERS pops, in
    every build. For B9c, each build's longest SASS loop by opcode."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch.ops import cuda_build
    from gpupathtracer_tpu_torch.ops import roofline as rl

    tool = cs._tool_module("torch_roofline")
    tool.set_device(device)
    tests = cs._tool_module("test_torch_kernel", "tests")
    if node:
        tag, probe, plain, case_of, key, per_lane = (
            "B9c", rl.node_slab, rl.node_slab_plain, tests.node_probe_case,
            "roofline_node_slab", rl.NODE_POP)
        for label, so in [("tree", cuda_build.build("roofline")[0])] + [
                (n, b["roofline"]) for n, b in libs.items()
                if "roofline" in b]:
            print(f"[{label}] node_slab_kernel SASS, its longest loop by "
                  f"opcode: {cs._sass_loop_mix(so, 'node_slab_kernel')}",
                  flush=True)
    else:
        tag, probe, plain, case_of, key, per_lane = (
            "B9d", rl.leaf_mt, rl.leaf_mt_plain, tests.leaf_probe_case,
            "roofline_leaf_mt", rl.LEAF_SIZE * rl.MT_SLOT)
    g = tool.COMPACT_G
    rng = np.random.RandomState(11)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    rows = t(rng.uniform(0, 1, (64, 128)))
    o = t(rng.uniform(-0.5, 1.5, (3, g, 128)))
    d = torch.nn.functional.normalize(t(rng.normal(size=(3, g, 128))), dim=0)
    floors = (t(np.random.RandomState(0).uniform(0, 1, (64, 128))),
              *tool._rays(g))
    edge = [t(x) for x in case_of(g, seed=g)]
    copies = tool.copies_for(g * 128 // rl.THREADS)
    work = g * 128 * per_lane * copies
    for case, args, iters in (("phase R", (rows, o, d, 1.0 / d),
                               cs.PROBE_ITERS[key]),
                              ("run_phase_floors", floors, 1 << 12)):
        checks = [(a, n, plain(*a, iters=n).view(torch.int32))
                  for a, n in ((args, cs.PROBE_CHECK_ITERS),
                               (args, cs.WRAP_ITERS), (edge, cs.WRAP_ITERS))]
        bound = 1e3 * work * iters / cs.PEAK_FP32_INSTR
        for rep in range(reps):
            line = []
            for label, ctx, _ in runs(libs, "roofline", rl):
                with ctx:
                    for a, n, w in checks:
                        got = probe(*a, iters=n, copies=copies)
                        torch.cuda.synchronize()
                        if not all(torch.equal(c.view(torch.int32), w)
                                   for c in got):
                            raise AssertionError(f"{label} {tag} {case}: a "
                                                 f"copy differs from the "
                                                 f"plain version at {n} pops")
                    ms = cs._events_ms(lambda: probe(
                        *args, iters=iters, copies=copies), 3)
                line.append(f"{label} {ms:.4f} ({bound / ms:.1%})")
            print(f"[{tag} {case}, G={g} x{copies}, {iters} pops] rep {rep}, "
                  f"bound {bound:.4f} ms: " + ", ".join(line) + " ms",
                  flush=True)


GROUPS = ("walks", "mega", "mega-rows", "mega-profile", "subpacket", "dense",
          "cluster-probe", "ilv", "bf16-probe", "multi", "leaf-probe",
          "node-probe")
# The csrc/ sources each group's timings run.
GROUP_SOURCES = {"walks": ("traverse", "cluster_traverse"),
                 "mega": ("megakernel",), "mega-rows": ("megakernel",),
                 "mega-profile": ("megakernel",),
                 "subpacket": ("subpacket_traverse", "traverse"),
                 "dense": ("dense_intersect",), "cluster-probe": ("roofline",),
                 "ilv": ("traverse",), "bf16-probe": ("roofline",),
                 "multi": ("traverse",), "leaf-probe": ("roofline",),
                 "node-probe": ("roofline",)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--checkout", action="append", default=[],
                    metavar="NAME=DIR",
                    help="root of another checkout, built as the variant "
                         "NAME (repeatable)")
    ap.add_argument("--groups", default="walks,mega",
                    help=f"comma-separated timing groups of {GROUPS}")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_walk_variants.py: needs a CUDA device", file=sys.stderr)
        return 1
    names = [v for v in args.variants.split(",") if v]
    for v in names:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}; known: "
                             f"{', '.join(VARIANTS)}")
    groups = [g for g in args.groups.split(",") if g]
    for g in groups:
        if g not in GROUPS:
            raise SystemExit(f"unknown group {g!r}; known: {GROUPS}")
    checkouts = dict(c.split("=", 1) for c in args.checkout)
    CHECKOUT_ROOTS.update(checkouts)
    names += list(checkouts)
    from gpupathtracer_tpu_torch.ops import cuda_build
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    needed = tuple(sorted({s for g in groups for s in GROUP_SOURCES[g]}))
    with ThreadPoolExecutor(len(names) + len(needed)) as pool:
        tree = pool.map(cuda_build.build, needed)
        built = dict(zip(names, pool.map(
            lambda v: build_variant(v, checkouts, needed), names)))
        list(tree)
    for v in names:
        print(f"[{v}] " + (f"the csrc/ of {checkouts[v]}" if v in checkouts
                           else VARIANTS[v][0]))
    if "walks" in groups:
        time_walks(built, args.reps, device)
    if "mega" in groups:
        time_mega(built, args.reps, device)
    if "mega-rows" in groups:
        time_mega_rows(built, args.reps, device)
    if "mega-profile" in groups:
        time_mega_profile(built, args.reps, device)
    if "subpacket" in groups:
        time_subpacket(built, args.reps, device)
    if "dense" in groups:
        time_dense(built, args.reps, device)
    if "cluster-probe" in groups:
        time_cluster_probe(built, args.reps, device)
    if "ilv" in groups:
        time_ilv(built, args.reps, device)
    if "bf16-probe" in groups:
        time_bf16_probe(built, args.reps, device)
    if "multi" in groups:
        time_multi(built, args.reps, device)
    if "leaf-probe" in groups:
        time_floor_probe(built, args.reps, device, node=False)
    if "node-probe" in groups:
        time_floor_probe(built, args.reps, device, node=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
