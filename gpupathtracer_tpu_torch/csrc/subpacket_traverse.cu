// Sub-packet traversal on Hopper: a packet of K = G * 128 rays walks the
// tree as G sub-packets of 128 rays, each on one shared node stack and leaf
// backlog, and the packet runs one node phase or one leaf phase at a time.
//
// Replaces the TPU's Pallas kernel
//   gpupathtracer_tpu/ops/subpacket_traverse.py:58 _kernel
// over the merged 128-float row table (bvh_walk.cuh). The TPU kernel holds
// the G sub-packets of a packet in the sublane rows of one kernel instance
// and decides once per iteration, for all of them, whether to pop a node or
// a leaf (:107-114): the leaf phase when the backlogs hold G leaves or more
// in sum, when one holds LEAF_TRIG = 24 or more, or when no node is left.
// In a leaf phase every sub-packet with a backlog pops one leaf, in a node
// phase every sub-packet with a node pops one node; the others idle.
//
// Here a packet is one block and a sub-packet one warp, four rays a lane
// (ray lane + 32 q of the sub-packet, q < 4), the rays in registers:
//   - each sub-packet's node stack and leaf backlog live in shared memory;
//     its two stack pointers are warp-uniform registers during its turn;
//   - a popped row (512 B) is staged in the warp's own shared slice by one
//     16-byte load a lane; each lane then slab-tests its four rays against
//     the 8 children (bvh::child_hit) or runs Moller-Trumbore on the leaf's
//     slots (bvh::mt_slot, a slot as three 16-byte shared loads, the four
//     rays slot by slot): B1's arithmetic, so every field stays bitwise its
//     plain version's;
//   - "does any ray enter child j" is one __any_sync; with `ordered`, the
//     child with the smallest entry distance over the sub-packet's rays
//     (lowest slot among equals) comes from warp shuffles and is pushed
//     last, so that it pops first; the others go in slot order, node
//     children to the node stack, leaf children to the backlog. No block
//     barrier runs inside a pop;
//   - the phase: every warp publishes its sub-packets' (node, leaf) stack
//     sizes to shared memory, one __syncthreads() follows, and every warp
//     computes the same decision from all G of them. The sizes are double
//     buffered, so that one barrier an iteration is enough.
// A block has at most kMaxWarps warps: with G > kMaxWarps each warp runs
// its sub-packets s = warp, warp + kMaxWarps, ... in turn within an
// iteration (the kMulti instantiations), loading a sub-packet's rays at its
// turn and keeping t, prim, u, v in the output arrays between turns. With
// G <= kMaxWarps the rays stay in registers: the kMulti path there costs
// 3-18% more (PERF.md section 6).
//
// The any-hit exit: after a leaf pop, a sub-packet whose active rays are
// all occluded empties both its stacks (the TPU kernel checks every
// sub-packet in a leaf phase; one that popped no leaf there had no ray
// occluded since its last check, so the check changes nothing for it).
//
// What bounds it on an H100: the union of 128 rays' paths (incoherent rays
// pop far more entries than one ray alone would), the dependent row read
// of each pop (mostly from L2), and the packet's lockstep: an iteration
// lasts as long as its slowest warp's pop, and a warp with nothing of the
// phase's kind idles through it. K = 2048 gives one block of 16 warps a
// packet, so 131,072 rays are 64 blocks, fewer than the 132 SMs.

#include "bvh_walk.cuh"

// Built at the default arity only (ops/cuda_build.py passes no GPT_ARITY
// here): this source reads 8-wide node rows.
static_assert(bvh::kArity == 8, "this source reads 8-wide node rows");

namespace {

constexpr int kLanes = 128;              // rays a sub-packet
constexpr int kPerLane = kLanes / 32;    // rays a lane
constexpr int kMaxWarps = 16;            // warps (sub-packets at once) a block
constexpr int kLeafDepth = 32;           // LEAF_DEPTH
constexpr int kLeafTrig = kLeafDepth - 8;  // LEAF_TRIG
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// A warp's 128 rays: ray lane + 32 q of sub-packet s.
struct Rays {
  bvh::Ray r[kPerLane];
  float t[kPerLane], u[kPerLane], v[kPerLane];
  int prim[kPerLane];
  bool act[kPerLane];
};

struct Args {
  const float* rows;
  const float* o;
  const float* d;
  const float* t_max;
  const uint8_t* active;
  int depth, leaf_size, ordered, group;
  float* t_out;
  int* prim_out;
  float* u_out;
  float* v_out;
  int* stats;
};

__device__ __forceinline__ int ray_index(int sub, int lane, int q) {
  return sub * kLanes + q * 32 + lane;
}

// Sub-packet `sub`'s rays with their current results: the initial ones
// (fresh) or those kept in the output arrays.
__device__ __forceinline__ void load_rays(const Args& g, int sub, int lane,
                                          bool fresh, Rays& s) {
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int i = ray_index(sub, lane, q);
    s.r[q] = bvh::load_ray(g.o, g.d, i);
    s.act[q] = g.active[i] != 0;
    if (fresh) {
      s.t[q] = g.t_max[i];
      s.prim[q] = -1;
      s.u[q] = s.v[q] = 0.0f;
    } else {
      s.t[q] = g.t_out[i];
      s.prim[q] = g.prim_out[i];
      s.u[q] = g.u_out[i];
      s.v[q] = g.v_out[i];
    }
  }
}

__device__ __forceinline__ void store_rays(const Args& g, int sub, int lane,
                                           const Rays& s) {
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int i = ray_index(sub, lane, q);
    g.t_out[i] = s.t[q];
    g.prim_out[i] = s.prim[q];
    g.u_out[i] = s.u[q];
    g.v_out[i] = s.v[q];
  }
}

// Stages the 512-byte row `r` in the warp's slice: one 16-byte load a lane.
__device__ __forceinline__ void stage_row(const float* __restrict__ rows,
                                          int r, float* row, int lane) {
  __syncwarp();  // the previous pop's reads of the slice are done
  reinterpret_cast<float4*>(row)[lane] =
      bvh::load4(rows + (size_t)r * bvh::kRow + 4 * lane);
  __syncwarp();
}

template <bool kAnyHit>
__device__ __forceinline__ bool ray_on(const Rays& s, int q) {
  return kAnyHit ? s.act[q] && s.prim[q] < 0 : s.act[q];
}

// One node pop of a sub-packet: the row's 8 children against its rays,
// then the pushes (the same in every lane; lane 0 writes them).
template <bool kAnyHit>
__device__ __forceinline__ void node_pop(const Args& g, const Rays& s,
                                         float* row, int* nstack,
                                         int* lstack, int& nsp, int& lsp,
                                         int lane) {
  const int entry = nstack[--nsp];
  stage_row(g.rows, entry, row, lane);
  // The 32 slab tests of a lane are independent: written without branches,
  // so that they overlap.
  bool on[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) on[q] = ray_on<kAnyHit>(s, q);
  unsigned bits = 0;
  float key[bvh::kArity];
#pragma unroll
  for (int j = 0; j < bvh::kArity; ++j) {
    bool hit = false;
    float k = inf();
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      float tmin = 0.0f;
      const bool h = on[q] & bvh::child_hit(row, j, s.r[q], s.t[q], tmin);
      hit |= h;
      k = h ? fminf(k, tmin) : k;
    }
    bits |= (__any_sync(kFull, hit) ? 1u : 0u) << j;
    key[j] = k;
  }
  int near = bvh::kArity;
  if (g.ordered && bits) {
    // The lowest slot among the children at the smallest entry distance.
    float keymin = inf();
#pragma unroll
    for (int j = bvh::kArity - 1; j >= 0; --j) {
      float k = key[j];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        k = fminf(k, __shfl_xor_sync(kFull, k, m));
      if (k <= keymin && k < inf()) {
        keymin = k;
        near = j;
      }
    }
  }
  // Entered children in slot order, the nearest last. Pushes past the end
  // of a stack are dropped.
#pragma unroll
  for (int k = 0; k <= bvh::kArity; ++k) {
    const int j = k < bvh::kArity ? k : near;
    if (j == bvh::kArity || (k < bvh::kArity && j == near) ||
        !((bits >> j) & 1u))
      continue;
    const int child = __float_as_int(row[6 * bvh::kArity + j]);
    if (child < 0) {
      if (lsp < kLeafDepth) {
        if (lane == 0) lstack[lsp] = child;
        ++lsp;
      }
    } else if (nsp < g.depth) {
      if (lane == 0) nstack[nsp] = child;
      ++nsp;
    }
  }
  __syncwarp();  // the pushes are visible to the warp
}

// One leaf pop of a sub-packet: Moller-Trumbore of its rays on the leaf's
// slots (every slot, also for any-hit: the TPU kernel records the leaf's
// nearest hit); then, for any-hit, a sub-packet whose active rays are all
// occluded stops.
template <bool kAnyHit>
__device__ __forceinline__ void leaf_pop(const Args& g, Rays& s, float* row,
                                         int* lstack, int& nsp, int& lsp,
                                         int lane) {
  const int packed = -(lstack[--lsp] + 1);
  stage_row(g.rows, packed >> 4, row, lane);
  const int count = min(packed & 15, g.leaf_size);
  bool on[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) on[q] = ray_on<kAnyHit>(s, q);
  // Slot by slot, the lane's four rays at once (each ray still tests the
  // slots in order: bvh::intersect_leaf's results).
  for (int k = 0; k < count; ++k) {
    const float* p = row + 12 * k;
    const float4 s0 = bvh::load4<false>(p), s1 = bvh::load4<false>(p + 4),
                 s2 = bvh::load4<false>(p + 8);
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      float tt, uu, vv;
      if (bvh::mt_slot(s0, s1, s2, s.r[q], s.t[q], tt, uu, vv) && on[q]) {
        s.t[q] = tt;
        s.prim[q] = __float_as_int(s2.y);
        s.u[q] = uu;
        s.v[q] = vv;
      }
    }
  }
  if (kAnyHit) {
    bool live = false;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) live |= s.act[q] && s.prim[q] < 0;
    if (!__any_sync(kFull, live)) nsp = lsp = 0;
  }
}

// One block a packet of `group` sub-packets, one warp a sub-packet at a
// time (kMulti: several in turn). Dynamic shared memory: the warps' row
// slices (16-byte aligned), the sub-packets' double-buffered stack sizes
// (8-byte aligned), then per sub-packet its node stack (depth) and its
// leaf backlog.
template <bool kAnyHit, bool kMulti>
__global__ void __launch_bounds__(32 * kMaxWarps)
subpacket_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  const int G = g.group, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* row = smem + warp * bvh::kRow;
  int2* sizes = reinterpret_cast<int2*>(smem + warps * bvh::kRow);  // [2][G]
  int* nstacks = reinterpret_cast<int*>(sizes + 2 * G);
  int* lstacks = nstacks + G * g.depth;
  const int sub0 = blockIdx.x * G;  // the packet's first sub-packet

  // The root for every sub-packet that has an active ray.
  Rays s;
  for (int b = warp; b < G; b += warps) {
    load_rays(g, sub0 + b, lane, true, s);
    bool any = false;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) any |= s.act[q];
    if (kMulti) store_rays(g, sub0 + b, lane, s);
    const bool on = __any_sync(kFull, any);
    if (lane == 0) {
      nstacks[b * g.depth] = 0;
      sizes[b] = make_int2(on ? 1 : 0, 0);
    }
  }
  __syncthreads();

  int node_pops = 0, leaf_pops = 0, buf = 0;
  for (;;) {
    // The packet's phase, from every sub-packet's stack sizes.
    int tot_n = 0, tot_l = 0;
    bool hi = false;
    for (int b = lane; b < G; b += 32) {
      const int2 z = sizes[buf * G + b];
      tot_n += z.x;
      tot_l += z.y;
      hi |= z.y >= kLeafTrig;
    }
    tot_n = __reduce_add_sync(kFull, tot_n);
    tot_l = __reduce_add_sync(kFull, tot_l);
    hi = __any_sync(kFull, hi);
    if (tot_n + tot_l == 0) break;
    const bool leaf_phase =
        tot_l > 0 && (tot_n == 0 || tot_l >= G || hi);

    for (int b = warp; b < G; b += warps) {
      const int2 z = sizes[buf * G + b];
      int nsp = z.x, lsp = z.y;
      if (leaf_phase ? lsp > 0 : nsp > 0) {
        if (kMulti) load_rays(g, sub0 + b, lane, false, s);
        if (leaf_phase) {
          ++leaf_pops;
          leaf_pop<kAnyHit>(g, s, row, lstacks + b * kLeafDepth, nsp, lsp,
                            lane);
          if (kMulti) store_rays(g, sub0 + b, lane, s);
        } else {
          ++node_pops;
          node_pop<kAnyHit>(g, s, row, nstacks + b * g.depth,
                            lstacks + b * kLeafDepth, nsp, lsp, lane);
        }
      }
      if (lane == 0) sizes[(buf ^ 1) * G + b] = make_int2(nsp, lsp);
    }
    __syncthreads();  // every sub-packet's sizes are published
    buf ^= 1;
  }

  if (!kMulti) store_rays(g, sub0 + warp, lane, s);
  if (g.stats && lane == 0 && (node_pops || leaf_pops)) {
    atomicAdd(g.stats + 2 * blockIdx.x, node_pops);
    atomicAdd(g.stats + 2 * blockIdx.x + 1, leaf_pops);
  }
}

template <bool kAnyHit, bool kMulti>
int launch(const Args& g, int packets, cudaStream_t stream) {
  const int warps = min(g.group, kMaxWarps);
  const size_t smem =
      sizeof(float) * warps * bvh::kRow +
      sizeof(int) * (size_t)g.group * (g.depth + kLeafDepth) +
      sizeof(int2) * 2 * g.group;
  auto kernel = subpacket_kernel<kAnyHit, kMulti>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<packets, 32 * warps, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. n, the number of rays, is a positive
// multiple of 128 * group (group = G, the sub-packets of a packet); stats,
// if not null, is [n / (128 * group), 2] int32, zeroed, and receives
// (node pops, leaf pops) per packet. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" {

int gpt_subpacket_max_stack() { return bvh::kMaxStack; }

int gpt_trace_subpacket(const float* rows, const float* o, const float* d,
                        const float* t_max, const uint8_t* active, int n,
                        int depth, int leaf_size, int any_hit, int ordered,
                        int group, float* t, int* prim, float* u, float* v,
                        int* stats, void* stream) {
  const Args g{rows, o,     d,     t_max, active, depth, leaf_size, ordered,
               group, t,    prim,  u,     v,      stats};
  const int packets = n / (kLanes * group);
  cudaStream_t s = (cudaStream_t)stream;
  const bool multi = group > kMaxWarps;
  if (any_hit)
    return multi ? launch<true, true>(g, packets, s)
                 : launch<true, false>(g, packets, s);
  return multi ? launch<false, true>(g, packets, s)
               : launch<false, false>(g, packets, s);
}

}  // extern "C"
