// Sub-packet traversal on Hopper: 128 rays walk the tree together on one
// shared stack.
//
// Replaces the TPU's Pallas kernel
//   gpupathtracer_tpu/ops/subpacket_traverse.py:58 _kernel
// over the merged 128-float row table (bvh_walk.cuh). The TPU kernel holds G
// independent 128-ray sub-packets in the sublane rows of one kernel
// instance, each with a node stack and a leaf backlog, and runs one node
// phase or one leaf phase per iteration for all G. Here a sub-packet is one
// block of 128 threads (4 warps), one ray a thread:
//   - the node stack and the leaf backlog live in shared memory, the stack
//     pointers in registers (every thread computes the same pushes; thread
//     0 writes them);
//   - a popped row is staged in shared memory by one coalesced 512-byte
//     read, then every thread slab-tests its ray against the 8 children or
//     runs Moller-Trumbore on the leaf's slots (bvh::child_hit,
//     bvh::intersect_leaf, each slot as three 16-byte shared loads: B1's
//     arithmetic);
//   - "does any ray enter child j" is a __ballot_sync per warp and an OR of
//     the 4 warps' bytes through shared memory (the TPU packs these bits
//     into words for its scalar core); with `ordered`, the child with the
//     smallest entry distance over the sub-packet's rays (warp shuffles,
//     then the 4 warps' minima) is pushed last so that it pops first, the
//     others in slot order;
//   - node children go to the node stack, leaf children to the backlog.
// Phase choice: the TPU decides once for its G sub-packets (leaf phase when
// the backlogs hold G leaves or more, one reaches 24, or no node is left).
// A block decides for itself, by that rule at G = 1: it drains a leaf
// whenever its backlog holds one. The candidate set of every ray is the
// same, so every closest t is; which of two triangles at bitwise-equal t
// wins can differ from a G > 1 run, and so can the pop counts.
//
// What bounds it on an H100: the union of 128 rays' paths (incoherent rays
// pop far more entries than one ray alone would) times three block-wide
// barriers per pop; the table comes from L2.

#include "bvh_walk.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr int kLeafDepth = 32;  // a node pop adds at most 8 leaves

template <bool kAnyHit>
__global__ void __launch_bounds__(kLanes)
subpacket_kernel(const float* __restrict__ rows, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ t_max,
                 const uint8_t* __restrict__ active, int depth, int leaf_size,
                 int ordered, int group, float* __restrict__ t_out,
                 int* __restrict__ prim_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, int* __restrict__ stats) {
  __shared__ int nstack[bvh::kMaxStack];
  __shared__ int lstack[kLeafDepth];
  __shared__ __align__(16) float row[bvh::kRow];  // 16-byte slot loads
  __shared__ int warp_bits[kWarps];
  __shared__ float warp_key[kWarps][bvh::kArity];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kLanes + tid;
  const bvh::Ray r = bvh::load_ray(o, d, i);
  const bool act = active[i];
  float t = t_max[i], u = 0.0f, v = 0.0f;
  int prim = -1;
  const float* slot = nullptr;

  // The root, if any ray of the sub-packet is active.
  int nsp = __syncthreads_or(act) ? 1 : 0, lsp = 0;
  if (tid == 0) nstack[0] = 0;
  int node_pops = 0, leaf_pops = 0;
  __syncthreads();

  while (nsp + lsp > 0) {
    const bool on = kAnyHit ? act && prim < 0 : act;
    if (lsp > 0) {
      // ---- leaf iteration: Moller-Trumbore on one backlogged leaf --------
      int packed = -(lstack[--lsp] + 1);
      ++leaf_pops;
      row[tid] = rows[(size_t)(packed >> 4) * bvh::kRow + tid];
      __syncthreads();
      // Every slot is tested, also for any-hit (the TPU kernel records the
      // leaf's nearest hit there too); the ray then stops walking.
      if (on)
        bvh::intersect_leaf<false>(row, min(packed & 15, leaf_size), r,
                                   false, t, prim, u, v, slot);
      // Any-hit: a sub-packet whose active rays are all occluded stops.
      if (kAnyHit) {
        if (__syncthreads_and(!act || prim >= 0)) nsp = lsp = 0;
      } else {
        __syncthreads();  // the row has been read
      }
      continue;
    }
    // ---- node iteration: slab tests of one node's 8 children -------------
    int entry = nstack[--nsp];
    ++node_pops;
    row[tid] = rows[(size_t)entry * bvh::kRow + tid];
    __syncthreads();
    int bits = 0;
    for (int j = 0; j < bvh::kArity; ++j) {
      float tmin = 0.0f;
      bool hit = on && bvh::child_hit(row, j, r, t, tmin);
      if (__ballot_sync(0xffffffffu, hit)) bits |= 1 << j;
      if (ordered) {
        float key = hit ? tmin : __int_as_float(0x7f800000);
        for (int s = 16; s > 0; s >>= 1)
          key = fminf(key, __shfl_xor_sync(0xffffffffu, key, s));
        if (lane == 0) warp_key[warp][j] = key;
      }
    }
    if (lane == 0) warp_bits[warp] = bits;
    __syncthreads();
    bits = 0;
    for (int w = 0; w < kWarps; ++w) bits |= warp_bits[w];
    int near = bvh::kArity;
    if (ordered) {
      // The lowest slot among the children at the smallest entry distance.
      float keymin = __int_as_float(0x7f800000);
      for (int j = bvh::kArity - 1; j >= 0; --j) {
        float key = warp_key[0][j];
        for (int w = 1; w < kWarps; ++w) key = fminf(key, warp_key[w][j]);
        if (key <= keymin && key < __int_as_float(0x7f800000)) {
          keymin = key;
          near = j;
        }
      }
    }
    // Pushes, the same in every thread: entered children in slot order, the
    // nearest last. Pushes past the end of a stack are dropped.
    for (int k = 0; k <= bvh::kArity; ++k) {
      int j = k < bvh::kArity ? k : near;
      if (j == bvh::kArity || (k < bvh::kArity && j == near) ||
          !((bits >> j) & 1))
        continue;
      int child = __float_as_int(row[6 * bvh::kArity + j]);
      if (child < 0) {
        if (lsp < kLeafDepth) {
          if (tid == 0) lstack[lsp] = child;
          ++lsp;
        }
      } else if (nsp < depth) {
        if (tid == 0) nstack[nsp] = child;
        ++nsp;
      }
    }
    __syncthreads();  // the pushes are visible, the row has been read
  }

  t_out[i] = t;
  prim_out[i] = prim;
  u_out[i] = u;
  v_out[i] = v;
  if (stats && tid == 0) {
    atomicAdd(stats + 2 * (blockIdx.x / group), node_pops);
    atomicAdd(stats + 2 * (blockIdx.x / group) + 1, leaf_pops);
  }
}

}  // namespace

// Plain C interface for ctypes. n, the number of rays, is a positive
// multiple of 128; stats, if not null, is [n / (128 * group), 2] int32,
// zeroed, and receives (node pops, leaf pops) per `group` sub-packets.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" {

int gpt_subpacket_max_stack() { return bvh::kMaxStack; }

int gpt_trace_subpacket(const float* rows, const float* o, const float* d,
                        const float* t_max, const uint8_t* active, int n,
                        int depth, int leaf_size, int any_hit, int ordered,
                        int group, float* t, int* prim, float* u, float* v,
                        int* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    subpacket_kernel<true><<<n / kLanes, kLanes, 0, s>>>(
        rows, o, d, t_max, active, depth, leaf_size, ordered, group, t, prim,
        u, v, stats);
  else
    subpacket_kernel<false><<<n / kLanes, kLanes, 0, s>>>(
        rows, o, d, t_max, active, depth, leaf_size, ordered, group, t, prim,
        u, v, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
