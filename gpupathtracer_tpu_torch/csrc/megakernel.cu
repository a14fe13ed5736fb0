// The megakernel integrator on Hopper: one thread runs one lane's whole
// path, and with spp > 1 regenerates the pixel's next sample itself.
//
// Replaces the TPU's Pallas kernel
//   gpupathtracer_tpu/ops/megakernel.py:188 _mega_kernel
// (launched by trace_mega, :1308; pallas_call at :1371). Per lane it is that
// kernel's bounce() (:1033-1266) term by term: the regeneration raygen, the
// closest walk with hit-time capture (e1, e2, material id and normal sign
// from the winning leaf slot), emission with the MIS rewrite, NEE (light
// pick from the emitter CDF, barycentric sample, any-hit walk to
// radius - 0.005), the max_bounces == 0 exit, the diffuse/specular pick, the
// tangent frame, two-lobe BSDF sampling and Russian roulette. Its random
// numbers are the TPU kernel's lowbias32 hash of (packet seed, sample,
// bounce, slot, lane index within the packet), so a lane draws what it
// draws there.
//
// The TPU kernel walks a 2048-lane packet with one shared stack and the
// lanes in lockstep; a lane's hits depend only on its own ray (apart from
// exact ties), so here each thread runs its own lane's path: at most
// max_bounces + 2 bounces per sample, spp samples.
//
// On a cluster scene (kCluster, the TPU kernel's cluster=True) both walks
// take the dense cluster leaf (:416-482, :609-645) with each cluster pop
// run by the whole warp, as B4 runs it (cluster_warp.cuh walk_warp, the
// same code): so the bounce loop is warp-convergent there, every lane
// staying in it, and reaching both walks of each step, until no lane of
// its warp has a ray left. The closest walk keeps the winner's
// cluster-local id, and shading reads the winner's C row (parallel to
// e1 x e2) and its signed material float (mat_id + 1) * nsign from the
// cluster block (:1098-1104). The TPU kernel's node-row clamp for cluster
// leaves (:352-358, 556-557) guards a row fetch this walk does not make.
//
// Rounding: the walks make the fused multiply-adds of bvh_walk.cuh; every
// other operation is one IEEE operation in the order of the JAX source
// (--fmad=false, no fast math: IEEE division, correctly rounded sqrtf,
// libdevice sinf/cosf/logf/expf), and rsqrt is 1/sqrtf. The plain torch
// version (ops/megakernel.py trace_mega_plain) makes the same operations,
// so on the card the two agree bit for bit.
//
// What bounds it on an H100: register pressure (the whole estimator is live
// in one thread; PERF.md has each instantiation's ptxas line), the
// dependent row reads of the walks, and divergence as the lanes of a warp
// end their paths at different bounces and walk different subtrees. On
// cluster leaves the slots of each pop are spread over the warp (coalesced
// block loads, no lane's serial 128-slot loop); the warp idles its finished
// lanes. The MT leaves keep one lane a leaf. No persistent threads or path
// pool, no ray sorting, no shared-memory tables.
//
// The MT walks' stack stays a local array (the 768-byte frame of ptxas):
// local memory is laid out thread-interleaved, as B1's shared stack is, and
// L1 caches only the lines a walk touches, the top few entries. A shared
// stack sized by the scene's bound takes its whole depth x threads from the
// SM's 256 KB of L1 and shared memory (about 95 KB at bathroom's bound of
// 37 and five blocks an SM), and the rows' L1 hits go with it: on the rows
// that fill the card it ran 2-3% slower. Threads that pick up the next
// lane when theirs ends ran 2-7% slower; 64 threads a block and register
// caps for five or six blocks an SM gained 2% at most on one row and lost
// up to 5% on others (tools/torch_walk_variants.py, PERF.md section 6).
//
// With kStats (the TPU kernel's with_stats, :364-368, 566-570, 1295-1297)
// each packet also gets its counters [9]: bounce rays, live shadow rays,
// closest node and leaf pops, any-hit node and leaf pops, closest and
// any-hit pops of walks at bounce >= tail_start, and the bounce-loop
// iterations. The TPU kernel counts its packet's shared-stack pops and its
// loop's iterations; here each lane walks and loops alone, so a packet's
// counters are sums over its lanes of each lane's own pops (a tail pop is
// one of a lane at bounce >= tail_start; the TPU kernel takes the packet's
// least live bounce), and slot 8 is the largest lane's iteration count.
// The stats variants are instantiated with NEE only (every bench row).

#include "cluster_warp.cuh"

// Built at the default arity only (ops/cuda_build.py passes no GPT_ARITY
// here): this source reads 8-wide node rows.
static_assert(bvh::kArity == 8, "this source reads 8-wide node rows");

namespace {

using bvh::nan_max;
using bvh::nan_min;

constexpr int kThreads = 128;
constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;  // float32(2 * pi)
constexpr float kSqrtPi = 0x1.c5bf8ap+0f;     // sqrtf(float32(pi))

enum { kTrowbridgeReitz = 0, kBeckmann = 1, kBlinnPhong = 2 };

struct MegaArgs {
  const float* rows;
  const float* cl;      // cluster blocks [Ncl * 8, 3 * tc] (kCluster)
  int tc;
  const float* mats;    // [>= n_mats, 16]
  const float* lights;  // [>= n_lights, 16]
  const float* cdf;     // [>= n_lights]
  const float* params;  // [5] or, with regeneration, [26]
  const float* in0;     // o [n, 3], or pixel_x / width [n]
  const float* in1;     // d [n, 3], or pixel_y / height [n]
  const uint8_t* active;
  const int* seeds;  // one per packet
  int n, packet, depth, max_bounces, n_mats, n_lights, spp;
  float* contrib;            // [n, 3]
  unsigned long long* rays;  // bounce rays + live shadow rays
  int* stats;                // [n / packet, 9] (kStats), zeroed
  int tail_start;            // kStats: first bounce whose pops are the tail's
};

// The lowbias32 uniform of megakernel.py:267-286.
__device__ __forceinline__ float uni(uint32_t seed, int sample, int bounce,
                                     int slot, uint32_t lane32) {
  uint32_t s = seed + (uint32_t)(bounce + 1) * 0x9E3779B9u +
               (uint32_t)sample * 0xC2B2AE35u + (uint32_t)slot * 0x85EBCA6Bu;
  uint32_t x = lane32 ^ s;
  x = x ^ (x >> 16);
  x = x * 0x7FEB352Du;
  x = x ^ (x >> 15);
  x = x * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void normalize3(const float* v, float* out) {
  float inv = 1.0f / sqrtf(nan_max(dot3(v, v), 1e-20f));
  out[0] = v[0] * inv;
  out[1] = v[1] * inv;
  out[2] = v[2] * inv;
}

__device__ __forceinline__ float mis(float top, float bottom) {
  return 1.0f / (1.0f + bottom / nan_max(top, 1e-30f));
}

__device__ __forceinline__ void fresnel(const float* f0, float cos_theta,
                                        float* out) {
  float x = 1.0f - cos_theta;
  float x5 = x * x;
  x5 = x5 * x5 * x;
  for (int a = 0; a < 3; ++a) out[a] = f0[a] + (1.0f - f0[a]) * x5;
}

template <int kModel>
__device__ __forceinline__ float distribution(float rough, float rough2,
                                              float ndm, float ndm2) {
  if (kModel == kTrowbridgeReitz) {
    float divisor = (rough2 - 1.0f) * ndm2 + 1.0f;
    return rough2 / nan_max(kPi * divisor * divisor, 1e-20f);
  } else if (kModel == kBeckmann) {
    float sub = 2.0f * logf(kSqrtPi * rough * nan_max(ndm, 1e-8f));
    float add = (ndm2 - 1.0f) / nan_max(ndm2 * rough2, 1e-20f);
    return expf(add - sub);
  } else {
    float nb = 2.0f / rough - 2.0f;
    return (nb + 1.0f) / kTwoPi * expf(logf(nan_max(ndm, 1e-20f)) * nb);
  }
}

// Half vector in tangent space (radius * (sin, cos), z).
template <int kModel>
__device__ __forceinline__ void sample_microfacet(float rough, float rough2,
                                                  float r0, float r1,
                                                  float* out) {
  float z2;
  if (kModel == kTrowbridgeReitz) {
    z2 = nan_max((1.0f - r0) / (r0 * (rough2 - 1.0f) + 1.0f), 0.0f);
  } else if (kModel == kBeckmann) {
    float g = -rough2 * logf(nan_max(1.0f - r0, 1e-20f));
    z2 = 1.0f / (1.0f + g);
  } else {
    float nb = 2.0f / rough - 2.0f;
    float z = expf(logf(nan_max(r0, 1e-20f)) / (nb + 1.0f));
    z2 = z * z;
  }
  float z = sqrtf(z2);
  float phi = kTwoPi * r1;
  float radius = sqrtf(nan_max(1.0f - z2, 0.0f));
  out[0] = radius * sinf(phi);
  out[1] = radius * cosf(phi);
  out[2] = z;
}

__device__ __forceinline__ float vis_ggx(float rough2, float ndx) {
  return 1.0f /
         nan_max(ndx + sqrtf(rough2 * (1.0f - rough2) * ndx * ndx), 1e-5f);
}

// CalcDiffusePmf (Microfacet.glsl:156-161); also returns f0.
__device__ __forceinline__ float diffuse_pmf(const float* alb, float metal,
                                             float ndo, float* f0) {
  for (int a = 0; a < 3; ++a) f0[a] = 0.04f * (1.0f - metal) + alb[a] * metal;
  float fi[3], fo[3];
  fresnel(f0, 0.5f, fi);
  fresnel(f0, ndo, fo);
  float terms[3];
  for (int a = 0; a < 3; ++a)
    terms[a] = (1.0f - metal) * (1.0f - fi[a]) * (1.0f - fo[a]);
  float lum = (terms[0] + terms[1] + terms[2]) / 3.0f;
  return nan_min(nan_max(lum, 0.0f), 1.0f);
}

template <int kModel>
__device__ __forceinline__ float pdf_mf(float rough, float rough2, float ndm,
                                        float idm) {
  float D = distribution<kModel>(rough, rough2, ndm, ndm * ndm);
  return nan_max(D * ndm / nan_max(4.0f * idm, 1e-20f), 1e-10f);
}

template <int kModel>
__device__ __forceinline__ void bsdf_eval(const float* alb, float metal,
                                          const float* f0, float rough,
                                          float rough2, const float* n,
                                          const float* view, const float* inc,
                                          float ndo, float ndi, float ndm,
                                          float idm, float* out) {
  bool below = dot3(n, inc) < 0.0f || dot3(n, view) < 0.0f;
  float D = distribution<kModel>(rough, rough2, ndm, ndm * ndm);
  float vis = vis_ggx(rough2, ndi) * vis_ggx(rough2, ndo) / 4.0f;
  float fm[3], fi[3], fo[3];
  fresnel(f0, idm, fm);
  fresnel(f0, ndi, fi);
  fresnel(f0, ndo, fo);
  for (int a = 0; a < 3; ++a) {
    float spec = fm[a] * D * vis;
    float diff = alb[a] / kPi * (1.0f - metal) * (1.0f - fi[a]) * (1.0f - fo[a]);
    out[a] = below ? 0.0f : spec + diff;
  }
}

// The closest walk with hit-time capture: t and prim (-1 on a miss), the
// unnormalized geometric normal, the material id and the normal sign.
// kStats counts the walk's pops into *pops. On MT leaves a lane walks alone
// (called only with `on`); on cluster leaves every lane of the warp must
// call it together, lanes without a ray with `on` false (cluster_warp.cuh).
template <bool kCluster, bool kStats = false>
__device__ __forceinline__ int closest_capture(const MegaArgs& g,
                                               const float* o, const float* d,
                                               bool on, float& t, float* gn,
                                               int& mid, float& nsign,
                                               bvh::Pops* pops) {
  if constexpr (kCluster) {
    int win = -1;
    bvh::walk_warp<false, kStats, false>(g.rows, g.cl, g.tc,
                                         bvh::make_ray(o, d), on, g.depth, t,
                                         win, *pops);
    float sm = 0.0f;
    gn[0] = 1.0f;
    gn[1] = gn[2] = 0.0f;
    if (win >= 0) {
      const float* blk = g.cl + (size_t)(win / g.tc) * 8 * 3 * g.tc;
      const int s = win % g.tc, w = 3 * g.tc;
      for (int a = 0; a < 3; ++a) gn[a] = blk[a * w + 2 * g.tc + s];
      sm = blk[7 * w + s];
    }
    nsign = sm < 0.0f ? -1.0f : 1.0f;
    mid = max((int)fabsf(sm) - 1, -1);
    return win;
  } else {
    int stack[bvh::kMaxStack];
    bvh::MtLeaf<false> leaf(g.rows);
    bvh::walk<false, bvh::MtLeaf<false>, kStats>(
        g.rows, bvh::make_ray(o, d), g.depth, t, leaf, pops, stack, 1);
    float e1[3] = {1.0f, 0.0f, 0.0f}, e2[3] = {0.0f, 1.0f, 0.0f};
    mid = 0;
    nsign = 1.0f;
    if (leaf.prim >= 0) {
      for (int a = 0; a < 3; ++a) {
        e1[a] = leaf.slot[3 + a];
        e2[a] = leaf.slot[6 + a];
      }
      mid = __float_as_int(leaf.slot[10]);
      nsign = leaf.slot[11];
    }
    cross3(e1, e2, gn);
    return leaf.prim;
  }
}

// The any-hit walk: true iff something lies within (0, t) along the ray.
// Called as closest_capture is: on cluster leaves by the whole warp.
template <bool kCluster, bool kStats = false>
__device__ __forceinline__ bool occluded(const MegaArgs& g, const float* o,
                                         const float* d, bool on, float t,
                                         bvh::Pops* pops) {
  if constexpr (kCluster) {
    int win = -1;
    bvh::walk_warp<true, kStats, false>(g.rows, g.cl, g.tc,
                                        bvh::make_ray(o, d), on, g.depth, t,
                                        win, *pops);
    return win >= 0;
  } else {
    int stack[bvh::kMaxStack];
    bvh::MtLeaf<true> leaf(g.rows);
    bvh::walk<true, bvh::MtLeaf<true>, kStats>(
        g.rows, bvh::make_ray(o, d), g.depth, t, leaf, pops, stack, 1);
    return leaf.prim >= 0;
  }
}

// A lane's counters (kStats), in the layout of a packet's stats row.
struct LaneStats {
  int ctr[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};

  // Adds one walk's pops: slots 2-3 (closest) or 4-5 (any-hit), and the
  // tail slot 6 or 7 when the walk is at bounce >= tail_start.
  __device__ __forceinline__ void add(const bvh::Pops& p, bool any_hit,
                                      bool tail) {
    int k = any_hit ? 4 : 2;
    ctr[k] += p.node;
    ctr[k + 1] += p.leaf;
    if (tail) ctr[any_hit ? 7 : 6] += p.node + p.leaf;
  }
};

// One thread per lane. A lane that has nothing more to trace is `done`: on
// MT leaves it leaves the loop, on cluster leaves (kCluster) it stays in it
// until no lane of its warp is left, joining both walks of every step with
// no ray, so that each cluster pop is run by the whole warp. Lanes past n
// are done from the start. Each step is one bounce of each live lane.
template <int kModel, bool kNee, bool kRegen, bool kCluster,
          bool kStats = false>
__global__ void __launch_bounds__(kThreads) mega_kernel(MegaArgs g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < g.n;
  unsigned int n_rays = 0;
  LaneStats ls;
  const float* P = g.params;
  const uint32_t seed = in ? (uint32_t)g.seeds[i / g.packet] : 0u;
  const uint32_t lane32 = (uint32_t)(i % g.packet);
  const bool act = in && g.active[i] != 0;
  const float total_area = P[0], nee_pdf = P[1];
  float o[3], d[3], lp[3], tp[3] = {1.0f, 1.0f, 1.0f};
  float ct[3] = {0.0f, 0.0f, 0.0f};
  float pdf0 = 1.0f, pdf1 = 1.0f;
  int b = 0, smp;
  bool alive;
  if (kRegen || !in) {
    for (int a = 0; a < 3; ++a) o[a] = d[a] = lp[a] = 0.0f;
    alive = false;
    smp = -1;
  } else {
    for (int a = 0; a < 3; ++a) {
      o[a] = lp[a] = g.in0[3 * i + a];
      d[a] = g.in1[3 * i + a];
    }
    alive = act;
    smp = 0;
  }
  bool done = !in;
  const int steps =
      kRegen ? g.spp * (g.max_bounces + 2) + 1 : g.max_bounces + 2;
  for (int step = 0; step < steps; ++step) {
    if (kRegen && !done && !alive) {
      if (!act || smp >= g.spp - 1) {
        done = true;
      } else {
        // The pixel's next sample: thin-lens raygen (:1034-1067).
        ++smp;
        float u_j0 = uni(seed, smp, 0, 16, lane32);
        float u_j1 = uni(seed, smp, 0, 17, lane32);
        float u_l0 = uni(seed, smp, 0, 18, lane32);
        float u_l1 = uni(seed, smp, 0, 19, lane32);
        float sx = g.in0[i] + u_j0 * P[24];
        float sy = g.in1[i] + u_j1 * P[25];
        float phi = kTwoPi * u_l0;
        float rd = P[23] * sqrtf(u_l1);
        float rdx = rd * cosf(phi);
        float rdy = rd * sinf(phi);
        float off[3], tgt[3];
        for (int a = 0; a < 3; ++a) {
          off[a] = P[17 + a] * rdx + P[20 + a] * rdy;
          tgt[a] = P[8 + a] + sx * P[11 + a] + sy * P[14 + a] - off[a];
        }
        normalize3(tgt, d);
        for (int a = 0; a < 3; ++a) {
          o[a] = lp[a] = P[5 + a] + off[a];
          tp[a] = 1.0f;
        }
        pdf0 = pdf1 = 1.0f;
        b = 0;
        alive = true;
      }
    }
    if (!alive) done = true;
    if constexpr (kCluster) {
      if (!__any_sync(bvh::kFull, !done)) break;
    } else if (done) {
      break;
    }
    const bool trace = !done;
    if (trace) ++n_rays;

    // Closest walk with hit-time capture.
    float t = 1e20f, nsign, gn[3];
    int mid;
    bvh::Pops pops_c;
    const bool miss = closest_capture<kCluster, kStats>(
                          g, o, d, trace, t, gn, mid, nsign, &pops_c) < 0;
    if constexpr (kStats) {
      if (trace) {
        ++ls.ctr[0];
        ls.add(pops_c, false, b >= g.tail_start);
      }
    }
    float n[3], pos[3], view[3];
    normalize3(gn, n);
    for (int a = 0; a < 3; ++a) {
      n[a] = n[a] * nsign;
      pos[a] = o[a] + d[a] * t + 0.003f * n[a];
      view[a] = -d[a];
    }
    const float ndo = nan_max(dot3(n, view), 0.0f);

    float alb[3] = {0.0f, 0.0f, 0.0f}, emi[3] = {0.0f, 0.0f, 0.0f};
    float rough_g = 0.0f, metal = 0.0f;
    if (mid >= 0 && mid < g.n_mats) {
      const float* row = g.mats + (size_t)mid * 16;
      for (int a = 0; a < 3; ++a) {
        alb[a] = row[a];
        emi[a] = row[5 + a];
      }
      rough_g = row[3];
      metal = row[4];
    }
    const float rough = nan_max(rough_g * rough_g, 1e-4f);
    const float rough2 = rough * rough;

    // L_e with the MIS rewrite (wavefront.py:299-317).
    float dvec[3];
    for (int a = 0; a < 3; ++a) dvec[a] = lp[a] - pos[a];
    float dist2 = nan_max(dot3(dvec, dvec), 1e-12f);
    float old_mis = mis(pdf0, pdf1);
    float factor = 0.5f * fabsf(dot3(n, view)) / dist2;
    float p0n = pdf0 * factor;
    float p1n = pdf1 * factor;
    float idt_scale = p0n / (p0n + p1n + nee_pdf) / nan_max(old_mis, 1e-30f);
    float scale = (kNee && !miss && b != 0) ? idt_scale : 1.0f;
    if (trace) {
      for (int a = 0; a < 3; ++a) {
        float emission = miss ? P[2 + a] : emi[a];
        ct[a] = ct[a] + tp[a] * scale * emission;
      }
    }
    // The rest of the step is the lane's only if it hit something.
    bool cont = trace && !miss;
    if (trace && miss) alive = false;

    float f0[3];
    const float dpmf = diffuse_pmf(alb, metal, ndo, f0);

    if (kNee) {
      float light[3] = {0.0f, 0.0f, 0.0f};
      float so[3] = {0.0f, 0.0f, 0.0f}, ldir[3] = {0.0f, 0.0f, 1.0f};
      float shadow_tmax = 0.0f;
      if (cont) {
        float u_sel = uni(seed, smp, b, 0, lane32);
        float u_t0 = uni(seed, smp, b, 1, lane32);
        float u_t1 = uni(seed, smp, b, 2, lane32);
        float selected = u_sel * total_area;
        int li = 0;
        for (int l = 0; l < g.n_lights; ++l)
          li += g.cdf[l] <= selected ? 1 : 0;
        li = min(max(li, 0), max(g.n_lights - 1, 0));
        float lrow[15];
        for (int c = 0; c < 15; ++c)
          lrow[c] = li < g.n_lights ? g.lights[(size_t)li * 16 + c] : 0.0f;
        const float* lp0 = lrow;
        const float* le1 = lrow + 3;
        const float* le2 = lrow + 6;
        const float* ln = lrow + 9;
        const float* lem = lrow + 12;
        float sr = sqrtf(u_t0);
        float bv = u_t1 * sr;
        float bt = 1.0f - (1.0f - sr) - bv;
        float delta[3];
        for (int a = 0; a < 3; ++a)
          delta[a] = lp0[a] + le1[a] * bv + le2[a] * bt - pos[a];
        float radius = sqrtf(nan_max(dot3(delta, delta), 1e-20f));
        float light_pdf = 1.0f / total_area;
        shadow_tmax = radius - 0.005f;
        float hsum[3], m_h[3];
        for (int a = 0; a < 3; ++a) ldir[a] = delta[a] / radius;
        for (int a = 0; a < 3; ++a) hsum[a] = view[a] + ldir[a];
        normalize3(hsum, m_h);
        float ndi_l = nan_max(dot3(n, ldir), 0.0f);
        float ndm_l = nan_max(dot3(n, m_h), 0.0f);
        float idm_l = nan_max(dot3(ldir, m_h), 0.0f);
        float cos_l = fabsf(-dot3(ln, ldir));
        float r2 = radius * radius;
        float pdf_dir =
            dpmf * ndi_l / kPi +
            (1.0f - dpmf) * pdf_mf<kModel>(rough, rough2, ndm_l, idm_l);
        float bounce_pdf = pdf_dir * cos_l / r2;
        float weight = mis(light_pdf, bounce_pdf);
        float bsdf_l[3];
        bsdf_eval<kModel>(alb, metal, f0, rough, rough2, n, view, ldir, ndo,
                          ndi_l, ndm_l, idm_l, bsdf_l);
        float lscale = ndi_l * cos_l * weight / (light_pdf * r2);
        for (int a = 0; a < 3; ++a)
          light[a] = tp[a] * bsdf_l[a] * lscale * lem[a];
        for (int a = 0; a < 3; ++a) so[a] = pos[a] + 0.001f * n[a];
      }
      const bool shadow =
          cont && (light[0] != 0.0f || light[1] != 0.0f || light[2] != 0.0f);
      bvh::Pops pops_a;
      bool occ = false;
      if constexpr (kCluster) {
        occ = occluded<true, kStats>(g, so, ldir, shadow, shadow_tmax,
                                     &pops_a);
      } else if (shadow) {
        occ = occluded<false, kStats>(g, so, ldir, true, shadow_tmax,
                                      &pops_a);
      }
      if (shadow) {
        ++n_rays;
        if constexpr (kStats) {
          ++ls.ctr[1];
          ls.add(pops_a, true, b >= g.tail_start);
        }
        if (!occ)
          for (int a = 0; a < 3; ++a) ct[a] = ct[a] + light[a];
      }
    }

    if (cont && g.max_bounces == 0) {
      // Pure direct lighting: no continuation (wavefront.py:390-399).
      alive = false;
      cont = false;
    }
    if (!cont) continue;

    // BSDF importance sample (Microfacet.glsl:172-193).
    float u_c = uni(seed, smp, b, 3, lane32);
    float u_s0 = uni(seed, smp, b, 4, lane32);
    float u_s1 = uni(seed, smp, b, 5, lane32);
    float u_rr = uni(seed, smp, b, 6, lane32);
    bool pick_diffuse = u_c < dpmf;
    // Tangent frame (Material.glsl:71-76): helper +X when |n.y| > 0.99.
    bool use_x = fabsf(n[1]) > 0.99f;
    float hx = use_x ? 1.0f : 0.0f;
    float hy = use_x ? 0.0f : 1.0f;
    float th[3] = {hy * n[2], -hx * n[2], hx * n[1] - hy * n[0]};
    float tgt[3], tgb[3];
    normalize3(th, tgt);
    cross3(tgt, n, tgb);
    float radius_d = sqrtf(u_s0);
    float phi_d = kTwoPi * u_s1;
    float loc_d[3] = {radius_d * sinf(phi_d), radius_d * cosf(phi_d),
                      sqrtf(nan_max(1.0f - u_s0, 0.0f))};
    float loc_m[3];
    sample_microfacet<kModel>(rough, rough2, u_s0, u_s1, loc_m);
    float dir_d[3], m_w[3];
    for (int a = 0; a < 3; ++a) {
      dir_d[a] = tgt[a] * loc_d[0] + tgb[a] * loc_d[1] + n[a] * loc_d[2];
      m_w[a] = tgt[a] * loc_m[0] + tgb[a] * loc_m[1] + n[a] * loc_m[2];
    }
    float odm = dot3(view, m_w);
    float inc[3], fsum[3], m_f[3];
    for (int a = 0; a < 3; ++a) {
      float dir_s = 2.0f * odm * m_w[a] - view[a];
      inc[a] = pick_diffuse ? dir_d[a] : dir_s;
      fsum[a] = view[a] + inc[a];
    }
    normalize3(fsum, m_f);
    float ndi_b = nan_max(dot3(n, inc), 0.0f);
    float ndm_b = nan_max(dot3(n, m_f), 0.0f);
    float idm_b = nan_max(dot3(inc, m_f), 0.0f);
    float pdf_d = dpmf * ndi_b / kPi;
    float pdf_s = (1.0f - dpmf) * pdf_mf<kModel>(rough, rough2, ndm_b, idm_b);
    float npdf0 = pick_diffuse ? pdf_d : pdf_s;
    float npdf1 = pick_diffuse ? pdf_s : pdf_d;
    float bsdf_b[3];
    bsdf_eval<kModel>(alb, metal, f0, rough, rough2, n, view, inc, ndo,
                      ndi_b, ndm_b, idm_b, bsdf_b);
    float tscale = ndi_b * mis(npdf0, npdf1) / nan_max(npdf0, 1e-30f);
    float ntp[3];
    for (int a = 0; a < 3; ++a) ntp[a] = tp[a] * bsdf_b[a] * tscale;

    // Russian roulette (Iterative.comp:291-300).
    float continuation = nan_min(
        nan_max(nan_max(ntp[0], nan_max(ntp[1], ntp[2])), 0.0f), 1.0f);
    float inv_c = 1.0f / nan_max(continuation, 1e-12f);
    alive = !(u_rr > continuation || b > g.max_bounces);
    for (int a = 0; a < 3; ++a) {
      tp[a] = ntp[a] * inv_c;
      o[a] = lp[a] = pos[a];
      d[a] = inc[a];
    }
    pdf0 = npdf0;
    pdf1 = npdf1;
    b = b + 1;
  }
  if (in) {
    for (int a = 0; a < 3; ++a) g.contrib[3 * i + a] = ct[a];
    if constexpr (kStats) {
      // A lane's loop iterations are its bounce rays (slot 0).
      int* row = g.stats + (size_t)(i / g.packet) * 9;
      for (int k = 0; k < 8; ++k)
        if (ls.ctr[k]) atomicAdd(row + k, ls.ctr[k]);
      atomicMax(row + 8, ls.ctr[0]);
    }
  }

  // Ray count: a warp sum, a block sum, one 64-bit atomic per block.
  __shared__ unsigned int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    n_rays += __shfl_down_sync(0xFFFFFFFFu, n_rays, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = n_rays;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    atomicAdd(g.rays, total);
  }
}

template <int kModel, bool kNee, bool kRegen, bool kCluster,
          bool kStats = false>
int launch(const MegaArgs& args, cudaStream_t stream) {
  int blocks = (args.n + kThreads - 1) / kThreads;
  mega_kernel<kModel, kNee, kRegen, kCluster, kStats>
      <<<blocks, kThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int kModel, bool kCluster>
int launch_leaf(bool nee, bool regen, const MegaArgs& args,
                cudaStream_t stream) {
  if (args.stats) {
    if (!nee) return -1;  // no stats variant without NEE
    return regen ? launch<kModel, true, true, kCluster, true>(args, stream)
                 : launch<kModel, true, false, kCluster, true>(args, stream);
  }
  if (nee) {
    return regen ? launch<kModel, true, true, kCluster>(args, stream)
                 : launch<kModel, true, false, kCluster>(args, stream);
  }
  return regen ? launch<kModel, false, true, kCluster>(args, stream)
               : launch<kModel, false, false, kCluster>(args, stream);
}

template <int kModel>
int launch_model(bool nee, bool regen, bool cluster, const MegaArgs& args,
                 cudaStream_t stream) {
  return cluster ? launch_leaf<kModel, true>(nee, regen, args, stream)
                 : launch_leaf<kModel, false>(nee, regen, args, stream);
}

}  // namespace

// Plain C interface for ctypes. Returns cudaGetLastError() after the launch
// (0 = launched; -1 = an unknown model, or stats without NEE); the caller
// checks it. n must be > 0, a multiple of packet; *rays must be 0 (the
// kernel adds to it). With cluster, rows is the cluster top tree and cl its
// [Ncl * 8, 3 * tc] blocks. stats, if not null, is the zeroed [n / packet,
// 9] int32 counters (kStats above).
extern "C" {

int gpt_mega_max_stack() { return bvh::kMaxStack; }

int gpt_trace_mega(int model, int nee, int regen, int cluster,
                   const float* rows, const float* cl, int tc,
                   const float* mats, const float* lights, const float* cdf,
                   const float* params, const float* in0, const float* in1,
                   const uint8_t* active, const int* seeds, int n, int packet,
                   int depth, int max_bounces, int n_mats, int n_lights,
                   int spp, float* contrib, unsigned long long* rays,
                   int* stats, int tail_start, void* stream) {
  MegaArgs args{rows,    cl,          tc,     mats,     lights,   cdf,
                params,  in0,         in1,    active,   seeds,    n,
                packet,  depth,       max_bounces, n_mats, n_lights, spp,
                contrib, rays,        stats,  tail_start};
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case kTrowbridgeReitz:
      return launch_model<kTrowbridgeReitz>(nee, regen, cluster, args, s);
    case kBeckmann:
      return launch_model<kBeckmann>(nee, regen, cluster, args, s);
    case kBlinnPhong:
      return launch_model<kBlinnPhong>(nee, regen, cluster, args, s);
  }
  return -1;
}

}  // extern "C"
