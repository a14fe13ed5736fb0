// SBVH builder (Stich et al. 2009 "Spatial Splits in Bounding Volume
// Hierarchies") — the native host component of gpupathtracer_tpu.
//
// Fresh C++17 implementation of the algorithm the reference implements in
// src/core/BVH.cpp:1532-2293 (binned object splits with Wald-2007 centroid
// projection, min-max spatial bins with clipped AABBs, reference
// unsplitting, SAH termination with costTraversal=1.23 / costIntersection=
// 5.33, leaf caps). Exposed through a C ABI consumed via ctypes
// (gpupathtracer_tpu/bvh/cpp.py); output is the BinaryBVH array format that
// the shared Python collapse pass flattens to the 8-wide TPU layout.
//
// Build: g++ -O3 -march=native -shared -fPIC sbvh.cpp -o libsbvh.so

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float kCostTraversal = 1.23f;
constexpr float kCostIntersection = 5.33f;
constexpr int kNumBins = 8;
constexpr int kMaxDepth = 60;
constexpr int kHardLeafCap = 15;  // 4-bit count in the wide-leaf encoding

struct Vec3 {
  float x, y, z;
  float operator[](int i) const { return (&x)[i]; }
  float& operator[](int i) { return (&x)[i]; }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void extend(const Vec3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
  void extend(const AABB& b) { lo = vmin(lo, b.lo); hi = vmax(hi, b.hi); }
  bool valid() const { return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z; }
  // Half surface area, the SAH metric the reference uses (AABB.cpp).
  float halfArea() const {
    if (!valid()) return 0.0f;
    float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    return dx * dy + dy * dz + dz * dx;
  }
  AABB intersect(const AABB& b) const {
    AABB r;
    r.lo = vmax(lo, b.lo);
    r.hi = vmin(hi, b.hi);
    return r;
  }
  Vec3 centroid() const {
    return {(lo.x + hi.x) * 0.5f, (lo.y + hi.y) * 0.5f, (lo.z + hi.z) * 0.5f};
  }
};

struct Ref {
  int32_t tri;
  AABB box;
};

struct Node {
  AABB box;
  int32_t left = -1, right = -1;
  int32_t first = -1, count = 0;  // leaf iff count > 0
};

struct Builder {
  const float* verts;  // [T][9]: three xyz vertices per triangle
  int32_t numTris;
  int32_t maxLeaf;
  bool spatialEnabled;
  bool forceLeaf;  // pack leaves to maxLeaf unconditionally (packet-
                   // traversal trees: pops cost far more than masked
                   // triangle tests, unlike the reference's GPU warps)
  float alpha;

  std::vector<Node> nodes;
  std::vector<int32_t> refsOut;
  float rootArea = 0.0f;
  int32_t numLeaves = 0;
  int32_t maxDepthSeen = 0;
  int32_t spatialSplits = 0;
  // Reference-duplication budget (production-SBVH style): spatial splits
  // stop once duplicates exceed ~30% of the triangle count, bounding memory
  // and leaf blowup on adversarial (long thin triangle) inputs.
  int64_t extraRefs = 0;
  int64_t extraRefBudget = 0;

  Vec3 vert(int tri, int corner) const {
    const float* p = verts + 9 * tri + 3 * corner;
    return {p[0], p[1], p[2]};
  }

  AABB triBox(int tri) const {
    AABB b;
    b.extend(vert(tri, 0));
    b.extend(vert(tri, 1));
    b.extend(vert(tri, 2));
    return b;
  }

  // Clip a triangle to the axis slab [lo, hi] and return the AABB of the
  // clipped polygon (Sutherland-Hodgman against two planes). Used by the
  // spatial-split bin pass and partition (role of BVH.cpp:1836-1883).
  AABB clipTriToSlab(int tri, int axis, float lo, float hi) const {
    Vec3 poly[9];
    int n = 3;
    poly[0] = vert(tri, 0);
    poly[1] = vert(tri, 1);
    poly[2] = vert(tri, 2);
    Vec3 tmp[9];

    auto clip = [&](float plane, bool keepBelow) {
      int m = 0;
      for (int i = 0; i < n; i++) {
        const Vec3& a = poly[i];
        const Vec3& b = poly[(i + 1) % n];
        float da = a[axis] - plane;
        float db = b[axis] - plane;
        bool ina = keepBelow ? (da <= 0) : (da >= 0);
        bool inb = keepBelow ? (db <= 0) : (db >= 0);
        if (ina) tmp[m++] = a;
        if (ina != inb) {
          float t = da / (da - db);
          tmp[m++] = {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
                      a.z + t * (b.z - a.z)};
        }
      }
      n = m;
      std::memcpy(poly, tmp, sizeof(Vec3) * m);
    };

    clip(hi, true);
    if (n == 0) return AABB{};
    clip(lo, false);
    AABB out;
    for (int i = 0; i < n; i++) out.extend(poly[i]);
    return out;
  }

  struct Split {
    float sah = FLT_MAX;
    int axis = -1;
    bool spatial = false;
    int bin = -1;       // object: last bin in the left side
    float plane = 0.0f; // spatial: world-space split plane
    AABB leftBox, rightBox;
  };

  // Binned object split over centroids (role of BVH.cpp:1619-1712); falls
  // back to a full sweep for small nodes (1713-1763) via 32 bins == exact
  // enough at those counts; we keep one binned path for simplicity and use
  // more bins when the node is small.
  Split findObjectSplit(const std::vector<Ref>& refs, const AABB& nodeBox) {
    Split best;
    AABB cb;
    for (const Ref& r : refs) cb.extend(r.box.centroid());
    for (int axis = 0; axis < 3; axis++) {
      float extent = cb.hi[axis] - cb.lo[axis];
      if (extent <= 1e-12f) continue;
      const float k1 = kNumBins * (1.0f - 1e-6f) / extent;  // Wald projection
      AABB binBox[kNumBins];
      int binCount[kNumBins] = {0};
      for (const Ref& r : refs) {
        int b = (int)(k1 * (r.box.centroid()[axis] - cb.lo[axis]));
        b = std::min(std::max(b, 0), kNumBins - 1);
        binBox[b].extend(r.box);
        binCount[b]++;
      }
      // Suffix sweep (right side), then prefix compare.
      AABB suffix[kNumBins];
      int suffixCount[kNumBins + 1] = {0};
      AABB acc;
      for (int b = kNumBins - 1; b >= 0; b--) {
        acc.extend(binBox[b]);
        suffix[b] = acc;
        suffixCount[b] = suffixCount[b + 1] + binCount[b];
      }
      AABB left;
      int leftCount = 0;
      for (int b = 0; b < kNumBins - 1; b++) {
        left.extend(binBox[b]);
        leftCount += binCount[b];
        int rightCount = suffixCount[b + 1];
        if (leftCount == 0 || rightCount == 0) continue;
        float sah = kCostIntersection *
                    (left.halfArea() * leftCount +
                     suffix[b + 1].halfArea() * rightCount);
        if (sah < best.sah) {
          best.sah = sah;
          best.axis = axis;
          best.bin = b;
          best.spatial = false;
          best.leftBox = left;
          best.rightBox = suffix[b + 1];
        }
      }
    }
    return best;
  }

  // Min-max spatial bins with clipped AABBs (role of BVH.cpp:1793-1925).
  Split findSpatialSplit(const std::vector<Ref>& refs, const AABB& nodeBox) {
    Split best;
    for (int axis = 0; axis < 3; axis++) {
      float lo = nodeBox.lo[axis], hi = nodeBox.hi[axis];
      float extent = hi - lo;
      if (extent <= 1e-12f) continue;
      const float invW = kNumBins / extent;
      AABB binBox[kNumBins];
      int entry[kNumBins] = {0}, exit_[kNumBins] = {0};
      for (const Ref& r : refs) {
        int b0 = std::min(std::max((int)((r.box.lo[axis] - lo) * invW), 0),
                          kNumBins - 1);
        int b1 = std::min(std::max((int)((r.box.hi[axis] - lo) * invW), 0),
                          kNumBins - 1);
        entry[b0]++;
        exit_[b1]++;
        if (b0 == b1) {
          binBox[b0].extend(r.box);
        } else {
          for (int b = b0; b <= b1; b++) {
            float slabLo = lo + extent * b / kNumBins;
            float slabHi = lo + extent * (b + 1) / kNumBins;
            AABB clipped = clipTriToSlab(r.tri, axis, slabLo, slabHi);
            if (!clipped.valid()) continue;
            binBox[b].extend(clipped.intersect(r.box));
          }
        }
      }
      AABB suffix[kNumBins];
      int suffixExit[kNumBins + 1] = {0};
      AABB acc;
      for (int b = kNumBins - 1; b >= 0; b--) {
        acc.extend(binBox[b]);
        suffix[b] = acc;
        suffixExit[b] = suffixExit[b + 1] + exit_[b];
      }
      AABB left;
      int leftCount = 0;
      for (int b = 0; b < kNumBins - 1; b++) {
        left.extend(binBox[b]);
        leftCount += entry[b];
        int rightCount = suffixExit[b + 1];
        if (leftCount == 0 || rightCount == 0) continue;
        float sah = kCostIntersection *
                    (left.halfArea() * leftCount +
                     suffix[b + 1].halfArea() * rightCount);
        if (sah < best.sah) {
          best.sah = sah;
          best.axis = axis;
          best.spatial = true;
          best.plane = lo + extent * (b + 1) / kNumBins;
          best.leftBox = left;
          best.rightBox = suffix[b + 1];
        }
      }
    }
    return best;
  }

  void partitionObject(const std::vector<Ref>& refs, const Split& s,
                       std::vector<Ref>& L, std::vector<Ref>& R) {
    AABB cb;
    for (const Ref& r : refs) cb.extend(r.box.centroid());
    float extent = cb.hi[s.axis] - cb.lo[s.axis];
    const float k1 = kNumBins * (1.0f - 1e-6f) / extent;
    for (const Ref& r : refs) {
      int b = (int)(k1 * (r.box.centroid()[s.axis] - cb.lo[s.axis]));
      b = std::min(std::max(b, 0), kNumBins - 1);
      (b <= s.bin ? L : R).push_back(r);
    }
    if (L.empty() || R.empty()) {  // numeric fallback: median
      L.clear();
      R.clear();
      std::vector<Ref> tmp = refs;
      int axis = s.axis >= 0 ? s.axis : 0;
      std::nth_element(tmp.begin(), tmp.begin() + tmp.size() / 2, tmp.end(),
                       [axis](const Ref& a, const Ref& b) {
                         return a.box.centroid()[axis] < b.box.centroid()[axis];
                       });
      L.assign(tmp.begin(), tmp.begin() + tmp.size() / 2);
      R.assign(tmp.begin() + tmp.size() / 2, tmp.end());
    }
  }

  // Spatial partition with reference unsplitting (Stich §4.4; role of
  // BVH.cpp:1927-1983): straddling refs either duplicate (clipped into both
  // children) or, when cheaper by SAH, go whole into one side.
  void partitionSpatial(const std::vector<Ref>& refs, const Split& s,
                        std::vector<Ref>& L, std::vector<Ref>& R) {
    AABB BL = s.leftBox, BR = s.rightBox;
    int NL = 0, NR = 0;
    for (const Ref& r : refs) {
      if (r.box.hi[s.axis] <= s.plane) NL++;
      else if (r.box.lo[s.axis] >= s.plane) NR++;
      else { NL++; NR++; }
    }
    for (const Ref& r : refs) {
      if (r.box.hi[s.axis] <= s.plane) {
        L.push_back(r);
      } else if (r.box.lo[s.axis] >= s.plane) {
        R.push_back(r);
      } else {
        float csplit = BL.halfArea() * NL + BR.halfArea() * NR;
        AABB blr = BL; blr.extend(r.box);
        AABB brr = BR; brr.extend(r.box);
        float cleft = blr.halfArea() * NL + BR.halfArea() * (NR - 1);
        float cright = BL.halfArea() * (NL - 1) + brr.halfArea() * NR;
        if (cleft < csplit && cleft <= cright) {
          BL = blr; NR--;
          L.push_back(r);
        } else if (cright < csplit) {
          BR = brr; NL--;
          R.push_back(r);
        } else {
          AABB cl = clipTriToSlab(r.tri, s.axis, -FLT_MAX, s.plane);
          AABB cr = clipTriToSlab(r.tri, s.axis, s.plane, FLT_MAX);
          Ref rl = r, rr = r;
          rl.box = cl.intersect(r.box);
          rr.box = cr.intersect(r.box);
          bool both = rl.box.valid() && rr.box.valid();
          if (rl.box.valid()) L.push_back(rl); else NL--;
          if (rr.box.valid()) R.push_back(rr); else NR--;
          if (both) extraRefs++;
        }
      }
    }
    if (L.empty() || R.empty()) {
      // Degenerate: fall back to object-median partition.
      L.clear(); R.clear();
      Split m; m.axis = s.axis; m.bin = -1;
      partitionObject(refs, m, L, R);
    }
  }

  void makeLeaf(int nodeIdx, const std::vector<Ref>& refs) {
    nodes[nodeIdx].first = (int32_t)refsOut.size();
    nodes[nodeIdx].count = (int32_t)refs.size();
    for (const Ref& r : refs) refsOut.push_back(r.tri);
    numLeaves++;
  }

  void build() {
    std::vector<Ref> rootRefs(numTris);
    AABB rootBox;
    for (int i = 0; i < numTris; i++) {
      rootRefs[i].tri = i;
      rootRefs[i].box = triBox(i);
      rootBox.extend(rootRefs[i].box);
    }
    rootArea = rootBox.halfArea();
    extraRefBudget = (int64_t)numTris * 3 / 10;
    nodes.reserve((size_t)numTris * 2 + 2);
    refsOut.reserve((size_t)numTris * 5 / 4);

    struct Task {
      int32_t node;
      int depth;
      std::vector<Ref> refs;
      AABB box;
    };
    std::vector<Task> stack;
    nodes.push_back({});
    nodes[0].box = rootBox;
    stack.push_back({0, 1, std::move(rootRefs), rootBox});

    while (!stack.empty()) {
      Task t = std::move(stack.back());
      stack.pop_back();
      maxDepthSeen = std::max(maxDepthSeen, t.depth);
      nodes[t.node].box = t.box;
      int n = (int)t.refs.size();

      if (n <= 1 || (t.depth >= kMaxDepth && n <= kHardLeafCap)
          || (forceLeaf && n <= maxLeaf)) {
        makeLeaf(t.node, t.refs);
        continue;
      }

      Split best;
      bool forced = t.depth >= kMaxDepth;  // must reduce below the hard cap
      if (!forced) {
        best = findObjectSplit(t.refs, t.box);
        // Spatial-split trigger: child overlap exceeds alpha * root area
        // (BVH.cpp:2011-2022, alpha = 1e-5), gated by the duplication budget.
        if (spatialEnabled && best.axis >= 0 && extraRefs < extraRefBudget) {
          AABB overlap = best.leftBox.intersect(best.rightBox);
          if (overlap.valid() && overlap.halfArea() > alpha * rootArea) {
            Split sp = findSpatialSplit(t.refs, t.box);
            if (sp.sah < best.sah) best = sp;
          }
        }
        // Subdivision test (BVH.cpp:2123-2126). A node with no viable SAH
        // split (e.g. coincident centroids) may only become a leaf if it
        // fits the leaf cap — otherwise fall through to the median split.
        float leafCost = kCostIntersection * n;
        float splitCost = kCostTraversal +
                          best.sah / std::max(t.box.halfArea(), 1e-20f);
        if (n <= maxLeaf &&
            (best.axis < 0 || splitCost >= leafCost)) {
          makeLeaf(t.node, t.refs);
          continue;
        }
      }

      std::vector<Ref> L, R;
      L.reserve(n / 2 + 1);
      R.reserve(n / 2 + 1);
      if (forced || best.axis < 0) {
        // Median split on the widest axis to guarantee progress.
        Split m;
        AABB cb;
        for (const Ref& r : t.refs) cb.extend(r.box.centroid());
        int axis = 0;
        float w = -1;
        for (int a = 0; a < 3; a++) {
          float e = cb.hi[a] - cb.lo[a];
          if (e > w) { w = e; axis = a; }
        }
        m.axis = axis;
        m.bin = -1;
        partitionObject(t.refs, m, L, R);
      } else if (best.spatial) {
        spatialSplits++;
        partitionSpatial(t.refs, best, L, R);
      } else {
        partitionObject(t.refs, best, L, R);
      }
      t.refs.clear();
      t.refs.shrink_to_fit();

      int32_t li = (int32_t)nodes.size();
      nodes.push_back({});
      int32_t ri = (int32_t)nodes.size();
      nodes.push_back({});
      nodes[t.node].left = li;
      nodes[t.node].right = ri;
      AABB lb, rb;
      for (const Ref& r : L) lb.extend(r.box);
      for (const Ref& r : R) rb.extend(r.box);
      stack.push_back({li, t.depth + 1, std::move(L), lb});
      stack.push_back({ri, t.depth + 1, std::move(R), rb});
    }
  }

  double treeCost() const {
    // Whole-tree SAH (role of CalculateCost, BVH.cpp:2174-2195).
    double total = 0.0;
    for (const Node& nd : nodes) {
      float sa = nd.box.halfArea();
      total += (nd.count > 0 ? kCostIntersection * nd.count : kCostTraversal) * sa;
    }
    return total / std::max((double)rootArea, 1e-20);
  }

  // --- Insertion-based tree optimization (Bittner et al. 2013) ----------
  //
  // The reference implements node removal + upward refit but leaves the
  // reinsertion loop body empty and the call commented out
  // (src/core/BVH.cpp:2303-2397, 2216) — this completes that roadmap item.
  // Each pass detaches high-surface-area subtrees and re-inserts them at
  // the globally best position found by a best-first branch-and-bound
  // search over SA growth (the standard formulation). Pop counts in the
  // packet traversal are surface-area-weighted (the TPU record,
  // docs/PERF_TPU_history.md), so upper-tree SA reduction is the lever this
  // targets.

  void refitUp(std::vector<int32_t>& parent, int32_t n) {
    while (n >= 0) {
      Node& nd = nodes[n];
      if (nd.count <= 0) {
        AABB b = nodes[nd.left].box;
        b.extend(nodes[nd.right].box);
        nd.box = b;
      }
      n = parent[n];
    }
  }

  // Best sibling for a floating subtree with box `nb`: minimizes
  // direct cost (SA of the new parent) + induced cost (ancestor SA
  // growth). Returns -1 if nothing beats `bound`.
  int32_t findBestSibling(const AABB& nb, float bound,
                          std::vector<std::pair<float, int32_t>>& heap) {
    float nbArea = nb.halfArea();
    float best = bound;
    int32_t bestS = -1;
    heap.clear();
    heap.push_back({0.0f, 0});
    while (!heap.empty()) {
      std::pop_heap(heap.begin(), heap.end(),
                    [](const auto& a, const auto& b) { return a.first > b.first; });
      auto [induced, s] = heap.back();
      heap.pop_back();
      if (induced + nbArea >= best) break;  // min-heap: no candidate can win
      AABB u = nodes[s].box;
      u.extend(nb);
      float direct = u.halfArea();
      if (s != 0 && induced + direct < best) {  // root stays at index 0
        best = induced + direct;
        bestS = s;
      }
      if (nodes[s].count <= 0) {
        float childInduced = induced + (direct - nodes[s].box.halfArea());
        if (childInduced + nbArea < best) {
          heap.push_back({childInduced, nodes[s].left});
          std::push_heap(heap.begin(), heap.end(),
                         [](const auto& a, const auto& b) { return a.first > b.first; });
          heap.push_back({childInduced, nodes[s].right});
          std::push_heap(heap.begin(), heap.end(),
                         [](const auto& a, const auto& b) { return a.first > b.first; });
        }
      }
    }
    return bestS;
  }

  void optimize(int rounds) {
    if (rounds <= 0 || nodes.size() < 8) return;
    std::vector<int32_t> parent(nodes.size(), -1);
    for (size_t i = 0; i < nodes.size(); i++) {
      if (nodes[i].count <= 0) {
        parent[nodes[i].left] = (int32_t)i;
        parent[nodes[i].right] = (int32_t)i;
      }
    }
    std::vector<std::pair<float, int32_t>> heap;
    std::vector<std::pair<float, int32_t>> order;
    for (int round = 0; round < rounds; round++) {
      // Candidates: internal nodes by descending SA (skip root + its
      // children: their parents cannot be detached).
      order.clear();
      for (size_t i = 1; i < nodes.size(); i++) {
        if (nodes[i].count <= 0 && parent[i] != 0) {
          order.push_back({nodes[i].box.halfArea(), (int32_t)i});
        }
      }
      std::sort(order.begin(), order.end(),
                [](const auto& a, const auto& b) { return a.first > b.first; });
      size_t batch = order.size() / 10 + 1;  // top 10% per pass
      int moved = 0;
      for (size_t c = 0; c < batch && c < order.size(); c++) {
        int32_t n = order[c].second;
        int32_t p = parent[n];
        if (p <= 0) continue;  // re-check: tree mutates within the pass
        int32_t g = parent[p];
        int32_t sib = nodes[p].left == n ? nodes[p].right : nodes[p].left;
        // Current contribution of keeping n where it is: the SA of p plus
        // whatever the ancestors shrink by if n leaves. Detach, measure,
        // and only commit when the best new position beats putting it back.
        (nodes[g].left == p ? nodes[g].left : nodes[g].right) = sib;
        parent[sib] = g;
        refitUp(parent, g);
        // Cost of undoing the removal = re-pairing with the old sibling.
        AABB back = nodes[sib].box;
        back.extend(nodes[n].box);
        // Ancestor growth of re-inserting at sib (computed against the
        // already-refit tree, same frame as the search).
        float backInduced = 0.0f;
        {
          AABB acc = back;
          for (int32_t a = g; a >= 0; a = parent[a]) {
            AABB u = nodes[a].box;
            float before = u.halfArea();
            u.extend(acc);
            backInduced += u.halfArea() - before;
            acc = u;
          }
        }
        float bound = back.halfArea() + backInduced;
        int32_t s = findBestSibling(nodes[n].box, bound, heap);
        if (s < 0) s = sib;  // nothing strictly better: restore
        else moved++;
        int32_t sp = parent[s];
        nodes[p].left = n;
        nodes[p].right = s;
        AABB u = nodes[n].box;
        u.extend(nodes[s].box);
        nodes[p].box = u;
        (nodes[sp].left == s ? nodes[sp].left : nodes[sp].right) = p;
        parent[p] = sp;
        parent[s] = p;
        parent[n] = p;
        refitUp(parent, sp);
      }
      if (moved == 0) break;
    }
    // Depth changed arbitrarily: recompute (iterative DFS).
    maxDepthSeen = 0;
    std::vector<std::pair<int32_t, int>> st{{0, 1}};
    while (!st.empty()) {
      auto [n, d] = st.back();
      st.pop_back();
      maxDepthSeen = std::max(maxDepthSeen, d);
      if (nodes[n].count <= 0) {
        st.push_back({nodes[n].left, d + 1});
        st.push_back({nodes[n].right, d + 1});
      }
    }
  }
};

}  // namespace

extern "C" {

void* sbvh_build(const float* verts, int32_t num_tris, int32_t max_leaf,
                 int32_t spatial, int32_t force_leaf, float alpha,
                 int32_t reinsert_rounds,
                 int32_t* out_num_nodes,
                 int32_t* out_num_refs, int32_t* out_num_leaves,
                 int32_t* out_max_depth, int32_t* out_spatial_splits,
                 double* out_sah) {
  auto* b = new Builder();
  b->verts = verts;
  b->numTris = num_tris;
  b->maxLeaf = std::min(std::max(max_leaf, 1), kHardLeafCap);
  b->spatialEnabled = spatial != 0;
  b->forceLeaf = force_leaf != 0;
  b->alpha = alpha;
  b->build();
  b->optimize(reinsert_rounds);
  *out_num_nodes = (int32_t)b->nodes.size();
  *out_num_refs = (int32_t)b->refsOut.size();
  *out_num_leaves = b->numLeaves;
  *out_max_depth = b->maxDepthSeen;
  *out_spatial_splits = b->spatialSplits;
  *out_sah = b->treeCost();
  return b;
}

void sbvh_copy(void* handle, float* bmin, float* bmax, int32_t* left,
               int32_t* right, int32_t* first, int32_t* count,
               int32_t* refs) {
  auto* b = (Builder*)handle;
  for (size_t i = 0; i < b->nodes.size(); i++) {
    const Node& nd = b->nodes[i];
    bmin[3 * i] = nd.box.lo.x; bmin[3 * i + 1] = nd.box.lo.y; bmin[3 * i + 2] = nd.box.lo.z;
    bmax[3 * i] = nd.box.hi.x; bmax[3 * i + 1] = nd.box.hi.y; bmax[3 * i + 2] = nd.box.hi.z;
    left[i] = nd.left;
    right[i] = nd.right;
    first[i] = nd.first;
    count[i] = nd.count;
  }
  std::memcpy(refs, b->refsOut.data(), b->refsOut.size() * sizeof(int32_t));
}

void sbvh_free(void* handle) { delete (Builder*)handle; }

}  // extern "C"
