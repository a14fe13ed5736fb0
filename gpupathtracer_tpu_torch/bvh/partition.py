"""Scene partitioning for multi-device traversal: devices own subtrees
(a copy of the JAX package's bvh/partition.py, numpy only; its outputs are
held byte for byte to the original's by tests/test_torch_partition.py).

The mesh path (parallel/mesh.py) replicates the scene on every device: it
scales samples, not scene size. Here each device holds ONE group of
subtrees of the merged row table, and rays migrate between devices
(parallel/partition.py: a ring of point-to-point shifts, or demand-routed
all-to-all rounds).

Partition construction (host, numpy):
  1. Cut the wide tree into >= D subtree roots balanced by REACHABLE ROW
     COUNT (_row_cut; the treelet cut's area-greedy frontier can leave one
     subtree holding half the table).
  2. Group the cut entries into exactly D groups with a weight-balanced
     recursive kd split of their centroids ("spatial", the default; "lpt"
     balances row counts only).
  3. Replicate the K highest-demand entries (default K=6) into EVERY
     device's hop-0 root, served on each ray's home device only; a second
     steady root without them serves hops >= 1.
  4. For each group, extract the reachable rows into a compact local
     table headed by the synthetic root rows: the walk kernel then
     traverses the local forest from entry 0 (or the steady root), as it
     walks any whole-tree table.

The reference has no counterpart (a single GPU).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from gpupathtracer_tpu_torch.bvh.types import INVALID_ENTRY


class Partition(NamedTuple):
    """Device-sharded traversal tables (numpy; shard leading axis over the
    mesh device axis)."""

    tables: np.ndarray      # [D, M', 128] f32 per-device merged row tables
    dev_bounds: np.ndarray  # [D, 6] f32 union AABB of each device's
    #                         steady forest (routes hops >= 1)
    num_rows: np.ndarray    # [D] i32 live rows per device (<= M')
    dev_bounds0: np.ndarray = None  # [D, 6] hop-0 forest union (steady +
    #                                 replicated hot subtrees)
    steady_root: np.ndarray = None  # [D] i32 root row for hops >= 1
    #                                 (row 0 is always the hop-0 root)


def _collect_rows(entry: int, entry_all: np.ndarray, W: int,
                  rows_out: list, seen: set):
    """DFS from one cut entry, appending reachable row ids (node rows and
    leaf rows share the merged-table index space)."""
    stack = [int(entry)]
    while stack:
        e = stack.pop()
        if e < 0:
            packed = -(e + 1)
            row = packed >> 4
            if row not in seen:
                seen.add(row)
                rows_out.append(row)
            continue
        if e in seen:
            continue
        seen.add(e)
        rows_out.append(e)
        for j in range(8):
            c = int(entry_all[e, j])
            if c != INVALID_ENTRY:
                stack.append(c)


def _row_cut(node_rows: np.ndarray, W: int, entry_all: np.ndarray,
             num_devices: int):
    """Cut the tree by REACHABLE ROW COUNT, not surface area.

    The treelet machinery's area-greedy cut (bvh/treelet.py) optimizes for
    ray demand; for device load balance it can leave one subtree holding
    half the table at any target (measured on proc:sponza: max 24.7k of
    49.9k rows). Here the frontier entry with the most reachable rows is
    expanded until no subtree exceeds ~total/(2D) (or the 8*D root budget
    that the per-device synthetic root rows allow is exhausted).

    Returns (entries [C], bounds [C, 6], counts [C])."""
    D = int(num_devices)
    bounds_all = node_rows[:W, 0:48].reshape(W, 8, 6)

    from functools import lru_cache

    @lru_cache(maxsize=None)
    def rowcount(e: int) -> int:
        if e < 0:
            return 1
        n = 1
        for j in range(8):
            c = int(entry_all[e, j])
            if c != INVALID_ENTRY:
                n += rowcount(c)
        return n

    # Iterative pre-pass so deep trees don't blow the recursion limit.
    stack = [0]
    post = []
    seen = set()
    while stack:
        e = stack.pop()
        if e < 0 or e in seen:
            continue
        seen.add(e)
        post.append(e)
        for j in range(8):
            c = int(entry_all[e, j])
            if c != INVALID_ENTRY and c >= 0:
                stack.append(c)
    for e in reversed(post):
        rowcount(e)

    total = rowcount(0)
    budget = max(total // (2 * D), 1)
    frontier = []  # (-count, tiebreak, entry, bounds)
    import heapq
    tb = 0
    for j in range(8):
        e = int(entry_all[0, j])
        if e != INVALID_ENTRY:
            heapq.heappush(frontier, (-rowcount(e), tb, e, bounds_all[0, j]))
            tb += 1
    while frontier and len(frontier) < 8 * D:
        negc, _, e, bb = frontier[0]
        if e < 0 or -negc <= budget:
            break  # balanced enough (the heap top is the max subtree)
        heapq.heappop(frontier)
        for j in range(8):
            c = int(entry_all[e, j])
            if c != INVALID_ENTRY:
                heapq.heappush(frontier, (-rowcount(c), tb, c,
                                          bounds_all[e, j]))
                tb += 1
    items = [(e, bb, -negc) for negc, _, e, bb in frontier]
    if not items:
        items = [(0, np.array([-np.inf] * 3 + [np.inf] * 3, np.float32),
                  total)]
    entries = np.asarray([e for e, _, _ in items], np.int32)
    bounds = np.stack([bb for _, bb, _ in items]).astype(np.float32)
    counts = np.asarray([c for _, _, c in items], np.int64)
    return entries, bounds, counts


def _group_spatial(cut_bounds: np.ndarray, weights: np.ndarray, D: int):
    """Weight-balanced recursive spatial split of the cut entries.

    The LPT packing below balances row counts but ignores GEOMETRY, so a
    device's forest AABB can span the whole scene — and the routing mask
    of parallel/partition.py passes whenever a ray's slab enters that
    union, which measured as V = 5-6.3 of 8 hops actually traversing
    (PERF.md partition statistics). Here entries are split recursively by
    the weighted median of their centroids along the widest axis: groups
    stay spatially compact (small forest unions -> fewer slab passes)
    while carrying ~equal reachable-row weight.
    """
    cent = 0.5 * (cut_bounds[:, 0:3] + cut_bounds[:, 3:6])

    def split(idx, d):
        if d == 1 or len(idx) <= 1:
            return [list(idx)]
        d1 = d // 2
        ext = cent[idx].max(0) - cent[idx].min(0)
        axis = int(np.argmax(ext))
        order = idx[np.argsort(cent[idx, axis], kind="stable")]
        cw = np.cumsum(weights[order])
        target = cw[-1] * d1 / d
        k = int(np.searchsorted(cw, target)) + 1
        k = min(max(k, 1), len(order) - 1)
        return split(order[:k], d1) + split(order[k:], d - d1)

    groups = split(np.arange(len(cut_bounds)), D)
    while len(groups) < D:  # fewer entries than devices: pad empty groups
        groups.append([])
    return [[int(i) for i in g] for g in groups]


def _demand_weights(cut_bounds: np.ndarray, n_rays: int = 8192,
                    seed: int = 17, rays=None) -> np.ndarray:
    """Per-cut-entry routed-demand estimate: the fraction of a ray
    population whose slab enters the entry's bounds — numerically the
    same test trace_partitioned_local routes with (unbounded t).
    Default population: random interior rays (origins uniform in the
    scene bounds, directions uniform on the sphere) — the incoherent
    bounce-wavefront stand-in. Pass `rays=(o, d)` (numpy [n, 3] each) to
    estimate against the actual workload instead, e.g. camera primaries
    mixed with random bounces (PERF.md replicate-hot follow-up: the
    coherent-primary pops barrier concentrates on the camera-facing
    subtrees, which random demand does not select). Host-side numpy,
    ~C x n_rays slab tests."""
    if rays is not None:
        o = np.asarray(rays[0], np.float32)
        d = np.asarray(rays[1], np.float32)
    else:
        rng = np.random.RandomState(seed)
        lo = cut_bounds[:, 0:3].min(0)
        hi = cut_bounds[:, 3:6].max(0)
        o = rng.uniform(lo, hi, (n_rays, 3)).astype(np.float32)
        d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    t0 = (cut_bounds[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (cut_bounds[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    hit = (tn <= tf) & (tf > 0.0)
    return hit.sum(0).astype(np.float64) + 1.0


def node_bucket_map(node_rows: np.ndarray, num_wide_nodes: int,
                    cut_entry: np.ndarray) -> np.ndarray:
    """[W] i32 map: wide-node index -> index of the cut entry whose
    subtree contains it (len(cut_entry) for nodes above the cut). Feeds
    ops/traverse.py count_entry_visits for pops-attributed demand."""
    W = int(num_wide_nodes)
    entry_all = node_rows[:W, 48:56].copy().view(np.int32)
    C = len(cut_entry)
    bucket = np.full((W,), C, np.int32)
    for ci, e in enumerate(cut_entry):
        stack = [int(e)]
        while stack:
            x = stack.pop()
            if x < 0 or x >= W or bucket[x] != C:
                continue
            bucket[x] = ci
            for j in range(8):
                c = int(entry_all[x, j])
                if c != INVALID_ENTRY and c >= 0:
                    stack.append(c)
    return bucket


def partition_cut(node_rows: np.ndarray, num_wide_nodes: int,
                  num_devices: int):
    """The (entries, bounds) cut build_partition partitions over —
    exposed so callers can compute pilot demand per entry first."""
    W = int(num_wide_nodes)
    entry_all = node_rows[:W, 48:56].copy().view(np.int32)
    e, b, _ = _row_cut(node_rows, W, entry_all, int(num_devices))
    return e, b


def _repair_group_caps(group_of, sizes, cap: int) -> None:
    """Enforce the synthetic-root cap in place: a two-level (8x8) root
    holds at most 64 children, so each group may keep at most
    cap = 64 - len(hot) steady entries. The kd/LPT grouping balances by
    WEIGHT, not count, so an adversarially skewed cut can overfill one
    group — repair by moving the smallest members (fewest reachable
    rows) to the emptiest groups. Grouping is a performance heuristic;
    correctness needs only exactly-once coverage and the root cap."""
    total = sum(len(g) for g in group_of)
    if total > max(cap, 0) * len(group_of):
        raise ValueError(f"{total} steady cut entries exceed "
                         f"{len(group_of)} chips x {cap} roots "
                         f"(replicate_hot too large?)")
    for g in range(len(group_of)):
        while len(group_of[g]) > cap:
            m = min(group_of[g], key=lambda i: sizes[i])
            group_of[g].remove(m)
            group_of[int(np.argmin([len(x) for x in group_of]))].append(m)


def build_partition(node_rows: np.ndarray, num_wide_nodes: int,
                    num_devices: int, grouping: str = "spatial",
                    replicate_hot: int = 6,
                    demand_rays=None, hot_entries=None) -> Partition:
    """Split the merged table into `num_devices` compact local tables.

    8-wide tables only (the partitioned renderer builds with the default
    wide_arity; see _entries()/_root_row() layout offsets).

    grouping: "spatial" (default; weight-balanced kd split of the cut —
    measured V = 1.80 incoherent closest vs 5.01 for "lpt",
    PERF.md partition statistics) or "lpt" (pure row-count balance);
    "spatial-area"/"demand" are measured losses kept for the record.

    replicate_hot: copy the K highest-demand cut entries (host random-ray
    slab estimate, _demand_weights) into EVERY device's table, served
    EXCLUSIVELY at hop 0: row 0 of each table becomes a hop-0 root
    (steady members + the K hot subtrees) and `steady_root` points at a
    second synthetic root WITHOUT them, used on hops >= 1 — including on
    the hot entries' former owner, so each ray traverses each hot
    subtree exactly once, on its HOME chip. The per-hop barrier skew is
    intrinsic demand concentration (PERF.md: re-weighting the kd split
    measured as a loss); replication spreads the concentrated demand
    uniformly over all D chips (every chip serves its own resident shard
    at hop 0) and the early-found hit tightens `t` for every later
    hop's route mask — trading VMEM headroom (+K subtree copies/chip)
    for barrier balance. Default K=6, the measured sweet spot of the
    K-sweep (PERF.md replicate-hot table: wall proxy -17% incoherent
    closest / -43% any-hit vs K=0 at flat total pops, +23% rows/chip;
    K=8 doubles the tables for marginal gain, K=12 regresses).

    demand_rays: optional (o, d) numpy arrays — the ray population for
    the demand estimate (hot selection and grouping="demand" weights);
    default is the random interior stand-in. Pass the actual workload
    (e.g. camera primaries + random bounces) when known; the partition
    is rebuilt per scene load, where the camera is available.

    hot_entries: optional explicit cut-entry indices (into
    partition_cut's entries, same order) to replicate — overrides the
    slab-demand selection; used with pops-attributed pilot demand
    (ops/traverse.py count_entry_visits + node_bucket_map), which sees
    traversal depth the slab estimate cannot."""
    D = int(num_devices)
    W = int(num_wide_nodes)
    entry_all = node_rows[:W, 48:56].copy().view(np.int32)

    cut_entry, cut_bounds, _ = _row_cut(node_rows, W, entry_all, D)
    C = len(cut_entry)
    replicate_hot = max(0, min(int(replicate_hot), C - 1))

    # Reachable row count per cut entry (for balancing).
    sub_rows = []
    for e in cut_entry:
        rows, seen = [], set()
        _collect_rows(int(e), entry_all, W, rows, seen)
        sub_rows.append(rows)

    w_demand = None  # computed at most once (grouping and/or hot selection)
    if grouping in ("spatial", "spatial-area", "demand"):
        if grouping == "spatial-area":
            # MEASURED LOSS (PERF.md): bare AABB half-area does not track
            # routed demand (barrier 2.00 vs 1.81, padded table +50%).
            ext = np.maximum(cut_bounds[:, 3:6] - cut_bounds[:, 0:3], 0.0)
            w = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                 + ext[:, 0] * ext[:, 2])
        elif grouping == "demand":
            # Profile-guided balance: estimate each cut entry's routed
            # demand by slab-testing a fixed random-ray sample (the
            # incoherent bounce-ray stand-in) against its bounds — the
            # same mask parallel/partition.py routes with, so group
            # weights equalize the expected per-hop barrier directly.
            w_demand = _demand_weights(cut_bounds, rays=demand_rays)
            w = w_demand
        else:
            w = np.asarray([len(r) for r in sub_rows], np.float64)
        group_of = _group_spatial(cut_bounds, w, D)
    else:
        # LPT bin packing into D groups by reachable row count. A group may
        # hold more than 8 roots: the synthetic root grows a second level
        # (up to 64 roots) when needed.
        order = np.argsort([-len(r) for r in sub_rows])
        group_of = [[] for _ in range(D)]
        load = [0] * D
        for i in order:
            g = int(np.argmin(load))
            group_of[g].append(int(i))
            load[g] += len(sub_rows[i])

    def _synth_row(child_bounds, child_entries):
        row = np.zeros((128,), node_rows.dtype)
        rootb = np.zeros((8, 6), np.float32)
        rootb[:, 0:3] = np.inf   # empty slots: inverted box + INVALID entry
        rootb[:, 3:6] = -np.inf
        roote = np.full((8,), INVALID_ENTRY, np.int32)
        for j, (bb, e) in enumerate(zip(child_bounds, child_entries)):
            rootb[j] = bb
            roote[j] = e
        row[0:48] = rootb.reshape(-1)
        row[48:56] = roote.view(np.float32)
        return row

    hot: list = []
    if hot_entries is not None:
        # Stable-dedup: a duplicate index would emit the same subtree
        # twice into every hop-0 root (double pops per ray).
        hot = list(dict.fromkeys(
            int(h) for h in hot_entries if 0 <= int(h) < C))
    elif replicate_hot > 0:
        if w_demand is None:
            w_demand = _demand_weights(cut_bounds, rays=demand_rays)
        hot = [int(h) for h in np.argsort(-w_demand)[:replicate_hot]]
    if hot:
        hot_set = set(hot)
        # Hot entries leave their owner's steady set — they are served at
        # hop 0 on every ray's home chip instead.
        group_of = [[i for i in g if i not in hot_set] for g in group_of]

    _repair_group_caps(group_of, {i: len(sub_rows[i]) for g in group_of
                                  for i in g}, 64 - len(hot))

    def _n_synth(members) -> int:
        """Synthetic rows a root over `members` needs (1 or two-level)."""
        return 1 + ((len(members) + 7) // 8 if len(members) > 8 else 0)

    def _bounds_union(members, out_row):
        if members:
            out_row[0:3] = cut_bounds[members][:, 0:3].min(0)
            out_row[3:6] = cut_bounds[members][:, 3:6].max(0)
        else:
            # Empty forest (tiny scene / all-hot group): a far-away point
            # box whose slab entry always exceeds t_max, so no ray ever
            # routes here. (An inverted +-inf box would HIT under the
            # per-axis min/max slab formulation; empty child slots get
            # away with it only because their INVALID entries are
            # filtered after the slab test.)
            out_row[0:3] = 1e30
            out_row[3:6] = 1e30

    # Build each device's table: synthetic root(s) + remapped rows.
    locals_ = []
    dev_bounds = np.zeros((D, 6), np.float32)
    dev_bounds0 = np.zeros((D, 6), np.float32)
    steady_root = np.zeros((D,), np.int32)
    num_rows = np.zeros((D,), np.int32)
    for g in range(D):
        steady = group_of[g]
        hop0 = steady + hot  # disjoint by construction
        if max(len(hop0), len(steady)) > 64:
            raise ValueError(f"partition group {g} has {len(hop0)} "
                             f"roots; two-level synthetic root caps at 64")
        rows = []
        for i in hop0:
            rows.extend(sub_rows[i])
        rows = list(dict.fromkeys(rows))  # stable unique
        # Row layout: [0, b0) = hop-0 root (+ its second level), then —
        # only when hot subtrees are replicated — [b0, base) = the steady
        # root used on hops >= 1, then the content rows.
        b0 = _n_synth(hop0)
        base = b0 + (_n_synth(steady) if hot else 0)
        remap = {old: new + base for new, old in enumerate(rows)}
        table = np.zeros((base + len(rows), 128), node_rows.dtype)

        def _remap_entry(e: int) -> int:
            if e < 0:
                packed = -(e + 1)
                return -((remap[packed >> 4] << 4) | (packed & 15)) - 1
            return remap[e]

        def _emit_root(at: int, members) -> None:
            n_l2 = (len(members) + 7) // 8 if len(members) > 8 else 0
            if n_l2 == 0:
                table[at] = _synth_row([cut_bounds[i] for i in members],
                                       [_remap_entry(int(cut_entry[i]))
                                        for i in members])
                return
            l2_bounds = []
            for k in range(n_l2):
                chunk = members[k * 8:(k + 1) * 8]
                table[at + 1 + k] = _synth_row(
                    [cut_bounds[i] for i in chunk],
                    [_remap_entry(int(cut_entry[i])) for i in chunk])
                bb = np.concatenate([
                    cut_bounds[chunk][:, 0:3].min(0),
                    cut_bounds[chunk][:, 3:6].max(0)])
                l2_bounds.append(bb)
            table[at] = _synth_row(l2_bounds,
                                   list(range(at + 1, at + 1 + n_l2)))

        _emit_root(0, hop0)
        if hot:
            steady_root[g] = b0
            _emit_root(b0, steady)
        for old in rows:
            new = remap[old]
            table[new] = node_rows[old]
            if old < W:  # node row: rewrite child entries
                ent = table[new, 48:56].copy().view(np.int32)
                for j in range(8):
                    if ent[j] != INVALID_ENTRY:
                        ent[j] = _remap_entry(int(ent[j]))
                table[new, 48:56] = ent.view(np.float32)
        locals_.append(table)
        num_rows[g] = table.shape[0]
        _bounds_union(steady, dev_bounds[g])
        _bounds_union(hop0, dev_bounds0[g])

    Mp = max(t.shape[0] for t in locals_)
    Mp = max(Mp, 2)
    tables = np.zeros((D, Mp, 128), node_rows.dtype)
    for g, t in enumerate(locals_):
        tables[g, :t.shape[0]] = t
    return Partition(tables=tables, dev_bounds=dev_bounds,
                     num_rows=num_rows, dev_bounds0=dev_bounds0,
                     steady_root=steady_root)
