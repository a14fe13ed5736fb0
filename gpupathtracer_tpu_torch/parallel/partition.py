"""Partitioned multi-device traversal: rays migrate, devices own subtrees
(counterpart of the JAX package's parallel/partition.py).

bvh/partition.py splits the merged BVH table into D per-device subtree
tables; rank c of the "chips" process group holds table c alone. A ray
shard starts on its home rank; every rank traverses its resident rays
against its local subtree with B1 (ops/kernel_traverse.py), masked to the
rays whose slab entry into this rank's forest bounds is closer than their
best hit so far, and the rays move on:

- RING (``trace_partitioned_local``, the default): the shards rotate
  around the ranks (comm.ring_shift, a send to rank + 1 and a receive from
  rank - 1), D hops; a last rotation carries the hit payload alone home.
- DEMAND-ROUTED (``trace_partitioned_routed``): rays hop only to the
  ranks they still need, nearest unvisited forest first, through fixed
  [D, B] buckets and one all-to-all a round. Receiver capacity is
  guaranteed by a credit (an all-gather of free-slot counts), rays denied
  transport retry, and rays that finish go home and deliver their hit
  into a slot-stable output.

Both give every ray the globally closest hit (any hit for occlusion);
the routed trace gives the ring's hits bit for bit. Every rank of the
group must call the same functions with the same shapes, in the same
order, as every device of the JAX ``shard_map`` runs one program.

With hot-subtree replication (bvh/partition.py ``replicate_hot``) hop 0
serves the home shard against the hop-0 root (steady members + the
replicated hot subtrees), and later hops start B1 at the steady root
(``roots``, one start entry a packet).

Role in the reference: none (a single GPU).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gpupathtracer_tpu_torch.bvh.partition import Partition
from gpupathtracer_tpu_torch.ops import kernel_traverse
from gpupathtracer_tpu_torch.ops.traverse import Hit, _safe_inv
from gpupathtracer_tpu_torch.parallel import comm

LANES = 128  # the packet granule of the local traces (the TPU's lanes)


class RouteInfo(NamedTuple):
    """Replicated routing metadata: the steady forest union of every rank
    (hops >= 1), the hop-0 forest union (steady + replicated hot
    subtrees) and each rank's steady root row."""

    dev_bounds: torch.Tensor   # [D, 6] f32
    dev_bounds0: torch.Tensor  # [D, 6] f32
    steady_root: torch.Tensor  # [D] i32


def shard_partition(part: Partition, group=None, device="cpu"):
    """(this rank's table [M_c, 128], RouteInfo) on ``device``: rank c of
    ``group`` keeps ``part.tables[c]`` (its live rows) and the routing
    metadata, replicated."""
    c, D = comm.axis_index(group), comm.axis_size(group)
    if part.tables.shape[0] != D:
        raise ValueError(f"the partition has {part.tables.shape[0]} tables "
                         f"for {D} ranks")
    rows = int(part.num_rows[c])
    table = torch.as_tensor(np.ascontiguousarray(part.tables[c, :rows]),
                            device=device)
    db = torch.as_tensor(part.dev_bounds, device=device)
    db0 = (torch.as_tensor(part.dev_bounds0, device=device)
           if part.dev_bounds0 is not None else db)
    sroot = (torch.as_tensor(part.steady_root, dtype=torch.int32,
                             device=device)
             if part.steady_root is not None
             else torch.zeros(D, dtype=torch.int32, device=device))
    return table, RouteInfo(db, db0, sroot)


def _split_route(dev_bounds):
    if isinstance(dev_bounds, RouteInfo):
        return dev_bounds.dev_bounds, dev_bounds.dev_bounds0, \
            dev_bounds.steady_root
    return dev_bounds, dev_bounds, None


def _slab(lo, hi, o, inv):
    """(t entry, t exit) of rays o, inv [n, 3] into boxes lo, hi [.., 3]
    broadcast against them."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    return (torch.amax(torch.minimum(t0, t1), dim=-1),
            torch.amin(torch.maximum(t0, t1), dim=-1))


def _local_trace(table, o, d, t_max, active, *, stack_depth: int,
                 leaf_size: int, packet_size: int, any_hit: bool,
                 root: Optional[int] = None, with_pops: bool = False):
    """One rank's B1 trace of its resident rays against its local subtree,
    from row 0 or, with ``root``, from that row (the steady root: one start
    entry for each K-ray packet). The rays are padded to a multiple of K =
    max(128, floor(min(packet_size, n) / 128) * 128) as the JAX package
    pads them. Returns (t, prim, u, v, pops): for any-hit t stays t_max and
    prim is 0 where the ray is occluded, -1 elsewhere; pops (with
    ``with_pops``) is the node plus leaf pops of every ray, a 0-d tensor.
    """
    n = o.shape[0]
    K = max(LANES, (min(packet_size, n) // LANES) * LANES)
    pad = (-n) % K
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        dpad = d.new_zeros((pad, 3))
        dpad[:, 0] = 1.0
        d = torch.cat([d, dpad])
        t_max = torch.cat([t_max, t_max.new_zeros(pad)])
        active = torch.cat([active, active.new_zeros(pad)])
    roots = None
    if root is not None:
        roots = torch.full(((n + pad) // K,), int(root), dtype=torch.int32,
                           device=o.device)
    kw = dict(stack_depth=stack_depth, leaf_size=leaf_size,
              with_stats=with_pops, roots=roots,
              packet=K if roots is not None else None)
    rays = (o.contiguous(), d.contiguous(), t_max.contiguous(),
            active.contiguous())
    if any_hit:
        out = kernel_traverse.anyhit(table, *rays, **kw)
        occ = out[0] if with_pops else out
        t, u = t_max, t_max.new_zeros(n + pad)
        prim = torch.where(occ, 0, -1).to(torch.int32)
        v = u
    else:
        out = kernel_traverse.closest(table, *rays, **kw)
        t, prim, u, v = out[:4]
    pops = out[-1][:n].sum() if with_pops else None
    return t[:n], prim[:n], u[:n], v[:n], pops


def trace_partitioned_local(table, dev_bounds, o, d, t_max, active, *,
                            group=None, num_devices: int, stack_depth: int,
                            leaf_size: int, packet_size: int = 2048,
                            any_hit: bool = False, with_stats: bool = False):
    """The ring; every rank of ``group`` calls it with its resident shard.

    Args:
      table: this rank's local subtree table [M_c, 128].
      dev_bounds: [D, 6] forest bounds of every rank, or a RouteInfo.
      o, d, t_max, active: this rank's shard [n].
    Returns (t, prim, u, v) of the rays that started on this rank, and with
    ``with_stats`` a [3, D] int32 tensor: for each hop the rays routed into
    this rank's subtree, the rays whose best hit improved, and B1's pops
    (node + leaf, summed over rays: each ray's own walk; the TPU kernel
    counts a packet's shared stack).
    """
    D = num_devices
    me = comm.axis_index(group)
    n = o.shape[0]
    steady_b, hop0_b, sroot = _split_route(dev_bounds)
    dev = o.device

    t = t_max.to(torch.float32)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    state = (o, d, t, prim, u, v, active)
    routed, improved, pops = [], [], []
    roots = None if sroot is None else sroot.tolist()

    for step in range(D):
        o_c, d_c, t_c, prim_c, u_c, v_c, act_c = state
        # Does the ray enter my forest closer than its current hit? Hop 0
        # serves the home shard against the hop-0 root; later hops start
        # at the steady root.
        bounds = hop0_b if step == 0 else steady_b
        root = None if (roots is None or step == 0) else roots[me]
        tn, tf = _slab(bounds[me, 0:3][None], bounds[me, 3:6][None], o_c,
                       _safe_inv(d_c))
        here = (tn <= tf) & (tf > 0.0) & (tn < t_c) & act_c
        if any_hit:
            here = here & (prim_c < 0)
        tt, pp, uu, vv, np_ = _local_trace(
            table, o_c, d_c, t_c, here, stack_depth=stack_depth,
            leaf_size=leaf_size, packet_size=packet_size, any_hit=any_hit,
            root=root, with_pops=with_stats)
        # B1 reports hits below the t_max it is given (t_c) alone.
        better = here & (pp >= 0)
        t_c = torch.where(better, tt, t_c)
        prim_c = torch.where(better, pp, prim_c)
        u_c = torch.where(better, uu, u_c)
        v_c = torch.where(better, vv, v_c)
        if with_stats:
            routed.append(here.sum())
            improved.append(better.sum())
            pops.append(np_)
        state = (o_c, d_c, t_c, prim_c, u_c, v_c, act_c)
        if step < D - 1:
            state = comm.ring_shift(state, group)
    # One more rotation brings each shard home: the hit payload alone (o,
    # d and the active mask are dead after the loop).
    t, prim, u, v = comm.ring_shift(state[2:6], group)
    if with_stats:
        return t, prim, u, v, torch.stack([
            torch.stack(routed), torch.stack(improved),
            torch.stack(pops)]).to(torch.int32)
    return t, prim, u, v


def _chip_slab(steady_b, o, d, t):
    """(tn [n, D], enter [n, D]): the slab entry of every ray into every
    rank's steady forest, and whether it enters closer than its current
    hit (the ring's ``here`` mask for all ranks at once)."""
    tn, tf = _slab(steady_b[None, :, 0:3], steady_b[None, :, 3:6],
                   o[:, None, :], _safe_inv(d)[:, None, :])
    return tn, (tn <= tf) & (tf > 0.0) & (tn < t[:, None])


def _deliver(out, idx, payload, mask, n):
    """out with payload[mask] written at idx; the other lanes aim at the
    sentinel slot n, which is dropped."""
    pad = torch.cat([out, out.new_zeros(1)])
    pad.index_put_((idx,), torch.where(mask, payload,
                                       torch.zeros_like(payload)).to(
        out.dtype))
    return pad[:n]


def _argsort(x):
    return torch.argsort(x, stable=True)


def _unvisited(visited, D: int, dev):
    """[n, D] bool: chip c is still unvisited by the ray."""
    return ((visited[:, None] >> torch.arange(D, device=dev)[None, :])
            & 1) == 0


_FIELDS = ("o", "d", "t", "u", "v", "prim", "home", "visited")


def trace_partitioned_routed(table, dev_bounds, o, d, t_max, active, *,
                             group=None, num_devices: int,
                             stack_depth: int, leaf_size: int,
                             packet_size: int = 2048, any_hit: bool = False,
                             max_rounds: Optional[int] = None,
                             bucket_cap: Optional[int] = None,
                             with_stats: bool = False):
    """The demand-routed trace; every rank of ``group`` calls it with its
    resident shard (arguments as ``trace_partitioned_local``'s).

    After the home hop, each round: every resident ray picks the nearest
    unvisited rank forest it still enters closer than its hit (or home
    once none is left); rays bucket by destination, home-bound rays first
    in each bucket; a sender may place at most free_c // D seeking rays on
    rank c (the all-gathered free slots), so no merge overflows; one
    all-to-all per field moves the [D, B] buckets; arrivals going home
    deliver into the output, the others fill free resident slots; then the
    rank serves every resident ray that still needs its steady forest.
    Resident state has capacity NR = n + D * B, B = ``bucket_cap``
    (default ceil(n / D), rounded up to a multiple of 8). Rays still
    undelivered after ``max_rounds`` rounds (default D + 2) keep their
    best hit so far in the output and are counted in stats row 3.

    Returns (t, prim, u, v), and with ``with_stats`` a [4, R + 1] int32
    tensor: per round (column 0 the home hop) B1's pops, rays
    transported, rays delivered, rays still in flight at the round's end.
    """
    D = num_devices
    if D > 32:
        raise ValueError(f"the routed trace's visited mask holds 32 ranks, "
                         f"not {D}")
    me = comm.axis_index(group)
    n = o.shape[0]
    dev = o.device
    R = max_rounds if max_rounds is not None else D + 2
    B = bucket_cap if bucket_cap is not None else -((-n) // D)
    B = max(8, -((-B) // 8) * 8)
    NR = n + D * B
    DB = D * B
    steady_b, hop0_b, sroot = _split_route(dev_bounds)
    # The JAX trace counts pops on every service; here only for the stats
    # (the counting kernels give the same hits).
    trace = dict(stack_depth=stack_depth, leaf_size=leaf_size,
                 packet_size=packet_size, any_hit=any_hit,
                 with_pops=with_stats)

    # The home hop: the ring's step 0. Later services use the steady root
    # and bounds, so visited bit c means "rank c's steady forest served or
    # provably unneeded".
    t = t_max.to(torch.float32)
    tn0, tf0 = _slab(hop0_b[me, 0:3][None], hop0_b[me, 3:6][None], o,
                     _safe_inv(d))
    here0 = (tn0 <= tf0) & (tf0 > 0.0) & (tn0 < t) & active
    tt, pp, uu, vv, pops0 = _local_trace(table, o, d, t, here0, **trace)
    better = here0 & (pp >= 0)
    out_t = torch.where(better, tt, t)
    out_prim = torch.where(better, pp, torch.full_like(pp, -1))
    out_u = torch.where(better, uu, 0.0)
    out_v = torch.where(better, vv, 0.0)

    pad = NR - n

    def _pad(x, fill=0.0):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=dev)])

    res = {
        "o": _pad(o), "d": _pad(d, 1.0), "t": _pad(out_t, torch.inf),
        "u": _pad(out_u), "v": _pad(out_v), "prim": _pad(out_prim, -1),
        "home": _pad(me * n + torch.arange(n, device=dev), 0),
        "visited": _pad(torch.full((n,), 1 << me, dtype=torch.int64,
                                   device=dev), 0),
    }
    done0 = (~active) | ((out_prim >= 0) if any_hit
                         else torch.zeros_like(active))
    _, enter_all = _chip_slab(steady_b, res["o"], res["d"], res["t"])
    pending0 = (torch.any(enter_all & _unvisited(res["visited"], D, dev),
                          dim=1)[:n] & ~done0)
    act = torch.cat([pending0, torch.zeros(pad, dtype=torch.bool,
                                           device=dev)])

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    pops_hist = [pops0]
    sent_hist = [zero]
    dlvr_hist = [(~pending0 & active).sum()]
    live_hist = [act.sum()]
    b_idx = torch.arange(B, device=dev)
    lanes = torch.arange(NR, device=dev)
    edges_at = torch.arange(2 * D + 1, device=dev)
    root = None if sroot is None else int(sroot[me])

    for _ in range(R):
        # (a) route: the nearest unvisited rank that the ray needs, else
        # home.
        tn_all, enter_all = _chip_slab(steady_b, res["o"], res["d"],
                                       res["t"])
        cand = enter_all & _unvisited(res["visited"], D, dev)
        if any_hit:
            cand = cand & (res["prim"] < 0)[:, None]
        key_t = torch.where(cand, tn_all, torch.inf)
        nxt = torch.argmin(key_t, dim=1)
        seek = torch.isfinite(torch.amin(key_t, dim=1)) & act
        home_chip = res["home"] // n
        home_local = res["home"] % n
        dest = torch.where(seek, nxt, home_chip)

        # Finished rays already home deliver in place.
        in_place = act & ~seek & (home_chip == me)
        idx_ip = torch.where(in_place, home_local, n)
        out_t = _deliver(out_t, idx_ip, res["t"], in_place, n)
        out_prim = _deliver(out_prim, idx_ip, res["prim"], in_place, n)
        out_u = _deliver(out_u, idx_ip, res["u"], in_place, n)
        out_v = _deliver(out_v, idx_ip, res["v"], in_place, n)
        act = act & ~in_place
        transport = act & (dest != me)

        # (b) credit: at most free_c // D seeking rays to rank c a sender.
        free_cnt = NR - act.sum()
        free_all = comm.all_gather(free_cnt, group)
        credit = torch.clamp_max(free_all // D, B)

        # (c) bucket by (dest, kind), home-bound rays (kind 0) first in a
        # destination group: they use no slot credit.
        kind = seek.to(torch.int64)
        key = torch.where(transport, dest * 2 + kind, 2 * D)
        order = _argsort(key)
        skey = key[order]
        edges = torch.searchsorted(skey, edges_at)
        cnt_home = edges[1::2] - edges[0:-1:2]
        cnt_seek = edges[2::2] - edges[1::2]
        grant_home = torch.clamp_max(cnt_home, B)
        grant_seek = torch.minimum(torch.minimum(cnt_seek, credit),
                                   B - grant_home)
        grant = grant_home + grant_seek
        g0 = edges[0:-1:2]
        gslot = g0[:, None] + b_idx[None, :]
        valid_send = b_idx[None, :] < grant[:, None]
        sid = order[torch.clamp(gslot, 0, NR - 1)]
        c_sorted = torch.clamp(skey, 0, 2 * D - 1) // 2
        rank = lanes - g0[c_sorted]
        sent_sorted = (skey < 2 * D) & (rank < grant[c_sorted])
        sent = sent_sorted[_argsort(order)]
        act = act & ~sent

        # (d) exchange: one all-to-all of the [D, B] buckets per field.
        send = {k: res[k][sid] for k in _FIELDS}
        send["valid"] = valid_send
        send["seek"] = seek[sid] & valid_send
        rflat = {k: comm.all_to_all(x, group).reshape(
            (DB,) + tuple(x.shape[2:])) for k, x in send.items()}

        # (e) arrivals going home deliver straight into the output.
        dely = rflat["valid"] & ~rflat["seek"]
        idx_d = torch.where(dely, rflat["home"] % n, n)
        out_t = _deliver(out_t, idx_d, rflat["t"], dely, n)
        out_prim = _deliver(out_prim, idx_d, rflat["prim"], dely, n)
        out_u = _deliver(out_u, idx_d, rflat["u"], dely, n)
        out_v = _deliver(out_v, idx_d, rflat["v"], dely, n)

        # (f) the k-th seeking arrival fills the k-th free slot.
        mv = rflat["valid"] & rflat["seek"]
        rorder = _argsort((~mv).to(torch.uint8))
        n_arr = mv.sum()
        invf = _argsort(_argsort(act.to(torch.uint8)))
        take = (~act) & (invf < n_arr)
        arr_idx = rorder[torch.clamp(invf, 0, DB - 1)]
        for kf in _FIELDS:
            src = rflat[kf][arr_idx]
            keep = res[kf]
            m = take.reshape((NR,) + (1,) * (keep.dim() - 1))
            res[kf] = torch.where(m, src, keep)
        act = act | take

        # (g) serve every resident ray that still needs this rank's
        # steady forest (arrivals and credit-denied stayers alike).
        _, enter_me = _chip_slab(steady_b[me][None], res["o"], res["d"],
                                 res["t"])
        here = act & enter_me[:, 0] & (((res["visited"] >> me) & 1) == 0)
        if any_hit:
            here = here & (res["prim"] < 0)
        tt, pp, uu, vv, pops_r = _local_trace(
            table, res["o"], res["d"], res["t"], here, root=root, **trace)
        better = here & (pp >= 0)
        res["t"] = torch.where(better, tt, res["t"])
        res["prim"] = torch.where(better, pp, res["prim"])
        res["u"] = torch.where(better, uu, res["u"])
        res["v"] = torch.where(better, vv, res["v"])
        res["visited"] = res["visited"] | torch.where(here, 1 << me, 0)

        pops_hist.append(pops_r)
        sent_hist.append(valid_send.sum())
        dlvr_hist.append(in_place.sum() + dely.sum())
        live_hist.append(act.sum())

    if with_stats:
        stats = torch.stack([torch.stack(pops_hist), torch.stack(sent_hist),
                             torch.stack(dlvr_hist),
                             torch.stack(live_hist)]).to(torch.int32)
        return out_t, out_prim, out_u, out_v, stats
    return out_t, out_prim, out_u, out_v


def strip_scene_bvh(scene):
    """The scene of the partitioned render: every BVH table cut to its
    first row (copies, so the whole tables can be freed): no rank holds
    the whole tree, only its partition table. The shading tables,
    materials and the environment stay whole: any rank may shade a hit
    found in another rank's subtree."""
    def first(x):
        return None if x is None else x[:1].clone()
    return scene._replace(
        node_rows=first(scene.node_rows),
        child_bounds=first(scene.child_bounds),
        child_entry=first(scene.child_entry), refs=first(scene.refs),
        cut_entry=first(scene.cut_entry),
        cut_bounds=first(scene.cut_bounds))


def render_sample_partitioned(mesh, table, route, scene, cam, pixel_x,
                              pixel_y, key, sample_base: int = 0,
                              axis: str = "chips", **static):
    """One scene-partitioned frame on this rank: pixels sharded over the
    ``axis`` of ``mesh`` (parallel/mesh.py), every traversal through the
    ring or the routed trace (``partition_routing`` among ``static``).

    pixel_x / pixel_y are the full ray-ordered arrays [N]; N must divide
    by the axis size. With a ("samples", "chips") mesh each samples row
    renders its own sample of the same pixels and the contributions are
    summed over "samples". The key is folded by the samples index, then by
    the chips index + 7177, as the JAX package folds it. Returns (this
    rank's [N / C, 3] radiance, rays traced over the mesh)."""
    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.models.wavefront import render_sample_impl
    from gpupathtracer_tpu_torch.parallel.mesh import pixel_shard

    group = mesh.groups[axis]
    D = mesh.size(axis)
    sl = pixel_shard(mesh, pixel_x.shape[0], axis)
    sidx = sample_base
    if "samples" in mesh.axis_names:
        s = mesh.coords["samples"]
        key = random.fold_in(key, s)
        sidx = sample_base + s
    key = random.fold_in(key, mesh.coords[axis] + 7177)
    contribution, rays = render_sample_impl(
        scene, cam, pixel_x[sl], pixel_y[sl], key,
        partition=(table, route), partition_group=group, num_chips=D,
        sample_idx=sidx, **static)
    if "samples" in mesh.axis_names:
        contribution = comm.psum(contribution, mesh.groups["samples"])
        rays = comm.psum(rays, mesh.groups["samples"])
    return contribution, comm.psum(rays, group)


def trace_closest_partitioned(table, dev_bounds, o, d, t_max, active, *,
                              group=None, stack_depth: int, leaf_size: int,
                              packet_size: int = 2048, any_hit: bool = False,
                              with_stats: bool = False,
                              routing: str = "ring",
                              max_rounds: Optional[int] = None,
                              bucket_cap: Optional[int] = None):
    """The full [N] rays in (N must divide by the group's size; rank c
    takes shard c), the full result out on every rank: a Hit, or [N] bool
    occlusion with ``any_hit``. With ``with_stats`` also each rank's
    counters, gathered: [D, 3, D] for the ring (row c: the rays routed
    into rank c's subtree, those that improved and B1's pops, by hop) or
    [D, 4, R + 1] for the routed trace (by round: pops, rays transported,
    delivered, still in flight)."""
    if routing not in ("ring", "routed"):
        raise ValueError(f"routing must be ring or routed, got {routing!r}")
    D = comm.axis_size(group)
    N = o.shape[0]
    if N % D:
        raise ValueError(f"{N} rays do not divide over {D} ranks")
    n = N // D
    sl = slice(comm.axis_index(group) * n, (comm.axis_index(group) + 1) * n)
    kw = dict(group=group, num_devices=D, stack_depth=stack_depth,
              leaf_size=leaf_size, packet_size=packet_size, any_hit=any_hit,
              with_stats=with_stats)
    args = (table, dev_bounds, o[sl], d[sl], t_max[sl], active[sl])
    if routing == "routed":
        out = trace_partitioned_routed(*args, max_rounds=max_rounds,
                                       bucket_cap=bucket_cap, **kw)
    else:
        out = trace_partitioned_local(*args, **kw)
    full = [comm.all_gather(x, group).reshape((N,)) for x in out[:4]]
    stats = comm.all_gather(out[4], group) if with_stats else None
    if any_hit:
        occ = full[1] >= 0
        return (occ, stats) if with_stats else occ
    hit = Hit(*full)
    return (hit, stats) if with_stats else hit
