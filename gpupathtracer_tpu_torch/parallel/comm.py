"""Collectives of the multi-device paths over one process group: the
counterparts of the ``jax.lax`` collectives the JAX package's
parallel/mesh.py and parallel/partition.py call inside ``shard_map``.

One process runs a device (a rank); a mesh axis is a process group
(parallel/mesh.py builds them), and every rank of the group calls the same
collective in the same order, as every device of a ``shard_map`` runs the
same program. Each function takes and returns tensors on the caller's
device.

NCCL takes CUDA tensors as they are. gloo reduces and exchanges host
tensors only (its point-to-point, gather and all-to-all refuse CUDA
tensors), so under gloo a CUDA tensor is copied to the host and back in
``_to_wire`` / ``_from_wire`` alone, and ``STAGED`` counts those copies:
that is how several ranks share one GPU (gloo), never how an NCCL group
runs. Booleans travel as uint8.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

# Host staging under gloo since the last reset: the calls that staged and
# the bytes copied each way (device to host plus host to device).
STAGED = {"calls": 0, "bytes": 0}

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def backend(group=None) -> str:
    return str(dist.get_backend(group)).lower()


def axis_index(group=None) -> int:
    """This rank's position on the axis (``jax.lax.axis_index``)."""
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    return dist.get_world_size(group)


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective of ``group`` takes for ``x``: contiguous,
    bool as uint8, and on the host when gloo is given a CUDA tensor."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if x.is_cuda and backend(group) == "gloo":
        STAGED["calls"] += 1
        STAGED["bytes"] += x.numel() * x.element_size()
        x = x.cpu()
    return x.contiguous()


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The received ``w`` back on ``like``'s device and dtype."""
    if w.device != like.device:
        STAGED["bytes"] += w.numel() * w.element_size()
        w = w.to(like.device)
    return w.to(like.dtype) if w.dtype != like.dtype else w


def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    w = _to_wire(x, group)
    if w is x:
        w = x.clone()
    dist.all_reduce(w, op=op, group=group)
    return _from_wire(w, x)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the axis (``jax.lax.psum``); ``x`` is left as it was."""
    return _reduce(x, dist.ReduceOp.SUM, group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Maximum over the axis (``jax.lax.pmax``)."""
    return _reduce(x, dist.ReduceOp.MAX, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """[D, *x.shape]: every rank's ``x`` in axis order
    (``jax.lax.all_gather``)."""
    w = _to_wire(x, group)
    parts = [torch.empty_like(w) for _ in range(axis_size(group))]
    dist.all_gather(parts, w, group=group)
    return _from_wire(torch.stack(parts), x)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` [D, B, ...]: block j goes to rank j; returns [D, B, ...] whose
    block j came from rank j (``jax.lax.all_to_all(x, axis, 0, 0)``)."""
    if x.shape[0] != axis_size(group):
        raise ValueError(f"all_to_all takes [D={axis_size(group)}, ...] "
                         f"blocks, got {tuple(x.shape)}")
    w = _to_wire(x, group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return _from_wire(out, x)


def ring_shift(xs: Tensors, group=None) -> Tensors:
    """Each rank's tensors go to the next rank on the axis and it receives
    the previous rank's (``jax.lax.ppermute`` with perm [(i, (i + 1) % D)]).
    One batch of sends and receives, so that D = 2 cannot deadlock; at
    D = 1 the tensors come back as copies. Takes a tensor or a sequence
    of them and returns the same."""
    single = isinstance(xs, torch.Tensor)
    xs = [xs] if single else list(xs)
    size = axis_size(group)
    if size == 1:
        out = [x.clone() for x in xs]
        return out[0] if single else tuple(out)
    me = axis_index(group)
    ranks = group_ranks(group)
    nxt, prv = ranks[(me + 1) % size], ranks[(me - 1) % size]
    wires = [_to_wire(x, group) for x in xs]
    recv = [torch.empty_like(w) for w in wires]
    ops = []
    for w, r in zip(wires, recv):
        ops.append(dist.P2POp(dist.isend, w, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = [_from_wire(r, x) for r, x in zip(recv, xs)]
    return out[0] if single else tuple(out)


def reset_staged() -> None:
    for k in STAGED:
        STAGED[k] = 0


def describe(group=None) -> str:
    """One line: the group's backend, size and the host staging so far."""
    return (f"backend {backend(group)}, {axis_size(group)} ranks, staged "
            f"{STAGED['calls']} calls / {STAGED['bytes']} bytes through "
            f"the host")


def group_ranks(group=None) -> Tuple[int, ...]:
    """The global ranks of ``group`` in axis order."""
    group = group or dist.group.WORLD
    return tuple(dist.get_global_rank(group, i)
                 for i in range(axis_size(group)))
