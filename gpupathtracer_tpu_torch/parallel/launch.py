"""Run a function in several ranks of a fresh process group, each rank a
process of its own, and collect what each returns.

    results = run_ranks(fn, world=4, backend="gloo", device="cpu",
                        args=(...), timeout_s=120)

calls ``fn(device, *args)`` in ``world`` new Python processes, rank r's
result at ``results[r]``. The ranks meet through a file in a temporary
folder (``init_method="file://..."``), so runs side by side never
contend for a TCP port, and ``init_process_group`` is given the same
timeout. ``device`` is the torch device every rank runs on: "cpu",
"cuda:0" (every rank on that GPU, which gloo allows and NCCL does not) or
"cuda" (rank r on cuda:r, as NCCL wants it). CPU ranks run one thread
each.

``fn`` and ``args`` go to the ranks by pickle, so ``fn`` must be a module
level function that the ranks can import (sys.path is passed on), and
its result a host object. The ranks refuse to import jax and the JAX
package. If a rank fails, its log ends the raised error; if the ranks
have not all finished by the deadline, every one of them is killed and
TimeoutError is raised: a hung collective never outlives its caller's
deadline.

``python -m gpupathtracer_tpu_torch.parallel.launch`` is a rank's own entry
point; it is not meant to be run by hand.
"""

from __future__ import annotations

import datetime
import importlib.abc
import os
import pickle
import subprocess
import sys
import tempfile
import time

_ENTRY = "gpupathtracer_tpu_torch.parallel.launch"
_BLOCKED = ("jax", "jaxlib", "gpupathtracer_tpu")


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def run_ranks(fn, world: int, backend: str = "gloo", device: str = "cpu",
              args=(), timeout_s: float = 300.0) -> list:
    """``fn(device, *args)`` in ``world`` ranks; the list of their
    results."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if backend == "nccl" and not device.startswith("cuda"):
        raise ValueError("NCCL runs CUDA ranks")
    with tempfile.TemporaryDirectory(prefix="gpt_ranks_") as tmp:
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in [os.getcwd()] + sys.path if p and os.path.isdir(p))
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs, logs = [], []
        for rank in range(world):
            log = os.path.join(tmp, f"rank{rank}.log")
            logs.append(log)
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", _ENTRY, tmp, str(rank),
                     str(world), backend, device, str(timeout_s)],
                    stdout=out, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            raise TimeoutError(
                f"{world} {backend} ranks on {device} did not finish within "
                f"{timeout_s} s; rank logs:\n" + "\n".join(
                    f"--- rank {r} ---\n{_tail(lg)}"
                    for r, lg in enumerate(logs)))
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(
                f"ranks {bad} of {world} ({backend} on {device}) failed; "
                "logs:\n" + "\n".join(f"--- rank {r} (exit "
                                      f"{procs[r].returncode}) ---\n"
                                      f"{_tail(logs[r])}" for r in bad))
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError(f"{name} is not imported by a rank")
        return None


def _rank_main(argv) -> int:
    tmp, rank, world, backend, device, timeout_s = argv
    rank, world = int(rank), int(world)
    sys.meta_path.insert(0, _Refuse())
    import torch
    import torch.distributed as dist

    if device == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device(f"cuda:{rank}" if device == "cuda" else device)
        torch.cuda.set_device(dev)
    # The caller's deadline ends a hung rank; the group's own timeout only
    # backs it up.
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=float(timeout_s) + 60.0))
    try:
        with open(os.path.join(tmp, "job.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        out = fn(dev, *args)
        path = os.path.join(tmp, f"result{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
