"""Checkpoint / resume for progressive renders (counterpart of the JAX
package's render/checkpoint.py, with its file format: either package
resumes the other's files).

The reference only resets its progressive state (``accum`` and
``numSamples``, Renderer.h:34,51). Here a long render is resumable: the
accumulation buffer (in Morton ray order), the sample count, the base
seed and the render config's JSON go into one .npz; resuming continues
the same counter-based sample stream, so a checkpointed and resumed render
is bitwise an uninterrupted one.

Under a mesh (parallel/) the file holds the whole film, gathered from the
ranks' shards (sentinel rays included, as the JAX package stores it):
every rank calls ``save_checkpoint``, rank 0 writes; ``load_checkpoint``
in every rank gives each its shard back, and the config's mesh its
samples per frame.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_checkpoint(renderer, path: str) -> str:
    accum = renderer.film_accum().cpu().numpy()
    if not renderer.is_writer():
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # Through a handle: np.savez_compressed(path) appends ".npz" to a path
    # without it, and the render would not resume by the same name.
    with open(path, "wb") as f:
        np.savez_compressed(
            f,
            accum=accum,
            num_samples=np.int64(renderer.num_samples),
            seed=np.int64(renderer.cfg.seed),
            config=np.frombuffer(renderer.cfg.to_json().encode(), np.uint8),
        )
    return path


def load_checkpoint(path: str, device):
    """A Renderer on ``device`` resumed from the checkpoint: the scene is
    loaded again from the stored config (from the disk cache where that
    config enables it)."""
    from gpupathtracer_tpu_torch.config import RenderConfig
    from gpupathtracer_tpu_torch.render.renderer import Renderer

    with np.load(path) as z:
        cfg = RenderConfig.from_json(bytes(z["config"]).decode())
        accum = z["accum"]
        num_samples = int(z["num_samples"])
        seed = int(z["seed"])
    cfg.seed = seed
    r = Renderer(cfg, device)
    if tuple(accum.shape) != (r.n_rays, 3):
        raise ValueError(f"checkpoint film {accum.shape} != "
                         f"{(r.n_rays, 3)}")
    r.accum = torch.as_tensor(accum[r.shard], device=r.device)
    r.num_samples = num_samples
    return r
