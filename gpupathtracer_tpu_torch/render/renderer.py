"""Progressive renderer: frame orchestration (counterpart of the JAX
package's render/renderer.py; role of src/core/Renderer.{h,cpp}).

The accumulation buffer lives on the device in Morton ray order and is
unpermuted at present time. The film is padded to 8x8-aligned dimensions
and cropped on present, and traced in equal chunks of at most
``cfg.ray_chunk`` rays. Keys are folded exactly as the JAX package folds
them (seed -> sample count -> chunk), so the two draw the same numbers.

With ``cfg.megakernel == "on"`` an eligible scene (ops/megakernel.py
``mega_eligible``) renders its wavefront and direct frames through the
megakernel; any other scene takes the wavefront integrator, as in the JAX
package. ``"auto"`` resolves to off there too.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.math.camera import generate_image_plane
from gpupathtracer_tpu_torch.models.wavefront import (render_sample_batch,
                                                      render_sample_impl)
from gpupathtracer_tpu_torch.ops.megakernel import (mega_eligible,
                                                    pack_mega_tables,
                                                    render_sample_mega,
                                                    render_sample_mega_batch)
from gpupathtracer_tpu_torch.ops.tonemap import present as present_op
from gpupathtracer_tpu_torch.ops.traverse import check_traversal
from gpupathtracer_tpu_torch.utils.io import save_png
from gpupathtracer_tpu_torch.utils.morton import ray_order
from gpupathtracer_tpu_torch.utils.timing import FrameStats


def _align8(x: int) -> int:
    return (x + 7) // 8 * 8


class Renderer:
    def __init__(self, cfg: RenderConfig, device, scene=None,
                 meta=None) -> None:
        if cfg.cluster_tris and cfg.partition_chips:
            raise ValueError("cluster_tris and partition_chips are mutually "
                             "exclusive (the partition builds its own "
                             "per-chip tables)")
        if int(np.prod(cfg.mesh_shape)) > 1 or cfg.partition_chips > 0:
            raise NotImplementedError("multi-device rendering is not ported "
                                      "yet (ROADMAP.md, queue A)")
        check_traversal(cfg.traversal)
        if cfg.bounce_traversal not in ("auto", "same"):
            raise NotImplementedError(
                f"bounce_traversal {cfg.bounce_traversal!r} is not ported "
                f"yet (ROADMAP.md, queue A: tsort)")
        self.cfg = cfg
        self.device = torch.device(device)
        if scene is None:
            from gpupathtracer_tpu_torch.scene.scenedata import load_scene
            scene, meta = load_scene(cfg, self.device)
        self.scene = scene
        self.meta = meta
        # The megakernel's deferred-shadow option (cfg.mega_fused_nee) only
        # reschedules the TPU kernel's walks; the CUDA kernel has one
        # schedule, so the option changes nothing here but, as in the JAX
        # package, is refused on cluster scenes (ops/megakernel.py).
        self.use_mega = (cfg.megakernel == "on" and mega_eligible(
            scene, meta, textured=False, delta=meta.has_delta,
            sun=cfg.sun_enabled, sampler=cfg.sampler))
        if self.use_mega:
            self.mega_tables = pack_mega_tables(scene)
        self.width, self.height = cfg.width, cfg.height
        self.pad_w, self.pad_h = _align8(cfg.width), _align8(cfg.height)
        n = self.pad_w * self.pad_h

        # Ray order: Morton/Hilbert within 8x8 blocks (Renderer.cpp:568-592).
        fwd = ray_order(self.pad_w, self.pad_h, cfg.pixel_order)
        self._ray_to_pixel = torch.as_tensor(fwd.astype(np.int64),
                                             device=self.device)
        self.pixel_x = torch.as_tensor((fwd % self.pad_w).astype(np.float32),
                                       device=self.device)
        self.pixel_y = torch.as_tensor((fwd // self.pad_w).astype(np.float32),
                                       device=self.device)
        self.n_rays = n

        # Fewest equal chunks <= ray_chunk that tile the ray space exactly.
        n_chunks = max(-(-self.n_rays // min(cfg.ray_chunk, self.n_rays)), 1)
        while self.n_rays % n_chunks:
            n_chunks += 1
        self.chunk = self.n_rays // n_chunks

        self.accum = torch.zeros((self.n_rays, 3), dtype=torch.float32,
                                 device=self.device)
        self.num_samples = 0
        self.base_key = random.PRNGKey(cfg.seed, self.device)
        self.camera = generate_image_plane(cfg.camera, self.device)
        self.stats = FrameStats()

    # -- frame loop ---------------------------------------------------------

    def set_camera(self, camera_cfg) -> None:
        """Camera moved: regenerate the basis and reset accumulation."""
        self.cfg.camera = camera_cfg
        self.camera = generate_image_plane(camera_cfg, self.device)
        self.reset_samples()

    def render_frame(self, integrator: Optional[str] = None,
                     sync: bool = False) -> None:
        """Accumulate cfg.frame_batch samples per pixel (RenderFrame,
        Renderer.cpp:651-662). With sync, the frame's recorded time ends
        after the device has finished it."""
        integrator = integrator or self.cfg.integrator
        if integrator not in ("wavefront", "direct"):
            raise NotImplementedError(
                f"integrator {integrator!r} is not ported yet "
                f"(ROADMAP.md, queue A: reference/AO)")
        t0 = time.perf_counter()
        batch = self.cfg.frame_batch
        out, rays = [], 0
        for c0 in range(0, self.n_rays, self.chunk):
            contribution, r = self._render_chunk(
                integrator, slice(c0, c0 + self.chunk),
                self.chunk_key(c0 // self.chunk), batch)
            out.append(contribution)
            rays = rays + r
        self.accum = self.accum + torch.cat(out, dim=0)
        self.num_samples += batch
        if sync:
            self.sync()
        self.stats.add_frame(time.perf_counter() - t0, rays)

    def sync(self) -> None:
        """Wait until the device has finished all enqueued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def chunk_key(self, chunk: int):
        """The key of chunk ``chunk`` of the next frame."""
        return random.fold_in(random.fold_in(self.base_key, self.num_samples),
                              chunk)

    def mega_statics(self, integrator: str) -> dict:
        """Keyword arguments of this renderer's megakernel calls, apart from
        spp and the sample index."""
        cfg = self.cfg
        direct = integrator == "direct"
        return dict(width=self.pad_w, height=self.pad_h,
                    stack_depth=self.meta.stack_depth,
                    leaf_size=self.meta.leaf_size,
                    max_bounces=0 if direct else cfg.max_bounces,
                    nee=True if direct else cfg.nee_enabled,
                    model=cfg.microfacet,
                    n_mats=self.meta.num_materials,
                    n_lights=int(self.scene.light_rows.shape[0]),
                    packet_size=cfg.pallas_packet_size,
                    fused_nee=cfg.mega_fused_nee)

    def _render_chunk(self, integrator: str, sl: slice, key, batch: int = 1):
        """Returns ([C, 3] contribution, rays traced)."""
        cfg = self.cfg
        direct = integrator == "direct"
        px, py = self.pixel_x[sl], self.pixel_y[sl]
        if self.use_mega:
            mk = self.mega_statics(integrator)
            if batch > 1:
                return render_sample_mega_batch(
                    self.scene, self.mega_tables, self.camera, px, py, key,
                    spp=batch, sample_idx=self.num_samples, **mk)
            return render_sample_mega(
                self.scene, self.mega_tables, self.camera, px, py, key,
                sample_idx=self.num_samples, **mk)
        kwargs = dict(width=self.pad_w, height=self.pad_h,
                      max_bounces=0 if direct else cfg.max_bounces,
                      nee=True if direct else cfg.nee_enabled,
                      compaction=cfg.compaction,
                      compaction_divs=tuple(cfg.compaction_divs),
                      stack_depth=self.meta.stack_depth,
                      leaf_size=self.meta.leaf_size,
                      model=cfg.microfacet,
                      traversal=cfg.traversal,
                      sun=cfg.sun_enabled,
                      shadow_rev=cfg.shadow_rev,
                      sort_rays=False if direct else cfg.sort_rays,
                      sampler=cfg.sampler,
                      delta=self.meta.has_delta)
        if batch > 1:
            return render_sample_batch(self.scene, self.camera, px, py, key,
                                       spp=batch, **kwargs)
        return render_sample_impl(self.scene, self.camera, px, py, key,
                                  **kwargs)

    def reset_samples(self) -> None:
        """ResetSamples (Renderer.cpp:687-691)."""
        self.accum = torch.zeros_like(self.accum)
        self.num_samples = 0

    # -- output ---------------------------------------------------------------

    def _unpermute(self) -> torch.Tensor:
        """Accumulator (ray order) -> film pixel order, [pad_h*pad_w, 3]."""
        flat = torch.zeros_like(self.accum)
        flat[self._ray_to_pixel] = self.accum
        return flat

    def film_hdr(self) -> np.ndarray:
        """Mean radiance per pixel, [H, W, 3] float32 (pre-tonemap)."""
        img = self._unpermute().reshape(self.pad_h, self.pad_w, 3)
        img = img[:self.height, :self.width].cpu().numpy()
        return img / max(self.num_samples, 1)

    def present(self) -> np.ndarray:
        """Tonemapped LDR frame [H, W, 3] in [0, 1]. Row 0 is the bottom
        scanline (GL convention); save with flip_y=True."""
        img = present_op(self._unpermute().reshape(self.pad_h, self.pad_w, 3),
                         max(self.num_samples, 1),
                         exposure=self.cfg.exposure,
                         tonemap=self.cfg.tonemap)
        return img[:self.height, :self.width].cpu().numpy()

    def save_screenshot(self, path: str) -> str:
        """SaveScreenshot (Renderer.cpp:697-705): tonemapped PNG, y-flipped."""
        return save_png(path, self.present(), flip_y=True)
