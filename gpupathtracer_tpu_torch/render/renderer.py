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
package. ``"auto"`` resolves to off there too. The reference and AO
integrators render one sample a frame (``cfg.frame_batch`` applies to the
wavefront and direct frames only), as in the JAX package.

``cfg.traversal`` names the traversal of every query (ops/traverse.py):
the kernel ("auto", "pallas"), or "tsort", "treelet", "packet" or
"perray"; the megakernel runs with the kernel traversal only, as the JAX
package's runs with its on-core kernel only.

Multi-device (parallel/): every rank of the default process group builds
a Renderer with the same config. ``cfg.mesh_shape`` shards the pixels
over a "pixels" axis and the samples over a "samples" axis
(parallel/mesh.py); ``cfg.partition_chips`` (> 0) partitions the scene's
BVH over that many ranks, ``cfg.partition_samples`` sample replicas of
them, the rays going through the ring or the routed trace
(``cfg.partition_routing``, parallel/partition.py). A wavefront frame is
then one call a rank with the frame's key (no chunks, as the JAX package
renders a sharded frame in one ``shard_map`` call) and accumulates
``samples_per_frame`` samples. Each rank accumulates its pixel shard;
the film is padded with sentinel rays to a multiple of the pixels axis,
their slot dropped on present. ``film_hdr``, ``present``,
``present_device`` and ``save_screenshot`` gather the film: every rank
calls them, rank 0 writes the file. Under a mesh, the other integrators
render the whole film on every rank (the JAX package renders them on one
device) and keep the rank's shard; under a partition, whose ranks hold no
whole tree, they raise. The megakernel stays off under a mesh, as in the
JAX package.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.math.camera import generate_image_plane
from gpupathtracer_tpu_torch.models.ao import render_sample_ao
from gpupathtracer_tpu_torch.models.reference import render_sample_reference
from gpupathtracer_tpu_torch.models.wavefront import (render_sample_batch,
                                                      render_sample_impl)
from gpupathtracer_tpu_torch.ops.megakernel import check_arity as \
    check_mega_arity
from gpupathtracer_tpu_torch.ops.megakernel import (mega_eligible,
                                                    pack_mega_tables,
                                                    render_sample_mega,
                                                    render_sample_mega_batch)
from gpupathtracer_tpu_torch.ops.tonemap import present as present_op
from gpupathtracer_tpu_torch.ops.traverse import check_traversal
from gpupathtracer_tpu_torch.utils.io import save_png
from gpupathtracer_tpu_torch.utils.morton import ray_order
from gpupathtracer_tpu_torch.utils.timing import FrameStats


INTEGRATORS = ("wavefront", "direct", "reference", "ao")


def _align8(x: int) -> int:
    return (x + 7) // 8 * 8


class Renderer:
    def __init__(self, cfg: RenderConfig, device, scene=None,
                 meta=None) -> None:
        if cfg.cluster_tris and cfg.partition_chips:
            raise ValueError("cluster_tris and partition_chips are mutually "
                             "exclusive (the partition builds its own "
                             "per-chip tables)")
        if cfg.partition_chips > 0 and int(np.prod(cfg.mesh_shape)) > 1:
            raise ValueError("partition_chips and mesh_shape are mutually "
                             "exclusive scaling modes")
        check_traversal(cfg.traversal)
        if cfg.bounce_traversal not in ("auto", "same"):
            check_traversal(cfg.bounce_traversal)
        self.cfg = cfg
        self.device = torch.device(device)
        if scene is None:
            from gpupathtracer_tpu_torch.scene.scenedata import load_scene
            scene, meta = load_scene(cfg, self.device)
        self.scene = scene
        self.meta = meta
        if scene.cluster_rows is not None and cfg.bounce_traversal == \
                "treelet":
            raise ValueError("bounce_traversal='treelet' reads MT leaf rows; "
                             "cluster scenes support pallas/tsort only")
        # The packet size of the kernel's traversals, resolved as the JAX
        # Renderer resolves it for its on-core kernel ("pallas", which
        # "auto" is here): the treelet bins' packets.
        self.packet_size = (cfg.pallas_packet_size
                            if cfg.traversal in ("auto", "pallas")
                            else cfg.packet_size)
        # Bounce-ray override: "auto" is "same". The JAX gate takes
        # treelet-sorted dispatch (ops/tsort.py) only for its TPU kernel
        # ("pallas"), on tables of 8192 rows or more; on the card the sort costs ten times the kernel it
        # speeds up (PERF.md, section 7), so it runs only when named.
        if cfg.bounce_traversal == "auto":
            self.bounce_traversal = "same"
        else:
            self.bounce_traversal = cfg.bounce_traversal
        # The megakernel's deferred-shadow option (cfg.mega_fused_nee) only
        # reschedules the TPU kernel's walks; the CUDA kernel has one
        # schedule, so the option changes nothing here but, as in the JAX
        # package, is refused on cluster scenes (ops/megakernel.py).
        self.use_mega = (
            cfg.megakernel == "on" and cfg.traversal in ("auto", "pallas")
            and mega_eligible(scene, meta, textured=meta.has_textures,
                              delta=meta.has_delta, sun=cfg.sun_enabled,
                              sampler=cfg.sampler))
        self.mesh = None
        self.partition = None
        self.samples_per_frame = 1
        self.pixels_axis = None
        if cfg.partition_chips > 0:
            self._init_partition(cfg)
        elif int(np.prod(cfg.mesh_shape)) > 1:
            from gpupathtracer_tpu_torch.parallel.mesh import make_device_mesh
            self.mesh = make_device_mesh(cfg.mesh_shape)
            self.pixels_axis = "pixels"
            self.samples_per_frame = self.mesh.size("samples")
        # The megakernel stays off under a mesh (the JAX Renderer's gate).
        self.use_mega = self.use_mega and self.mesh is None
        if self.use_mega:
            check_mega_arity(scene.arity)
            self.mega_tables = pack_mega_tables(scene)
        self.width, self.height = cfg.width, cfg.height
        self.pad_w, self.pad_h = _align8(cfg.width), _align8(cfg.height)
        n = self.pad_w * self.pad_h

        # Ray order: Morton/Hilbert within 8x8 blocks (Renderer.cpp:568-592).
        # A film that does not divide the pixels axis is padded with
        # sentinel rays aimed at one extra film slot, which the film drops.
        fwd = ray_order(self.pad_w, self.pad_h, cfg.pixel_order)
        pixels = self.mesh.size(self.pixels_axis) if self.mesh else 1
        pad_rays = (-n) % pixels
        if pad_rays:
            fwd = np.concatenate([fwd, np.full(pad_rays, n, fwd.dtype)])
        self._ray_to_pixel = torch.as_tensor(fwd.astype(np.int64),
                                             device=self.device)
        px = np.where(fwd < n, fwd % self.pad_w, 0)
        py = np.where(fwd < n, fwd // self.pad_w, 0)
        self.pixel_x = torch.as_tensor(px.astype(np.float32),
                                       device=self.device)
        self.pixel_y = torch.as_tensor(py.astype(np.float32),
                                       device=self.device)
        self.n_rays = n + pad_rays
        # This rank's rays of the film (all of them on one device).
        self.shard = slice(0, self.n_rays)
        if self.mesh is not None:
            from gpupathtracer_tpu_torch.parallel.mesh import pixel_shard
            self.shard = pixel_shard(self.mesh, self.n_rays, self.pixels_axis)

        # Fewest equal chunks <= ray_chunk that tile the ray space exactly.
        n_chunks = max(-(-self.n_rays // min(cfg.ray_chunk, self.n_rays)), 1)
        while self.n_rays % n_chunks:
            n_chunks += 1
        self.chunk = self.n_rays // n_chunks

        self.accum = torch.zeros((self.shard.stop - self.shard.start, 3),
                                 dtype=torch.float32, device=self.device)
        self.num_samples = 0
        self.base_key = random.PRNGKey(cfg.seed, self.device)
        self.camera = generate_image_plane(cfg.camera, self.device)
        self.stats = FrameStats()

    def _init_partition(self, cfg) -> None:
        """The scene-partitioned mesh: ("samples", "chips") or ("chips",);
        this rank's partition table; the scene without its tree."""
        from gpupathtracer_tpu_torch.bvh.partition import build_partition
        from gpupathtracer_tpu_torch.parallel.mesh import make_device_mesh
        from gpupathtracer_tpu_torch.parallel.partition import (
            shard_partition, strip_scene_bvh)
        C, S = cfg.partition_chips, max(cfg.partition_samples, 1)
        if S > 1:
            self.mesh = make_device_mesh((S, C), ("samples", "chips"))
        else:
            self.mesh = make_device_mesh((C,), ("chips",))
        if self.scene.arity != 8 or cfg.leaf_size > 10:
            raise ValueError("partition_chips requires wide_arity=8 and "
                             "leaf_size <= 10 (the partition builder "
                             "parses 8-wide single-row-leaf tables)")
        part = build_partition(self.scene.node_rows.cpu().numpy(),
                               self.scene.child_bounds.shape[0], C)
        self.partition = shard_partition(part, self.mesh.groups["chips"],
                                         self.device)
        self.scene = strip_scene_bvh(self.scene)
        self.samples_per_frame = S
        self.pixels_axis = "chips"

    # -- frame loop ---------------------------------------------------------

    def set_camera(self, camera_cfg) -> None:
        """Camera moved: regenerate the basis and reset accumulation."""
        self.cfg.camera = camera_cfg
        self.camera = generate_image_plane(camera_cfg, self.device)
        self.reset_samples()

    def render_frame(self, integrator: Optional[str] = None,
                     sync: bool = False) -> None:
        """Accumulate samples per pixel (RenderFrame, Renderer.cpp:651-662):
        cfg.frame_batch of the wavefront or direct integrator, one of the
        reference or AO integrator. With sync, the frame's recorded time
        ends after the device has finished it."""
        integrator = integrator or self.cfg.integrator
        if integrator not in INTEGRATORS:
            raise ValueError(f"unknown integrator {integrator!r}")
        t0 = time.perf_counter()
        if self.mesh is not None and integrator == "wavefront":
            contribution, rays = self._render_sharded(random.fold_in(
                self.base_key, self.num_samples))
            self.accum = self.accum + contribution
            self.num_samples += self.samples_per_frame
        else:
            if self.partition is not None:
                raise ValueError(f"the {integrator} integrator traces the "
                                 f"whole tree, which no rank of a scene "
                                 f"partition holds: partitioned renders "
                                 f"take the wavefront integrator")
            batch = (self.cfg.frame_batch
                     if integrator in ("wavefront", "direct") else 1)
            out, rays = [], 0
            for c0 in range(0, self.n_rays, self.chunk):
                contribution, r = self._render_chunk(
                    integrator, slice(c0, c0 + self.chunk),
                    self.chunk_key(c0 // self.chunk), batch)
                out.append(contribution)
                rays = rays + r
            self.accum = self.accum + torch.cat(out, dim=0)[self.shard]
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

    def sharded_statics(self) -> dict:
        """Keyword arguments of this renderer's sharded wavefront frames
        (render_sample_impl's), apart from the mode's own."""
        cfg = self.cfg
        return dict(width=self.pad_w, height=self.pad_h,
                    max_bounces=cfg.max_bounces, nee=cfg.nee_enabled,
                    compaction=cfg.compaction,
                    compaction_divs=tuple(cfg.compaction_divs),
                    stack_depth=self.meta.stack_depth,
                    leaf_size=self.meta.leaf_size, model=cfg.microfacet,
                    textured=self.meta.has_textures,
                    mips=self.meta.mip_levels > 1, sun=cfg.sun_enabled,
                    sun_mode=cfg.sun_mode, sampler=cfg.sampler,
                    delta=self.meta.has_delta)

    def _render_sharded(self, key):
        """One frame of this rank: samples_per_frame samples of its pixel
        shard (parallel/mesh.py), or of the scene partition."""
        cfg = self.cfg
        kwargs = self.sharded_statics()
        if self.partition is not None:
            from gpupathtracer_tpu_torch.parallel.partition import \
                render_sample_partitioned
            table, route = self.partition
            return render_sample_partitioned(
                self.mesh, table, route, self.scene, self.camera,
                self.pixel_x, self.pixel_y, key,
                sample_base=self.num_samples,
                packet_size=self.packet_size,
                partition_routing=cfg.partition_routing, **kwargs)
        from gpupathtracer_tpu_torch.parallel.mesh import \
            render_sample_sharded
        return render_sample_sharded(
            self.mesh, self.scene, self.camera, self.pixel_x, self.pixel_y,
            key, sample_base=self.num_samples, shadow_rev=cfg.shadow_rev,
            shadow_sort=cfg.shadow_sort,
            tsort_alternate=cfg.tsort_alternate, traversal=cfg.traversal,
            bounce_traversal=self.bounce_traversal,
            treelet_min=cfg.treelet_min,
            packet_size=min(self.packet_size, self.chunk), **kwargs)

    def _render_chunk(self, integrator: str, sl: slice, key, batch: int = 1):
        """Returns ([C, 3] contribution, rays traced)."""
        cfg = self.cfg
        direct = integrator == "direct"
        px, py = self.pixel_x[sl], self.pixel_y[sl]
        depth = dict(width=self.pad_w, height=self.pad_h,
                     stack_depth=self.meta.stack_depth,
                     leaf_size=self.meta.leaf_size, traversal=cfg.traversal)
        if integrator == "reference":
            # Diffuse-specular only, level 0 of the maps, sun on a miss.
            out = render_sample_reference(
                self.scene, self.camera, px, py, key,
                max_bounces=cfg.max_bounces, model=cfg.microfacet,
                textured=self.meta.has_textures, sun=cfg.sun_enabled,
                **depth)
            return out, self.chunk
        if integrator == "ao":
            return render_sample_ao(self.scene, self.camera, px, py, key,
                                    **depth)
        if self.use_mega:
            mk = self.mega_statics(integrator)
            if batch > 1:
                return render_sample_mega_batch(
                    self.scene, self.mega_tables, self.camera, px, py, key,
                    spp=batch, sample_idx=self.num_samples, **mk)
            return render_sample_mega(
                self.scene, self.mega_tables, self.camera, px, py, key,
                sample_idx=self.num_samples, **mk)
        kwargs = dict(max_bounces=0 if direct else cfg.max_bounces,
                      nee=True if direct else cfg.nee_enabled,
                      compaction=cfg.compaction,
                      compaction_divs=tuple(cfg.compaction_divs),
                      model=cfg.microfacet,
                      bounce_traversal=self.bounce_traversal,
                      treelet_min=cfg.treelet_min,
                      textured=self.meta.has_textures,
                      mips=self.meta.mip_levels > 1,
                      sun=cfg.sun_enabled,
                      sun_mode=cfg.sun_mode,
                      shadow_rev=cfg.shadow_rev,
                      shadow_sort=cfg.shadow_sort,
                      tsort_alternate=cfg.tsort_alternate,
                      sort_rays=False if direct else cfg.sort_rays,
                      sampler=cfg.sampler,
                      packet_size=self.packet_size,
                      delta=self.meta.has_delta, **depth)
        if batch > 1:
            return render_sample_batch(self.scene, self.camera, px, py, key,
                                       spp=batch, sample_idx=self.num_samples,
                                       **kwargs)
        return render_sample_impl(self.scene, self.camera, px, py, key,
                                  sample_idx=self.num_samples, **kwargs)

    def reset_samples(self) -> None:
        """ResetSamples (Renderer.cpp:687-691)."""
        self.accum = torch.zeros_like(self.accum)
        self.num_samples = 0

    # -- output ---------------------------------------------------------------

    def film_accum(self) -> torch.Tensor:
        """The whole accumulator [n_rays, 3] in ray order: under a mesh the
        ranks' shards gathered over the pixels axis (every rank of the
        mesh must call this)."""
        if self.mesh is None:
            return self.accum
        from gpupathtracer_tpu_torch.parallel import comm
        return comm.all_gather(self.accum, self.mesh.groups[
            self.pixels_axis]).reshape(self.n_rays, 3)

    def is_writer(self) -> bool:
        """Whether this process writes the frame's files: rank 0 of a
        mesh, or the one process."""
        import torch.distributed as dist
        return self.mesh is None or dist.get_rank() == 0

    def _unpermute(self) -> torch.Tensor:
        """Accumulator (ray order) -> film pixel order, [pad_h*pad_w, 3];
        the slot past the film absorbs the sentinel rays."""
        n = self.pad_h * self.pad_w
        flat = torch.zeros((n + 1, 3), dtype=torch.float32,
                           device=self.device)
        flat[self._ray_to_pixel] = self.film_accum()
        return flat[:n]

    def film_hdr(self) -> np.ndarray:
        """Mean radiance per pixel, [H, W, 3] float32 (pre-tonemap)."""
        img = self._unpermute().reshape(self.pad_h, self.pad_w, 3)
        img = img[:self.height, :self.width].cpu().numpy()
        return img / max(self.num_samples, 1)

    def present_device(self) -> torch.Tensor:
        """Tonemapped LDR frame [H, W, 3] as a tensor on the renderer's
        device (no host copy): a caller can enqueue the next frame before
        paying this one's transfer (render/viewer.py)."""
        img = present_op(self._unpermute().reshape(self.pad_h, self.pad_w, 3),
                         max(self.num_samples, 1),
                         exposure=self.cfg.exposure,
                         tonemap=self.cfg.tonemap)
        return img[:self.height, :self.width]

    def present(self) -> np.ndarray:
        """Tonemapped LDR frame [H, W, 3] in [0, 1]. Row 0 is the bottom
        scanline (GL convention); save with flip_y=True."""
        return self.present_device().cpu().numpy()

    def save_screenshot(self, path: str) -> str:
        """SaveScreenshot (Renderer.cpp:697-705): tonemapped PNG, y-flipped
        (under a mesh every rank calls it, rank 0 writes the file)."""
        img = self.present()
        return save_png(path, img, flip_y=True) if self.is_writer() else path

    def render(self, spp: int, integrator: Optional[str] = None,
               verbose: bool = False) -> np.ndarray:
        """Accumulate ``spp`` frames and return the LDR frame."""
        for s in range(spp):
            self.render_frame(integrator)
            if verbose and (s + 1) % max(spp // 10, 1) == 0:
                print(f"  sample {s + 1}/{spp} ({self.stats.avg_fps:.2f} fps)")
        return self.present()
