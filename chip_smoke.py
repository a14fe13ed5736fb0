#!/usr/bin/env python3
"""Smoke check of gpupathtracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and g++. Phases, each of which raises on failure:

  1. versions and the card's name and power limit; CUDA must be present;
  2. build the MT-leaf traversal kernels (csrc/traverse.cu, with its
     interleave and multi-pop schedules and their pop-counting variants),
     the cluster traversal kernel (csrc/cluster_traverse.cu, with its
     counting and pop_skip variants), the megakernel (csrc/megakernel.cu),
     the dense intersection (csrc/dense_intersect.cu), the sub-packet
     traversal (csrc/subpacket_traverse.cu) and the roofline probes
     (csrc/roofline.cu) with nvcc, all at once; ptxas registers, stack
     frame and spills of every instantiation, and any wgmma chain ptxas
     serializes; the bf16 product's kernel must issue HGMMA (its SASS,
     cuobjdump); the node probe's longest loop in its SASS, by opcode;
  R. the roofline probes: each against its plain version at a small
     iteration count in every copy (bitwise; the bf16 product within a
     stated bound, its maximum printed), at every shape, tile, tc and mode
     that tools/torch_roofline.py run_compact launches (the cluster body
     also on the tie blocks of tests/test_torch_kernel.py, tc 128 and
     256: equal t at slots j, j + 32, ..., the lowest slot wins; the leaf
     body also on the edge rows of tests/test_torch_kernel.py, det = 0,
     equal t, rays parallel to a triangle or pointing away, and the node
     body on its edge rows, flat, point, inverted and half-unbounded boxes,
     a box around every origin, zero direction components and o * inv NaN,
     each at G = 16 and 1 and at 70 pops, the rows wrapping), and the f32
     product at the other shapes of its main(); the first of each timed
     (the bf16 product at both its shapes, 128^3 and 512^3) with its plain
     version and, for the products, torch.matmul on the same shapes, with
     the float32 matmul precision it ran at (cuBLAS in full FP32, not
     TF32), a kernel slower than it named; then run_compact itself, every
     probe launched, its rates printed;
  3. each MT-leaf entry point against its plain torch version on the
     card, on the sponza and bathroom tables, with 65,536 camera rays plus
     65,536 random-direction rays from surface points, about 10% of lanes
     inactive: prim and occluded equal, t/u/v bitwise equal; kernel and
     plain times by CUDA events; B1 at 64, 128 and 256 threads a block
     (bitwise, each timed) and at stack depths 48 and 192 (its stack is in
     shared memory: depth x threads x 4 bytes a block), with and without
     counters, bitwise the plain version's; then the twin table of
     tests/test_torch_kernel.py (every triangle twice, one a leaf: sibling
     boxes tie in t_near, each hit a tie the lower slot must win), 131,072
     rays, closest and any-hit with and without counters, bitwise;
  3b. on the same tables and rays, the interleave schedule (2 and 4 rays a
     thread), the multi-pop schedule (2 pops an iteration) and the
     sub-packet kernel (packets of 128, 256 and 2048 rays; closest ordered
     and unordered, with the per-packet pop counts), closest and any-hit,
     each against its plain version (every field bitwise equal) and
     against phase 3's kernel output (t and occluded bitwise equal; lanes
     where another triangle at bitwise the same t won are counted and
     printed); the interleave also at stack depth 192 and with every ray
     inactive, hits and pop counts bitwise B1's; the multi-pop schedule
     also at Q = 4, stack bound 48 (192 entries), and at Q = 2 with a
     bound that drops pushes, with counters: every field and count
     bitwise the plain version's, t and occluded bitwise B1's in every
     lane that dropped none; the sub-packet kernel
     also timed at each K on the kernel
     A/B tool's 2^19 incoherent rays, t and occluded bitwise the per-ray
     kernel's;
     S: the pop counters of every schedule (B1, W = 2 and 4, Q = 2),
     closest and any-hit, per ray bitwise equal to the plain version's,
     the interleave's equal to B1's, the multi-pop's dropped pushes 0, the
     hits with counters bitwise those without; the pop account of B1,
     B7 (W = 2) and B8 (Q = 2) (kernel time over its pops against the
     probes' floors); the dense
     intersection
     against its plain version, both roundings, on all 131,072 rays of
     bathroom and on the first 8,192 of sponza (the plain version's cost
     sets that cut); times beside phase 3's, each with its bound;
  3c. treelet-sorted dispatch on sponza: 131,072 random-direction rays from
     the primaries' hit points (tools/torch_kernel_bench.py's incoherent
     set), hits of traversal="tsort" bitwise equal to the unsorted
     traversal's; kernel time on sorted against unsorted rays, and the
     sort's own time, for the top1 and top2 keys;
  4. each cluster entry point against its plain version on the sponza and
     bathroom cluster tables (cluster_tris = 128) with phase 3's rays:
     t/prim/u/v and occluded bitwise equal; times beside phase 3's, with
     their bounds; the counters and pop_skip (closest) against the plain
     version's, bitwise, the hits bitwise those without; the pop account
     of B1 and of B4 closest and any-hit (kernel time over pops, ns a
     pop, against the probes' per-pop floors); then the same checks on
     the tie case of tests/test_torch_kernel.py (every triangle of a soup
     twice, the twins in one block: each hit a tie the lower slot wins);
  A. (after phase 4 on sponza) the table arities: sponza's MT table and
     its cluster table (tc 128) built at each arity of CARD_ARITIES (16
     and 4; csrc/traverse.cu and csrc/cluster_traverse.cu built with
     -DGPT_ARITY=A in phase 2, every instantiation's ptxas line printed),
     phase 3's rays: B1 closest and any-hit, B7 (W = 2), B8 (Q = 2) and
     B4, each bitwise its plain version; B1's and B4's closest t and
     B1's occlusion bitwise arity 8's kernel's on the same rays (where
     another triangle won at bitwise the same t, the lanes are counted and
     printed); each timed by CUDA events beside arity 8's build in the
     order 8, A, A, 8, with its bound; after phase T's renders, the path
     that drives them: the kernel A/B tool at --arity A on bathroom (B1,
     B7, B8, B4, closest and any-hit, every variant's t or occlusion its
     plain version's);
  T. (on sponza) start entries and the treelet traversal: B1 and B4 with
     roots, one a 2048-ray packet (the table's treelet-cut roots in turn, a
     leaf entry, an INVALID packet), bitwise their plain versions (a check:
     no path of the port passes roots to B4; B1's any-hit takes them on
     the treelet occlusion query and phase 19's partition);
     trace_closest_treelet / trace_occluded_treelet, each called once as a
     path of its own, on
     phase 3's rays against B1's whole-tree hits (t and occluded bitwise,
     prim but where another triangle is hit at bitwise the same t), rounds
     and time beside B1's; after phase 6, the CLI on sponza 1920x1080, 64
     bounces, 1 spp: the default, with --wide-arity 16 and with
     --bounce-traversal treelet (ray_chunk 2^17, treelet_min 2^15), each
     film against the default's (ray counts within RAY_SHARE, at most
     PIXEL_SHARE of pixels outside rtol = atol = FILM_TOL, both printed),
     s/sample and Mrays/s printed;
  5. the golden recipe of tests/test_golden.py (cornell, 32x32, 8 spp) on
     the card against tests/golden/cornell_32_8spp.npz;
  6. the main path through the CLI: proc:sponza 1920x1080 with 64 bounces
     at 3 spp, twice with --bounce-traversal tsort (treelet-sorted bounce
     rays) and twice with auto (which is same on the card), in the order
     tsort, auto, auto, tsort, the four films bitwise equal, sorts only in
     the tsort runs; and
     proc:bathroom 1280x720 (Beckmann, default DoF camera) at 4 spp, with
     the C++ SBVH; films finite and nonzero,
     PNGs written, and both MT entry points, and no other, launched by
     these renders;
  6b. the kernel A/B entry point, tools/torch_kernel_bench.py main, on
     proc:sponza over packet, tsort, subpacket and tsort-sub with
     --interleave 1,2 and --multi-pop 2, closest and any-hit, and on
     proc:bathroom over dense and dense-vpu: every entry point of phase
     3b launched, every tree-walk variant bitwise equal to the first; and
     the kernel-accounting entry points: tools/torch_kernel_bench.py
     --stats on proc:sponza (2^19 rays a set; packet W 1, 2, Q 2,
     subpacket, and --cluster-tc 128 --pop-skip), every counting kernel
     launched, and tools/torch_mega_profile.py --time at its defaults
     (bathroom 1280x720, 64 bounces): the megakernel's counting variant
     launched, the frame's pops printed;
  7. the cluster path through the CLI, the JAX bench's cluster rows:
     bathroom 1280x720 (Beckmann, DoF) at 4 spp and sponza 1920x1080 with
     64 bounces at 1 spp, --cluster-tris 128; both cluster entry points
     launched and neither MT entry point;
  7b. the port bench, tools/torch_bench.py --quick, in process: every
     quick row present (realtime direct, the sponza 640x360 probe of
     default, fpair and tsort, the winner's timed batches), its times
     finite and positive, both MT entry points launched and no other;
  8. the megakernel against its plain torch version on the card: bathroom
     256x144 (Beckmann, default DoF camera, 64 bounces) at 1 spp and with
     in-kernel regeneration at 4 spp, table 200x150 direct at 8 spp, on
     MT leaves and on cluster leaves (cluster_tris = 128): ray counts
     equal, contributions bitwise equal (at most 0.1% of lanes may
     differ, and those are printed); kernel and plain times; the counting
     variant's contributions bitwise the kernel's, its [P, 9] counters
     equal to the plain version's in every packet whose lanes all agree;
     the pop account of B2; every MT instantiation's ptxas line
     (registers, stack frame, spills); then the cluster megakernel (each
     cluster pop run by the whole warp) on the soups of
     tests/test_torch_kernel.py,
     the twin-triangle tie case (tc 128) and a tc 256 soup, 97 x 61 lanes
     (not a multiple of 32), one sample and four with regeneration: lanes,
     ray counts and [P, 9] counters bitwise the plain version's;
  9. the megakernel against its plain version at the arguments of the
     rows of phases 10 and 11: the first chunk of each row's first frame,
     built as the Renderer builds it (the row's own samples a lane), runs
     through the kernel on all its lanes; its first two packets run
     through the kernel alone (the same lanes must come out), and at no
     more than 32 samples a lane (MEGA_CHECK_SPP; the 64- and 128-sample
     rows are cut to 32 to keep the smoke under 800 s) through the kernel
     and the plain version (held as in phase 8; phase 8 holds the
     counters);
 10. the megakernel path through the CLI, the JAX bench's megakernel rows
     at their published sizes: bathroom 1280x720 Beckmann DoF (frame batch
     64), table 800x600 with 64 bounces (frame batch 128) and table
     800x600 direct (frame batch 8), black sky, one chunk; films finite
     and nonzero, PNGs written, the megakernel launched and no traversal
     kernel;
 11. the megakernel's cluster walks through the CLI, the bench's
     megacluster rows: bathroom 1280x720 Beckmann DoF and table 800x600
     with 64 bounces, --cluster-tris 128, at frame batch 1 and at 64 / 128;
     the cluster megakernel launched and no other kernel;
 12. the megakernel against the wavefront integrator on the card: table
     200x150, 64 bounces, 64 spp, film means within 2%;
 13. cluster leaves against MT leaves through the megakernel, the same
     render: film means within 2% (in exact arithmetic both trace the
     same hits);
 14. the reference and AO integrators, textures with mips and the sun at
     full width, each through its entry point: the CLI with --integrator
     reference on proc:sponza 1920x1080 (64 bounces, 2 spp) and --integrator
     ao there (4 spp); the port's generated textured town (24 houses,
     about 55k triangles) at 1280x720 with --mip-levels 4 (4 spp); and the
     Renderer with sun_enabled, sun_mode "disk" and "cone", on proc:bunny
     1280x720 under a black sky (4 spp); PNGs written, films finite and
     nonzero, AO's in [0, 1], s/sample printed beside the card; the
     reference launching the closest-hit kernel and no other, the rest
     both MT entry points and no other;
 15. agreement on the card, the JAX package's tests/test_integrator.py
     recipes and bounds: cornell 32x32, wavefront at 12 spp against the
     reference at 48, channel means within 8%; bunny 24x24 with the sun,
     the same two, means within 25%; the sun's cone against its disk
     (16 spp each), means within 15%;
 17. (after phase 14) the delta materials, glTF, image skies, the bounce
     coherence sort, light-end shadow rays and the ld sampler at full
     width, each render launching both MT entry points and no other, its
     PNG written, its film finite and nonzero, its s/sample printed beside
     the card: (a) proc:sponza with its columns and sphere stone made
     mirrors and its banners glass (ior 1.5), 1920x1080, 64 bounces, 2 spp
     through the Renderer, has_delta set, the share of lanes that hit a
     delta surface printed; (b) proc:sponza's mesh written as a .glb (one
     primitive a material, the banners KHR_materials_transmission 1.0)
     through the CLI at 1920x1080, 64 bounces, 1 spp, its triangle count
     sponza's and has_delta set, and the demo glTF (write_demo_gltf) at
     1280x720, 4 spp; (c) proc:bunny 1280x720, 4 spp, under a 2048x1024
     PNG equirect and under a .txt cubemap of six 512x512 PNG faces; (d)
     proc:sponza 1920x1080, 64 bounces, 1 spp, one scene load: the
     sort_rays film bitwise the default film with the same rays, the
     shadow_rev film's channel means within 1% of the default's (the
     pixels outside rtol = atol = 2e-3 printed); (e) proc:sponza 1920x1080
     through --sampler ld, 2 spp, and r2_sequence, pixel_rotation and the
     jitter on the card bitwise the CPU's over all 2,073,600 pixel ids at
     sample indices 0, 1, 2^24 - 1 and 2^32 - 2;
     then phase 15 adds the JAX package's recipes for these paths on the
     card: tests/test_integrator.py's mirror material (max > 3, 20th
     percentile < 0.5) and glass furnace (0.80 < mean < 1.1),
     tests/test_ld_sampler.py's deterministic ld render and
     tests/test_edge_cases.py's cubemap face colours;
 16. the card against the CPU: the reference, AO, sun (disk and cone),
     textured (mips), mirror-and-glass, cubemap sky, ld, shadow_rev and
     sort_rays renders at 32x32 on the card and through the port's plain
     versions on the CPU, the same seed: at most 1% of pixels outside
     rtol = atol = 2e-3, channel means within 1% (the CPU port is held to
     the JAX package by the CPU tests, which closes the chain);
 18. checkpoints, the scene disk cache, the viewer and the plain torch
     walks: (b) a cold and a warm load_scene of sponza with the disk
     cache in a temporary folder, every tensor bitwise, both times; (a)
     sponza 1920x1080 through the CLI (its scene from that cache), --spp 1
     --checkpoint, then --resume --spp 1, bitwise (0 pixels) the --spp 2
     film, the file's bytes and its save and load seconds; (c) --viewer-bench 60 on proc:table
     640x360, direct and wavefront, fps and encode ms; (d) (after phase T)
     the "packet" and "perray" traversals, closest and any-hit, and
     closest_hit_trail's t and prim, on phase 3's sponza rays, t and
     occlusion bitwise B1's (prims but at true ties, printed), the packet
     fallback on sponza's cluster table bitwise the per-ray walk and its
     prims B4's (but where B4's triangle hits at the same t within 1e-6,
     printed), none launching a kernel, each timed beside B1; (e) a
     proc:bathroom 256x144 one-sample film through "packet" and "perray"
     (no kernel launch) bitwise the default film, s/sample of each. The
     earlier phases' CLI runs pass --no-cache, so that no run reads a
     cache file another checkout left.
 19. multi-device rendering (parallel/) on the card's one GPU, each run
     of ranks ended by its own deadline (P19_DEADLINE): (a) one NCCL rank
     on cuda:0: every collective of parallel/comm.py on CUDA tensors
     exact and none staged through the host, render_sample_sharded over a
     one-rank mesh bitwise render_sample_impl with the folded key
     (bathroom 256x144); (b) 4 gloo ranks, all on cuda:0 (NCCL refuses
     two ranks on one GPU; comm.py stages CUDA tensors through the host
     under gloo and counts the bytes): phase 3's 131,072 sponza rays
     through the partitioned trace, ring and routed, closest and any-hit,
     with their counters: t bitwise B1's whole-table hits (prims but at
     true ties, counted), occlusion equal, the routed results bitwise the
     ring's; V, pops a hop, bytes staged a hop and host-clock ms beside
     B1's whole-table time; each rank's local B1 launch from its steady
     root, closest and any-hit, bitwise its plain version; (c) sponza
     1920x1080 at its 64 bounces, one frame each in 4 gloo ranks: the
     (2, 2) mesh Renderer and the 4-rank partition Renderer, ring and
     routed (the films bitwise), their launches (B1 with roots, closest
     and any-hit, on the partition), s a frame beside one process's; the
     ring's frame (compaction on, the Renderer's default) bitwise each
     rank's whole-table render with the same folded key and the same
     collective loop conditions, the compaction phases each rank ran
     printed; a compaction-free partitioned frame (P19_FREE_BOUNCES
     bounces: every bounce at full width) bitwise each rank's whole-table
     render with the same folded key; (d) bathroom 256x144 through
     render_sample_mega_sharded, 2 gloo ranks x 4 samples, bitwise the
     sum of this process's megakernel calls with the folded keys.
     ``python3 chip_smoke.py --phase19`` runs phase 19 alone (no result
     line).
 20. (after phase 19) the image decoders (ROADMAP.md C6): (a) the JPEG
     decoder built from utils/jpeg_cpp/jpeg.cpp with g++ on this host (its
     build timed), every committed fixture of tests/golden/images
     (tools/torch_image_fixtures.py: PIL's encodes, its decodes as PNG
     twins) decoded bitwise its PNG twin and the manifest's pixel sha256,
     host ms (median of 5) and MPix/s a fixture beside its twin's PNG
     decode and the host CPU's model name; (b) the generated town at
     1280x720, 4 mip levels, 1 spp through the CLI, once with its .mtl on
     the four JPEG maps and once on their PNG twins: the films bitwise
     equal; (c) proc:bunny at 1280x720, 1 spp, under the 512x256 JPEG
     equirect sky and under its PNG twin: bitwise equal; B1's launches
     of (b) and (c) are counted in the kernels line.
     ``python3 chip_smoke.py --phase20`` runs phase 20 alone (no result
     line).
 21. (after phase 20) the image formats beside JPEG (ROADMAP.md C6): (a)
     utils/codecs_cpp/codecs.cpp built with g++ on this host (built in
     phase 2 beside nvcc; the load timed here), then every committed
     fixture of tests/golden/images that phases 20 and 22 do not decode
     (DDS uncompressed and BC1, BC3, BC4, BC5, BC6H UF16 / SF16, BC7; TIFF
     LZW and tiled Deflate; PSD RLE; BMP; GIF; CMYK and YCCK JPEG) decoded
     bitwise its PNG twin and the manifest's pixel sha256, host ms
     (median of 5) and MPix/s a fixture beside its twin's PNG decode;
     (b) the generated town at 1280x720, 4 mip levels, 1 spp through the
     CLI, its .mtl on lossless re-encodings of phase 20's PNG twins
     (checker TIFF LZW, bricks PSD RLE, roof uncompressed DDS, foliage
     BMP): the film bitwise phase 20b's PNG-twin film (rendered here too
     when phase 21 runs alone); B1's launches of (b) are counted in the
     kernels line. ``python3 chip_smoke.py --phase21`` runs phase 21 alone
     (no result line).
 22. (after phase 21) WebP (ROADMAP.md C6): (a) utils/webp_cpp/webp.cpp
     built with g++ on this host (in phase 2 beside nvcc; the load timed
     here), then every committed WebP fixture of tests/golden/images
     (lossless re-encodings of the town's PNG twins, lossy at q75, lossy
     RGBA with ALPH, an animation whose first frame is offset, the simple
     loop filter, eight token partitions) decoded bitwise its PNG twin
     and the manifest's pixel sha256, host ms (median of 5) and MPix/s a
     fixture beside its twin's PNG decode; (b) the generated town at
     1280x720, 4 mip levels, 1 spp through the CLI, its .mtl on the
     lossless WebP re-encodings of phase 20's PNG twins: the film bitwise
     phase 20b's PNG-twin film (rendered here too when phase 22 runs
     alone); B1's launches of (b) are counted in the kernels line.
     ``python3 chip_smoke.py --phase22`` runs phase 22 alone (no result
     line).
 23. (after phase 22) the rest of JPEG (ROADMAP.md C6): (a) every
     committed fixture of the fourth image slice (arithmetic-coded
     sequential and progressive files with restarts and DAC conditioning,
     lossless files at predictors 1-7, a file without DHT, progressive
     files cut after a scan, a scan cut by EOI, a dropped RST marker)
     decoded bitwise its PNG twin and the manifest's pixel sha256, host ms
     (median of 5) and MPix/s a fixture beside its twin's PNG decode; (b)
     the generated town at 1280x720, 4 mip levels, 1 spp through the CLI,
     its .mtl on arithmetic-coded transcodes of phase 20's checker (SOF9)
     and roof (SOF10) JPEGs and lossless (SOF3) encodings of the bricks
     and foliage twins: the film bitwise phase 20b's PNG-twin film
     (rendered here too when phase 23 runs alone); B1's launches of (b)
     are counted in the kernels line. ``python3 chip_smoke.py --phase23``
     runs phase 23 alone (no result line).
 24. (after phase 23) the simple formats (ROADMAP.md C6): (a) every
     committed PNM / PFM, QOI, ICO, CUR, SGI, PCX and DIB fixture decoded
     bitwise its PNG twin and the manifest's pixel sha256, host ms (median
     of 5) and MPix/s a fixture beside its twin's PNG decode; (b) the
     generated town at 1280x720, 4 mip levels, 1 spp through the CLI, its
     .mtl on lossless re-encodings of phase 20's PNG twins (checker as P6
     PPM, bricks as QOI, roof as run-length SGI, foliage as 3-plane PCX):
     the film bitwise phase 20b's PNG-twin film (rendered here too when
     phase 24 runs alone); B1's launches of (b) are counted in the kernels
     line. ``python3 chip_smoke.py --phase24`` runs phase 24 alone (no
     result line).
 25. (after phase 24) the rest of TIFF (ROADMAP.md C6): (a) every
     committed fixture of the sixth image slice (CCITT, ZSTD, ThunderScan,
     old-style LZW, fill order 2, orientations 2-8, 12-bit, signed and
     32-bit grey, planar 16-bit, YCbCr, Lab and a Lab PSD) decoded
     bitwise its PNG twin and the manifest's pixel sha256, host ms (median
     of 5) and MPix/s a fixture beside its twin's PNG decode; (b) the
     generated town at 1280x720, 4 mip levels, 1 spp through the CLI, its
     .mtl on ZSTD TIFFs of phase 20's PNG twins (predictor 2; roof stored
     transposed under Orientation 6): the film bitwise phase 20b's
     PNG-twin film (rendered here too when phase 25 runs alone); B1's
     launches of (b) are counted in the kernels line. ``python3
     chip_smoke.py --phase25`` runs phase 25 alone (no result line).
 26. (after phase 25) JPEG 2000 and ICNS (ROADMAP.md C6): (a) every
     committed fixture of the seventh image slice (J2K and JP2 files of
     PIL's save options and modes, OpenJPEG's code-block styles, ROI, SOP
     / EPH, tile-parts, TLM, POC, PPM / PPT, subsampling, 12 bits, edited
     marker segments and JP2 boxes, a 1024x1024 JP2; ICNS of each element
     kind) decoded bitwise its PNG twin and the manifest's pixel sha256,
     host ms (median of 3) and MPix/s a fixture beside its twin's PNG
     decode; (b) the generated town at 1280x720, 4 mip levels, 1 spp
     through the CLI, its .mtl on lossless 5/3 re-encodings of phase 20's
     PNG twins (checker and foliage as JP2, bricks as a tiled RPCL J2K,
     roof as an ICNS whose JPEG 2000 element PIL picks): the film bitwise
     phase 20b's PNG-twin film (rendered here too when phase 26 runs
     alone); B1's launches of (b) are counted in the kernels line.
     ``python3 chip_smoke.py --phase26`` runs phase 26 alone (no result
     line).
 27. (after phase 26) the rest of JPEG 2000 and AVIF at open (ROADMAP.md
     C6, C9): (a) every HTJ2K fixture (tools/torch_htj2k.py: 5/3 and 9/7,
     cleanup, SigProp and MagRef passes, code-blocks of 8x8 to 64x64,
     layers, tiles, vertically causal contexts, 1-4 components, a JP2) and
     Part 2 fixture (OpenJPEG's opj_set_MCT files, MCT / MCC / MCO / CBD
     segments in PIL's files) decoded bitwise its PNG twin and the
     manifest's pixel sha256, host ms (median of 3) and MPix/s a fixture;
     (b) the generated town at 1280x720, 4 mip levels, 1 spp through the
     CLI, its .mtl on lossless re-encodings of phase 20's PNG twins
     (checker and roof HTJ2K, bricks and foliage through an identity Part
     2 transform): the film bitwise phase 20b's PNG-twin film (rendered
     here too when phase 27 runs alone); B1's launches of (b) are counted
     in the kernels line; (c) the committed AVIF set (PIL-written still,
     alpha and animated files, their cuts and junk behind ftyp) named,
     refused or passed on as PIL's recorded verdicts say, the AVIF ones
     raising NotImplementedError naming the file, with host ms of each
     open. ``python3 chip_smoke.py --phase27`` runs phase 27 alone (no
     result line).

The second-to-last line of stdout is a JSON object with one entry per
kernel entry point (the counting variants are instantiations of theirs and
have none of their own; the builds at another arity, "_a<A>", and B1's
launches with start entries, "_roots", have entries of their own; B4's with
start entries are a check only, which no path launches); the last line is {"ok": true, "device": {...}}.
Any failure exits nonzero before that line. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_RAYS = 65536
CSRC = "gpupathtracer_tpu_torch/csrc/"
SOURCES = {"trace_closest": CSRC + "traverse.cu",
           "trace_anyhit": CSRC + "traverse.cu",
           "trace_mega": CSRC + "megakernel.cu",
           "trace_cluster_closest": CSRC + "cluster_traverse.cu",
           "trace_cluster_anyhit": CSRC + "cluster_traverse.cu",
           "trace_mega_cluster": CSRC + "megakernel.cu",
           "trace_closest_ilv": CSRC + "traverse.cu",
           "trace_anyhit_ilv": CSRC + "traverse.cu",
           "trace_closest_multi": CSRC + "traverse.cu",
           "trace_anyhit_multi": CSRC + "traverse.cu",
           "subpacket_closest": CSRC + "subpacket_traverse.cu",
           "subpacket_anyhit": CSRC + "subpacket_traverse.cu",
           "dense_closest": CSRC + "dense_intersect.cu",
           "dense_anyhit": CSRC + "dense_intersect.cu",
           "roofline_vpu": CSRC + "roofline.cu",
           "roofline_mxu_f32": CSRC + "roofline.cu",
           "roofline_mxu_bf16": CSRC + "roofline.cu",
           "roofline_node_slab": CSRC + "roofline.cu",
           "roofline_leaf_mt": CSRC + "roofline.cu",
           "roofline_cluster_dense": CSRC + "roofline.cu"}
REPLACES = {"trace_closest": "gpupathtracer_tpu/ops/pallas_traverse.py:72",
            "trace_anyhit": "gpupathtracer_tpu/ops/pallas_traverse.py:72 "
                            "(any-hit mode), "
                            "gpupathtracer_tpu/ops/pallas_traverse.py:1036",
            "trace_mega": "gpupathtracer_tpu/ops/megakernel.py:188",
            "trace_cluster_closest":
                "gpupathtracer_tpu/ops/pallas_traverse.py:307",
            "trace_cluster_anyhit":
                "gpupathtracer_tpu/ops/pallas_traverse.py:307 (any-hit mode)",
            "trace_mega_cluster": "gpupathtracer_tpu/ops/megakernel.py:188 "
                                  "(cluster=True: :416-482, :609-645, "
                                  ":1098-1104)",
            "trace_closest_ilv":
                "gpupathtracer_tpu/ops/pallas_traverse.py:809",
            "trace_anyhit_ilv":
                "gpupathtracer_tpu/ops/pallas_traverse.py:809 (any-hit mode)",
            "trace_closest_multi":
                "gpupathtracer_tpu/ops/pallas_traverse.py:584",
            "trace_anyhit_multi":
                "gpupathtracer_tpu/ops/pallas_traverse.py:584 (any-hit mode)",
            "subpacket_closest":
                "gpupathtracer_tpu/ops/subpacket_traverse.py:58",
            "subpacket_anyhit":
                "gpupathtracer_tpu/ops/subpacket_traverse.py:58 (any-hit "
                "mode)",
            "dense_closest": "gpupathtracer_tpu/ops/dense_intersect.py:105",
            "dense_anyhit": "gpupathtracer_tpu/ops/dense_intersect.py:105 "
                            "(any-hit mode)",
            "roofline_vpu": "tools/roofline.py:129",
            "roofline_mxu_f32": "tools/roofline.py:177 (f32)",
            "roofline_mxu_bf16": "tools/roofline.py:177 (bf16)",
            "roofline_node_slab": "tools/roofline.py:253",
            "roofline_leaf_mt": "tools/roofline.py:289",
            "roofline_cluster_dense": "tools/roofline.py:332"}
# The least time the card could take for a kernel's work (its bound): the
# larger of the FP32 operations this run's rays need over the H100's 67
# TFLOP/s outside the tensor cores and the bytes they must move over its
# 3.35 TB/s of HBM (NVIDIA's SXM data sheet, at 700 W). Operations are
# counted from the plain versions' pops (kernel_traverse.count_pops): a
# node pop slab-tests 8 children (6 FMAs, counted as 2 operations each, and
# 6 min/max per child); a Moller-Trumbore slot is about 50 operations, a
# cluster slot about 40 (6 three-term dot products, 3 adds, a division,
# 2 FMAs, the compares); the megakernel adds about 400 operations of
# shading per traced ray. Bytes, each once: of each distinct node row the
# 56 floats the walk reads (8 children's bounds and entries, 224 B; the
# rest of the 128-float row is padding), of each distinct MT leaf its used
# 48-byte slots (mt_leaf_bytes), of each distinct cluster block the 7 rows
# the leaf reads (84 * tc B), the rays in (29 B) and the results out (16 B
# closest, 1 B any-hit, 12 B per megakernel lane). A schedule of the walk
# (interleave, multi-pop, sub-packets) computes the per-ray walk's function
# of the same rays, so its bound is trace_closest's / trace_anyhit's on
# those rays, whatever work the schedule itself adds (the sub-packet
# kernel's slab tests per ray still walking are printed as a reading of
# their own). A pair of the dense intersection is a cluster slot's test on
# the same operands and is counted as one (40; the kernel's body has 6
# three-term dots of a multiply and 2 FMAs, 3 adds, a division, 2 FMAs, an
# add and 5 compares: 44 with an FMA as two); its bytes are the table once
# and the rays.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
NODE_OPS, MT_SLOT_OPS, CLUSTER_SLOT_OPS, SHADE_OPS = 8 * 18, 50, 40, 400
DENSE_PAIR_OPS = CLUSTER_SLOT_OPS
NODE_ROW_BYTES = 7 * 8 * 4
# Rays of the sponza dense check (259,762 triangles): the plain version's
# [rays, tile] temporaries over 508 tiles set the cut.
DENSE_SPONZA_RAYS = 8192
SUBPACKET_K = 2048
# Phase 3b holds the sub-packet kernel at these packet sizes, and times it
# on phase 3's rays and on the kernel A/B tool's 2^19 rays.
SUBPACKET_KS = (128, 256, SUBPACKET_K)
SUBPACKET_SCALE_RAYS = 1 << 19
SECTOR = 32
# At most this share of lanes may differ between the megakernel and its
# plain version (exact ties or a last-place difference of a libdevice
# function can turn one path); every other lane must be bitwise equal.
MEGA_LANE_BOUND = 1e-3


def _events_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, after one warm-up run."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _test_rays(scene, meta, cfg, device):
    """65,536 camera rays of the scene's default camera at cfg's film size,
    then 65,536 rays from the surface points they hit, in random
    directions. Returns o, d [2N, 3], a random t_max [2N] for the
    occlusion queries, and a random active mask [2N], about 90% true, as
    the integrator's masks are after rays die."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.math.camera import (gen_rays,
                                                     generate_image_plane)
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    rng = np.random.RandomState(1234)
    pix = rng.randint(0, cfg.width * cfg.height, N_RAYS)
    interp = np.stack([(pix % cfg.width + rng.rand(N_RAYS)) / cfg.width,
                       (pix // cfg.width + rng.rand(N_RAYS)) / cfg.height],
                      axis=-1).astype(np.float32)
    lens = rng.rand(N_RAYS, 2).astype(np.float32)
    cam = generate_image_plane(cfg.camera, device)
    o, d = gen_rays(cam, torch.as_tensor(interp, device=device),
                    torch.as_tensor(lens, device=device))
    far = torch.full((N_RAYS,), 1e20, device=device)
    on = torch.ones(N_RAYS, dtype=torch.bool, device=device)
    t, prim, _, _ = kt.closest_plain(scene.node_rows, o, d, far, on,
                                     stack_depth=meta.stack_depth,
                                     leaf_size=meta.leaf_size,
                                     arity=scene.arity)
    normal = scene.tri_shade[prim.clamp_min(0).long(), 0:3]
    hit = (prim >= 0)[:, None]
    o2 = torch.where(hit, o + d * t[:, None] + 0.003 * normal, o)
    d2 = torch.as_tensor(rng.normal(size=(N_RAYS, 3)).astype(np.float32),
                         device=device)
    d2 = d2 / torch.linalg.vector_norm(d2, dim=1, keepdim=True)
    o_all = torch.cat([o, o2]).contiguous()
    d_all = torch.cat([d, d2]).contiguous()
    t_occ = torch.as_tensor(rng.uniform(0.05, 20.0, 2 * N_RAYS)
                            .astype(np.float32), device=device)
    active = torch.as_tensor(rng.rand(2 * N_RAYS) < 0.9, device=device)
    return o_all, d_all, t_occ, active


def _bits(x):
    import torch
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def mt_leaf_bytes(packed: int) -> int:
    """Bytes an MT leaf's walk reads: its used 12-float slots (packed & 15
    of them, 10 to a 512-byte row), rounded up to 32-byte sectors per
    row."""
    count, nbytes = packed & 15, 0
    for first in range(0, count, 10):
        nbytes += -(-min(10, count - first) * 48 // SECTOR) * SECTOR
    return nbytes


def leaf_bytes_of(cluster_tris: int):
    """The bytes a leaf's pops read, by leaf id: mt_leaf_bytes on MT
    leaves, the 7 rows of a cluster block (84 * tc B) on cluster leaves."""
    if cluster_tris:
        return lambda _: 84 * cluster_tris
    return mt_leaf_bytes


def bound(pops: dict, *, leaf_bytes, slot_ops: int, io_bytes: int,
          extra_ops: int = 0, arity: int = 8):
    """(bound in ms, "bytes" or "operations") of a kernel's work from its
    plain version's pop counts (see PEAK_FLOPS); ``leaf_bytes`` maps a
    distinct leaf id of the counts to the bytes its pops read. A node pop
    of an ``arity``-wide table tests arity children and reads 28 * arity
    bytes of its row."""
    ops = (pops.get("node", 0) * NODE_OPS * arity // 8
           + pops.get("slots", 0) * slot_ops + extra_ops)
    nbytes = (len(pops.get("node_ids", ())) * NODE_ROW_BYTES * arity // 8
              + sum(map(leaf_bytes, pops.get("leaf_ids", ()))) + io_bytes)
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def compare_kernels(name: str, width: int, height: int, device, results):
    """Phase 3 for one scene: each entry point against its plain version.
    Returns the rays (o, d, t_occ, active) for the later phases, the scene
    and its meta, and the kernel's outputs {"closest", "occ"}."""
    import torch

    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.scene import load_scene
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    cfg = RenderConfig(scene_path=f"proc:{name}", width=width, height=height,
                       bvh_builder="cpp")
    pos, yaw, pitch, fov, aperture, focus = default_camera(name)
    cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                              fov=math.radians(fov), aspect=width / height,
                              aperture=aperture, focal_distance=focus)
    t0 = time.perf_counter()
    scene, meta = load_scene(cfg, device)
    print(f"[{name}] ingest {time.perf_counter() - t0:.2f} s: "
          f"{meta.num_triangles} triangles, {scene.node_rows.shape[0]} rows "
          f"({scene.node_rows.numel() * 4 / 1e6:.1f} MB), stack depth "
          f"{meta.stack_depth}")
    o, d, t_occ, on = _test_rays(scene, meta, cfg, device)
    far = torch.full((o.shape[0],), 1e20, device=device)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    rows = scene.node_rows

    pops_c, pops_a = {}, {}
    got = kt.closest(rows, o, d, far, on, **kw)
    want = kt.closest_plain(rows, o, d, far, on, pops=pops_c, **kw)
    err_c = _hold_hits(f"[{name}] trace_closest", got, want)
    hit = want[1] >= 0
    occ = kt.anyhit(rows, o, d, t_occ, on, **kw)
    occ_want = kt.anyhit_plain(rows, o, d, t_occ, on, pops=pops_a, **kw)
    err_a = _hold_occluded(f"[{name}] trace_anyhit", occ, occ_want)

    ms_c = _events_ms(lambda: kt.closest(rows, o, d, far, on, **kw), 10)
    plain_c = _events_ms(lambda: kt.closest_plain(rows, o, d, far, on, **kw),
                         1)
    ms_a = _events_ms(lambda: kt.anyhit(rows, o, d, t_occ, on, **kw), 10)
    plain_a = _events_ms(lambda: kt.anyhit_plain(rows, o, d, t_occ, on, **kw),
                         1)
    n = o.shape[0]
    print(f"[{name}] {n} rays, {float(on.float().mean()):.3f} active: hit "
          f"rate {float(hit.float().mean()):.3f}, occluded "
          f"{float(occ.float().mean()):.3f}; bitwise equal to the plain "
          f"versions")
    print(f"[{name}] trace_closest {ms_c:.3f} ms ({n / ms_c / 1e3:.1f} "
          f"Mrays/s), closest_plain {plain_c:.1f} ms")
    print(f"[{name}] trace_anyhit  {ms_a:.3f} ms ({n / ms_a / 1e3:.1f} "
          f"Mrays/s), anyhit_plain  {plain_a:.1f} ms")
    results[name + "_pops"] = (pops_c, pops_a)
    results[name] = {
        "trace_closest": (err_c, ms_c, plain_c, *bound(
            pops_c, leaf_bytes=mt_leaf_bytes, slot_ops=MT_SLOT_OPS,
            io_bytes=n * 45)),
        "trace_anyhit": (err_a, ms_a, plain_a, *bound(
            pops_a, leaf_bytes=mt_leaf_bytes, slot_ops=MT_SLOT_OPS,
            io_bytes=n * 30))}
    _print_bounds(name, results[name])
    b1_blocks_and_depths(name, rows, (o, d, t_occ, on), meta, got, occ)
    return (o, d, t_occ, on), scene, meta, {"closest": got, "occ": occ}


def b1_blocks_and_depths(name, rows, rays, meta, got, occ) -> None:
    """Phase 3, B1's block sizes and stack depths: closest and any-hit at
    64, 128 and 256 threads a block, each bitwise the default's and timed;
    then at stack depths 48 and 192 (the shared stack's size, depth x
    threads x 4 bytes a block), with and without counters, every output
    bitwise the plain version's at that depth, and timed."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    o, d, t_occ, on = rays
    far = torch.full((o.shape[0],), 1e20, device=o.device)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    line = []
    for th in kt.BLOCK_SIZES:
        _hold_hits(f"[{name}] trace_closest {th} threads", kt.closest(
            rows, o, d, far, on, threads=th, **kw), got)
        _hold_occluded(f"[{name}] trace_anyhit {th} threads", kt.anyhit(
            rows, o, d, t_occ, on, threads=th, **kw), occ)
        ms_c = _events_ms(lambda: kt.closest(rows, o, d, far, on, threads=th,
                                             **kw), 20)
        ms_a = _events_ms(lambda: kt.anyhit(rows, o, d, t_occ, on,
                                            threads=th, **kw), 20)
        line.append(f"{th}: closest {ms_c:.4f} ms, any-hit {ms_a:.4f} ms")
    print(f"[{name}] B1 at stack depth {meta.stack_depth}, bitwise at every "
          f"block size (default {kt.THREADS}); " + "; ".join(line))
    line = []
    for depth in (48, 192):
        kd = dict(stack_depth=depth, leaf_size=meta.leaf_size)
        for fn, plain, t_max, label in (
                (kt.closest, kt.closest_plain, far, "closest"),
                (kt.anyhit, kt.anyhit_plain, t_occ, "any-hit")):
            st = fn(rows, o, d, t_max, on, with_stats=True, **kd)
            _hold_stats(f"[{name}] B1 {label} depth {depth}", st,
                        plain(rows, o, d, t_max, on, with_stats=True, **kd))
            bare = fn(rows, o, d, t_max, on, **kd)
            _hold_stats(f"[{name}] B1 {label} depth {depth} (without "
                        f"counters)", st[:-1],
                        bare if isinstance(bare, tuple) else (bare,))
            ms = _events_ms(lambda: fn(rows, o, d, t_max, on, **kd), 10)
            line.append(f"{label} {ms:.4f} ms at depth {depth}")
    print(f"[{name}] B1 at stack depths 48 and 192: closest and any-hit, "
          f"with and without counters, bitwise the plain version's; "
          + ", ".join(line))


def compare_b1_ties(device) -> None:
    """Phase 3 on the twin table of tests/test_torch_kernel.py (every
    triangle of a soup twice, one triangle a leaf: twins are sibling leaves
    with bitwise equal boxes, so they tie in t_near and in t): 131,072
    rays, closest and any-hit, with and without counters, every output
    bitwise the plain version's; each hit on a twin pair of one node is
    won by the lower slot, which the child order pops first."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    tests = _tool_module("test_torch_kernel", "tests")
    case = tests.twin_soup_case(n_tris=2000, n_rays=2 * N_RAYS)
    table = case["wide"].node_rows
    ties = tests.tied_siblings(table)
    if not ties:
        raise AssertionError("twin table: no sibling boxes tie")
    rows = torch.as_tensor(table, device=device)
    kw = dict(stack_depth=case["depth"], leaf_size=case["leaf"])
    o, d, far, t_occ, on = (torch.as_tensor(case[k], device=device)
                            for k in ("o", "d", "far", "t_occ", "act"))
    got = kt.closest(rows, o, d, far, on, **kw)
    _hold_hits("[twins] trace_closest", got, kt.closest_plain(
        rows, o, d, far, on, **kw))
    for fn, plain, t_max, label in (
            (kt.closest, kt.closest_plain, far, "trace_closest"),
            (kt.anyhit, kt.anyhit_plain, t_occ, "trace_anyhit")):
        st = fn(rows, o, d, t_max, on, with_stats=True, **kw)
        _hold_stats(f"[twins] {label} counters", st, plain(
            rows, o, d, t_max, on, with_stats=True, **kw))
    occ = kt.anyhit(rows, o, d, t_occ, on, **kw)
    _hold_occluded("[twins] trace_anyhit", occ, kt.anyhit_plain(
        rows, o, d, t_occ, on, **kw))
    # Where each prim's leaf hangs: (node row, slot).
    entry = table[:, 6 * kt.ARITY:7 * kt.ARITY].view(np.int32)
    node, slot = np.nonzero((entry < 0) & (entry != kt.INVALID_ENTRY))
    first = (-(entry[node, slot] + 1)) >> 4
    prim_of = table[first, 9].view(np.int32)
    where = {int(p): (int(n), int(s)) for p, n, s in zip(prim_of, node, slot)}
    won = got[1][got[1] >= 0].cpu().numpy()
    shared = lower = 0
    for p in won:
        (n_p, s_p), (n_q, s_q) = where[int(p)], where[int(p) ^ 1]
        if n_p == n_q:
            shared += 1
            lower += s_p < s_q
    if lower != shared:
        raise AssertionError(f"[twins] {shared - lower} ties went to the "
                             f"higher slot")
    print(f"[twins] {table.shape[0]} rows, {ties} children tied with a "
          f"sibling's box, {o.shape[0]} rays: {len(won)} closest hits, "
          f"{shared} on twins of one node, each won by the lower slot; "
          f"closest and any-hit (with and without counters) bitwise equal "
          f"to the plain versions; occluded {float(occ.float().mean()):.3f}")


def _print_bounds(name, entries):
    for k, (_, ms, _, b_ms, by) in entries.items():
        print(f"[{name}] {k} bound {b_ms:.4f} ms ({by}), kernel at "
              f"{b_ms / ms:.1%} of it")


def _hold_hits(label, got, want) -> float:
    """Closest-hit results (t, prim, u, v) bitwise equal; returns the max
    |diff| of t, u, v over the hits."""
    import torch

    torch.cuda.synchronize()
    for field, a, b in zip("t prim u v".split(), got, want):
        if not torch.equal(_bits(a), _bits(b)):
            bad = int((_bits(a) != _bits(b)).sum())
            raise AssertionError(f"{label} {field} differs from the plain "
                                 f"version in {bad} lanes")
    hit = want[1] >= 0
    return max(float((a - b)[hit].abs().max()) if hit.any() else 0.0
               for a, b in zip((got[0], got[2], got[3]),
                               (want[0], want[2], want[3])))


def _hold_occluded(label, occ, want) -> float:
    import torch

    torch.cuda.synchronize()
    if not torch.equal(occ, want):
        raise AssertionError(f"{label} differs from the plain version in "
                             f"{int((occ != want).sum())} lanes")
    return float((occ.float() - want.float()).abs().max())


def _hold_to_b1(label, got, b1) -> int:
    """A schedule's closest hits against the plain schedule's kernel output
    on the same rays: t bitwise equal in every lane, and u, v wherever the
    same triangle won. Returns the lanes where another triangle won at
    bitwise the same t (the visit order decides such ties)."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(_bits(got[0]), _bits(b1[0])):
        bad = int((_bits(got[0]) != _bits(b1[0])).sum())
        raise AssertionError(f"{label} t differs from trace_closest's in "
                             f"{bad} lanes")
    same = got[1] == b1[1]
    for field, a, b in (("u", got[2], b1[2]), ("v", got[3], b1[3])):
        if not torch.equal(_bits(a)[same], _bits(b)[same]):
            raise AssertionError(f"{label} {field} differs from "
                                 f"trace_closest's on the same triangle")
    return int((~same).sum())


def compare_schedules(name: str, scene, meta, rays, b1, device, results):
    """Phase 3b, the tree walks: the interleave and multi-pop schedules and
    the sub-packet kernel on phase 3's table and rays."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops import subpacket_traverse as sp

    o, d, t_occ, on = rays
    n = o.shape[0]
    far = torch.full((n,), 1e20, device=device)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    rows = scene.node_rows
    b1_ms = results[name]["trace_closest"][1], results[name]["trace_anyhit"][1]
    # A schedule's bound is the per-ray walk's on the same rays.
    b1_bound = (results[name]["trace_closest"][3:5],
                results[name]["trace_anyhit"][3:5])
    out = {}
    for tag, suffix, sched in (("W=2", "ilv", dict(interleave=2)),
                               ("W=4", "ilv_w4", dict(interleave=4)),
                               ("Q=2", "multi", dict(multi_pop=2))):
        # The multi-pop overflow latch is held to 0 with the counters
        # (compare_stats).
        label = f"[{name}] trace_closest_{suffix}"
        pops_c = {}
        got = kt.closest(rows, o, d, far, on, **sched, **kw)
        want = kt.closest_plain(rows, o, d, far, on, pops=pops_c, **sched,
                                **kw)
        err_c = _hold_hits(label, got, want)
        ties = _hold_to_b1(label, got, b1["closest"])
        occ = kt.anyhit(rows, o, d, t_occ, on, **sched, **kw)
        occ_want = kt.anyhit_plain(rows, o, d, t_occ, on, **sched, **kw)
        err_a = _hold_occluded(f"[{name}] trace_anyhit_{suffix}", occ,
                               occ_want)
        if not torch.equal(occ, b1["occ"]):
            raise AssertionError(f"[{name}] trace_anyhit_{suffix} differs "
                                 f"from trace_anyhit")
        ms_c = _events_ms(lambda: kt.closest(rows, o, d, far, on, **sched,
                                             **kw), 10)
        ms_a = _events_ms(lambda: kt.anyhit(rows, o, d, t_occ, on, **sched,
                                            **kw), 10)
        plain_c = _events_ms(lambda: kt.closest_plain(
            rows, o, d, far, on, **sched, **kw), 1)
        plain_a = _events_ms(lambda: kt.anyhit_plain(
            rows, o, d, t_occ, on, **sched, **kw), 1)
        print(f"[{name}] {tag}: bitwise equal to the plain version; t and "
              f"occluded bitwise equal to trace_closest / trace_anyhit, "
              f"{ties} tie lanes of {n} (another triangle at the same t); "
              f"node pops per ray {pops_c.get('node', 0) / n:.2f}")
        print(f"[{name}] {tag}: closest {ms_c:.3f} ms (trace_closest "
              f"{b1_ms[0]:.3f}), plain {plain_c:.1f} ms; any-hit {ms_a:.3f} "
              f"ms (trace_anyhit {b1_ms[1]:.3f}), plain {plain_a:.1f} ms")
        out[f"trace_closest_{suffix}"] = (err_c, ms_c, plain_c, *b1_bound[0])
        out[f"trace_anyhit_{suffix}"] = (err_a, ms_a, plain_a, *b1_bound[1])
    ilv_edges(name, rows, rays, meta)
    multi_edges(name, rows, rays, meta, b1)

    # The sub-packet kernel on K-ray packets of the same rays, at every K of
    # SUBPACKET_KS (the kernels line reports K = SUBPACKET_K).
    for K in SUBPACKET_KS:
        P = n // K

        def packets(t_max):
            return (rows, o.reshape(P, K, 3), d.reshape(P, K, 3),
                    t_max.reshape(P, K), on.reshape(P, K))

        for any_hit, t_max, entry in ((False, far, "subpacket_closest"),
                                      (True, t_occ, "subpacket_anyhit")):
            label = f"[{name}] {entry} K={K}"
            args = packets(t_max)
            flags = dict(any_hit=any_hit, with_stats=True, **kw)
            got = sp.traverse_subpacket(*args, **flags)
            pops = {}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = sp.traverse_subpacket_plain(*args, pops=pops, **flags)
            end.record()
            err = _hold_hits(label, got[:4], want[:4])
            plain_ms = start.elapsed_time(end)
            if not torch.equal(got[4], want[4]):
                raise AssertionError(f"{label} pop counts differ from the "
                                     f"plain version's")
            flat = [x.reshape(-1) for x in got[:4]]
            if any_hit:
                ties = None
                if not torch.equal(flat[1] >= 0, b1["occ"]):
                    raise AssertionError(f"{label} differs from trace_anyhit")
            else:
                ties = _hold_to_b1(label, flat, b1["closest"])
                # The unordered push schedule: held, pop counts too; not
                # timed.
                for a, b in zip(
                        sp.traverse_subpacket(*args, ordered=False, **flags),
                        sp.traverse_subpacket_plain(*args, ordered=False,
                                                    **flags)):
                    if not torch.equal(_bits(a), _bits(b)):
                        raise AssertionError(f"{label} ordered=False differs "
                                             f"from the plain version")
            ms = _events_ms(lambda: sp.traverse_subpacket(
                *args, any_hit=any_hit, **kw), 5)
            node, leaf = (int(x) for x in got[4].sum(dim=0))
            print(f"{label}: bitwise equal to the plain version (pop counts "
                  f"too"
                  + ("" if any_hit else ", and ordered=False")
                  + "); "
                  + (f"t bitwise equal to trace_closest, {ties} tie lanes of "
                     f"{n}" if ties is not None
                     else "occluded equal to trace_anyhit")
                  + f"; {node / (n // 128):.1f} node and "
                  f"{leaf / (n // 128):.1f} leaf pops per sub-packet, "
                  f"{pops['trig']} leaf phases chosen by LEAF_TRIG alone; "
                  f"{ms:.4f} ms ({b1_ms[any_hit]:.3f} per ray), plain "
                  f"{plain_ms:.1f} ms (with pop counting); the schedule's "
                  f"own work: {pops['slabs']} slab tests of 8 children (a "
                  f"node pop times the sub-packet's rays still walking), "
                  f"{1e3 * pops['slabs'] * NODE_OPS / PEAK_FLOPS:.4f} ms at "
                  f"the card's peak, not its bound")
            if K == SUBPACKET_K:
                out[entry] = (err, ms, plain_ms, *b1_bound[any_hit])
    subpacket_at_scale(name, scene, meta, device)
    results[name].update(out)
    _print_bounds(name, out)


def ilv_edges(name, rows, rays, meta) -> None:
    """Phase 3b, the interleave's edges: W = 2 and 4 at stack depth 192
    (its largest shared stacks: 64 threads a block at W = 4) and with
    every ray inactive (each slot retires at once and takes the next ray),
    closest and any-hit with counters, every field and count bitwise B1's
    at the same depth and mask (B1 at 192 is held to the plain version in
    phase 3); each timed at 192."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    o, d, t_occ, on = rays
    far = torch.full((o.shape[0],), 1e20, device=o.device)
    line = []
    for depth, act, tag in ((192, on, "depth 192"),
                            (meta.stack_depth, torch.zeros_like(on),
                             "every ray inactive")):
        kd = dict(stack_depth=depth, leaf_size=meta.leaf_size)
        for fn, t_max, label in ((kt.closest, far, "closest"),
                                 (kt.anyhit, t_occ, "any-hit")):
            want = fn(rows, o, d, t_max, act, with_stats=True, **kd)
            if not act.any() and int(want[-1].sum()):
                raise AssertionError(f"[{name}] B1 counted pops of inactive "
                                     f"rays")
            for w in kt.VARIANTS:
                _hold_stats(f"[{name}] {label} W={w} {tag}", fn(
                    rows, o, d, t_max, act, with_stats=True, interleave=w,
                    **kd), want)
                if depth == 192:
                    ms = _events_ms(lambda: fn(rows, o, d, t_max, act,
                                               interleave=w, **kd), 5)
                    line.append(f"{label} W={w} {ms:.4f} ms")
    print(f"[{name}] W = 2 and 4 at stack depth 192 and with every ray "
          f"inactive: hits and pop counts bitwise B1's; at 192 "
          + ", ".join(line))


# Phase 3b's multi-pop edges: (Q, stack bound) at the largest stack
# (stack_depth * Q = 192) and at a bound that drops pushes on both scenes.
MULTI_EDGES = ((4, 48), (2, 4))


def multi_edges(name, rows, rays, meta, b1) -> None:
    """Phase 3b, the multi-pop schedule's edges (MULTI_EDGES): closest and
    any-hit with counters, every field and the [N, 3] counts bitwise the
    plain version's; t and occluded bitwise B1's (phase 3's kernel output)
    in every lane whose walk dropped no push, and the dropping bound must
    drop some; each timed."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    o, d, t_occ, on = rays
    far = torch.full((o.shape[0],), 1e20, device=o.device)
    line = []
    for q, depth in MULTI_EDGES:
        kd = dict(stack_depth=depth, leaf_size=meta.leaf_size, multi_pop=q)
        for fn, plain, t_max, label in (
                (kt.closest, kt.closest_plain, far, "closest"),
                (kt.anyhit, kt.anyhit_plain, t_occ, "any-hit")):
            tag = f"[{name}] {label} Q={q} at stack bound {depth}"
            got = fn(rows, o, d, t_max, on, with_stats=True, **kd)
            _hold_stats(tag, got, plain(rows, o, d, t_max, on,
                                        with_stats=True, **kd))
            kept = got[-1][:, 2] == 0
            mine, ref = ((got[0], b1["occ"]) if label == "any-hit"
                         else (got[0], b1["closest"][0]))
            if not torch.equal(_bits(mine)[kept], _bits(ref)[kept]):
                raise AssertionError(f"{tag}: differs from B1 where no push "
                                     f"was dropped")
            dropped = int((~kept).sum())
            if (depth * q < kt.MAX_STACK) != (dropped > 0):
                raise AssertionError(f"{tag}: {dropped} rays dropped pushes")
            ms = _events_ms(lambda: fn(rows, o, d, t_max, on, **kd), 5)
            line.append(f"{label} Q={q} bound {depth}: {ms:.4f} ms, "
                        f"{dropped} rays dropped pushes")
    print(f"[{name}] multi-pop edges with counters, bitwise the plain "
          f"version's, t and occluded B1's where no push was dropped: "
          + "; ".join(line))


def subpacket_at_scale(name: str, scene, meta, device) -> None:
    """Phase 3b at the kernel A/B tool's scale: the sub-packet kernel on its
    2^19 incoherent rays (all active, t_max 1e20) at every K of
    SUBPACKET_KS, t and occluded bitwise the per-ray kernel's; times beside
    the per-ray kernel's."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops import subpacket_traverse as sp

    n = SUBPACKET_SCALE_RAYS
    o, d = _tool_module("torch_kernel_bench").make_rays(
        f"proc:{name}", scene, meta, n, device)["incoherent"]
    far = torch.full((n,), 1e20, device=device)
    on = torch.ones(n, dtype=torch.bool, device=device)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    rows = scene.node_rows
    fns = (kt.closest, kt.anyhit)
    b1 = [fn(rows, o, d, far, on, **kw) for fn in fns]
    b1_ms = [_events_ms(lambda: fn(rows, o, d, far, on, **kw), 5)
             for fn in fns]
    line = []
    for K in SUBPACKET_KS:
        args = (rows, o.reshape(n // K, K, 3), d.reshape(n // K, K, 3),
                far.reshape(n // K, K), on.reshape(n // K, K))
        for any_hit in (False, True):
            got = sp.traverse_subpacket(*args, any_hit=any_hit, **kw)
            torch.cuda.synchronize()
            same = (torch.equal(got[1].reshape(-1) >= 0, b1[1]) if any_hit
                    else torch.equal(_bits(got[0].reshape(-1)),
                                     _bits(b1[0][0])))
            if not same:
                raise AssertionError(f"[{name}] subpacket K={K} on {n} rays "
                                     f"differs from the per-ray kernel")
            ms = _events_ms(lambda: sp.traverse_subpacket(
                *args, any_hit=any_hit, **kw), 5)
            line.append(f"K={K} {'any-hit' if any_hit else 'closest'} "
                        f"{ms:.4f}")
    print(f"[{name}] subpacket on the kernel A/B tool's {n} incoherent rays: "
          + ", ".join(line) + f" ms (trace_closest {b1_ms[0]:.4f}, "
          f"trace_anyhit {b1_ms[1]:.4f}); t and occluded bitwise the "
          f"per-ray kernel's")


def _hold_stats(label, got, want) -> None:
    """Pop counters (and the results beside them) bitwise equal."""
    import torch

    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(_bits(a), _bits(b)):
            bad = int((_bits(a) != _bits(b)).reshape(a.shape[0], -1)
                      .any(1).sum())
            raise AssertionError(f"{label} output {k} differs from the plain "
                                 f"version's in {bad} rays")


def compare_stats(name: str, scene, meta, rays, b1, device, results):
    """Phase S on the MT-leaf table: the pop counters of every schedule,
    closest and any-hit, against the plain version's, ray by ray; the hits
    with counters bitwise those without; the interleave's counts B1's.
    Records B1's pops for the pop account."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    o, d, t_occ, on = rays
    far = torch.full((o.shape[0],), 1e20, device=device)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    rows = scene.node_rows
    counts = {}
    for tag, sched in (("B1", {}), ("W=2", dict(interleave=2)),
                       ("W=4", dict(interleave=4)),
                       ("Q=2", dict(multi_pop=2))):
        for any_hit, t_max in ((False, far), (True, t_occ)):
            fn, plain = ((kt.anyhit, kt.anyhit_plain) if any_hit
                         else (kt.closest, kt.closest_plain))
            label = f"[{name}] {tag} {'any-hit' if any_hit else 'closest'}"
            got = fn(rows, o, d, t_max, on, with_stats=True, **sched, **kw)
            got = got if isinstance(got, tuple) else (got,)
            _hold_stats(label, got, plain(rows, o, d, t_max, on,
                                          with_stats=True, **sched, **kw))
            bare = fn(rows, o, d, t_max, on, **sched, **kw)
            _hold_stats(f"{label} (hits without counters)", got[:-1],
                        bare if isinstance(bare, tuple) else (bare,))
            counts[tag, any_hit] = got[-1]
    for any_hit in (False, True):
        for tag in ("W=2", "W=4"):
            if not torch.equal(counts[tag, any_hit], counts["B1", any_hit]):
                raise AssertionError(f"[{name}] {tag} pop counts differ from "
                                     f"B1's")
        if int(counts["Q=2", any_hit][:, 2].sum()):
            raise AssertionError(f"[{name}] Q=2 dropped pushes")
    n = o.shape[0]
    line = []
    for (tag, any_hit), st in counts.items():
        if tag in ("B1", "Q=2"):
            node, leaf = (int(x) for x in st[:, :2].sum(dim=0))
            line.append(f"{tag} {'any-hit' if any_hit else 'closest'} "
                        f"{node / n:.2f} node + {leaf / n:.2f} leaf")
    print(f"[{name}] pop counters of B1, W = 2, 4 and Q = 2, closest and "
          f"any-hit: every ray bitwise equal to the plain version, hits "
          f"bitwise those without counters, W's counts B1's; pops per ray: "
          + "; ".join(line))
    results[name + "_counts"] = {
        q: [int(x) for x in counts["B1", q].sum(dim=0)] for q in (False, True)}
    pops = results[name + "_pops"]
    for any_hit in (False, True):
        node, leaf = results[name + "_counts"][any_hit]
        entry = "trace_anyhit" if any_hit else "trace_closest"
        scale = pops[any_hit].get("slots", 0) / max(leaf, 1) / 10
        pop_account(f"B1 {name} {entry} (leaf pops at the slots they test)",
                    results[name][entry][1], node, leaf, results["rates"],
                    "leaf_pop_ray_ps", scale)
        # B7 and B8 on their own counts, a leaf pop at B1's slots a pop.
        for kernel, tag, suffix in (("B7", "W=2", "_ilv"),
                                    ("B8", "Q=2", "_multi")):
            node, leaf = (int(x) for x in counts[tag, any_hit][:, :2].sum(0))
            pop_account(f"{kernel} {name} {entry}{suffix} (leaf pops at "
                        f"B1's slots a leaf pop)",
                        results[name][entry + suffix][1], node, leaf,
                        results["rates"], "leaf_pop_ray_ps", scale)


def pop_account(label, ms, node, leaf, rates, leaf_key, leaf_scale=1.0):
    """Prints a walk's ns per pop against the probes' floors: its node pops
    at the node body's time a ray-pop and its leaf pops at the leaf body's
    (scaled by ``leaf_scale``, the tested slots over the probe's ten), all
    at the card's throughput. Returns the floor's share of the time."""
    pops = node + leaf
    floor_ms = (node * rates["node_pop_ray_ps"]
                + leaf * rates[leaf_key] * leaf_scale) * 1e-9
    print(f"[pop account] {label}: {ms:.3f} ms over {pops} pops ({node} node,"
          f" {leaf} leaf) = {ms * 1e6 / max(pops, 1):.4f} ns a pop; the "
          f"probes' floors (node body {rates['node_pop_ray_ps']:.3f} ps, "
          f"leaf body {rates[leaf_key] * leaf_scale:.3f} ps a ray-pop) give "
          f"{floor_ms:.4f} ms, {floor_ms / ms:.1%} of the time; the rest is "
          f"latency, divergence and stack traffic")
    return floor_ms / ms


def compare_dense(name: str, scene, rays, b1, device, results,
                  n_rays=None) -> None:
    """Phase 3b, the dense intersection: both roundings against the plain
    version on the first ``n_rays`` of phase 3's rays (all when None)."""
    import torch

    from gpupathtracer_tpu_torch.ops import dense_intersect as pd

    n = n_rays or rays[0].shape[0]
    o, d, t_occ, on = (x[:n].contiguous() for x in rays)
    far = torch.full((n,), 1e20, device=device)
    wd, wo = (torch.as_tensor(x, device=device)
              for x in pd.pack_dense_tris(scene.tri_geom.cpu().numpy()))
    tp = wd.shape[1] // 3
    cut = (f"{n} of {rays[0].shape[0]} rays (the plain version's cost sets "
           f"the cut)" if n_rays else f"{n} rays")
    out = {}
    for any_hit, t_max, entry in ((False, far, "dense_closest"),
                                  (True, t_occ, "dense_anyhit")):
        for use_mxu in (True, False):
            label = f"[{name}] {entry} use_mxu={use_mxu}"
            kw = dict(any_hit=any_hit, use_mxu=use_mxu)
            got = pd.dense_intersect(wd, wo, o, d, t_max, on, **kw)
            counts = {}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = pd.dense_intersect_plain(wd, wo, o, d, t_max, on,
                                            counts=counts, **kw)
            end.record()
            err = _hold_hits(label, got, want)
            plain_ms = start.elapsed_time(end)
            ms = _events_ms(lambda: pd.dense_intersect(
                wd, wo, o, d, t_max, on, **kw), 5)
            t_ops = counts["pairs"] * DENSE_PAIR_OPS / PEAK_FLOPS
            t_bytes = ((wd.numel() + wo.numel()) * 4 + n * 45) / PEAK_BYTES
            b_ms, by = (1e3 * max(t_ops, t_bytes),
                        "operations" if t_ops >= t_bytes else "bytes")
            print(f"{label}: {cut} x {tp} padded triangles, "
                  f"{counts['pairs']:.3g} pairs; bitwise equal to the plain "
                  f"version; {ms:.3f} ms, plain {plain_ms:.1f} ms; bound "
                  f"{b_ms:.4f} ms ({by}), kernel at {b_ms / ms:.1%} of it")
            if use_mxu:
                out[entry] = (err, ms, plain_ms, b_ms, by)
        if any_hit:
            late = pd.dense_intersect(wd, wo, o, d, t_max, on, any_hit=True,
                                      early_exit=False)
            _hold_hits(f"[{name}] {entry} early_exit=False", late, got)
            if not torch.equal(got[1] >= 0, b1["occ"][:n]):
                flips = int(((got[1] >= 0) != b1["occ"][:n]).sum())
                print(f"[{name}] {entry}: {flips} of {n} lanes occluded "
                      f"otherwise than trace_anyhit (the inverse-matrix "
                      f"test rounds otherwise than Moller-Trumbore)")
        else:
            other = int((got[1] != b1["closest"][1][:n]).sum())
            hit = got[1] >= 0
            rel = ((got[0] - b1["closest"][0][:n]).abs()
                   / b1["closest"][0][:n].abs())[hit & (got[1] ==
                                                        b1["closest"][1][:n])]
            print(f"[{name}] {entry}: {other} of {n} lanes hit another "
                  f"triangle than trace_closest, t within "
                  f"{float(rel.max()):.2g} relative on the others (other "
                  f"rounding; not a bitwise check)")
    results[name + "_dense"] = out


# Phase A: the table arities the card runs besides 8 (tests/test_torch_arity.py
# holds 2, 4 and 16 to the JAX kernels on the CPU), and phase T's packets of
# rays a start entry serves.
CARD_ARITIES = (16, 4)
ROOTS_PACKET = 2048
ROOTS_KEYS = ("trace_closest_roots", "trace_anyhit_roots",
              "trace_cluster_closest_roots", "trace_cluster_anyhit_roots")
# Phase T's films against the default film: the ray counts within this
# share, at most PIXEL_SHARE of pixels outside rtol = atol = FILM_TOL.
RAY_SHARE, PIXEL_SHARE, FILM_TOL = 1e-5, 1e-4, 2e-3


def _timed(fn):
    """(fn(), its milliseconds by CUDA events): one run, for the plain
    versions, whose check run is also their timing."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _limit(label: str, count: int, total: int, share: float) -> None:
    """Raises if count lanes of total exceed the share."""
    if count > share * total:
        raise AssertionError(f"{label}: {count} of {total} lanes, more than "
                             f"{share:g} of them")


def _order_diff(label, got, ref, geom, o, d) -> int:
    """Closest hits of two walks of the same rays in another visit order
    (another arity, treelet bins): t bitwise, prim but where another
    triangle won at bitwise the same t; such a prim must hit its ray at
    that t (recomputed with ops/intersect.py mt_intersect). Returns the
    count of those lanes."""
    import torch

    from gpupathtracer_tpu_torch.ops.intersect import mt_intersect

    torch.cuda.synchronize()
    t_diff = _bits(got[0]) != _bits(ref[0])
    for i in t_diff.nonzero().squeeze(1)[:8].tolist():
        print(f"{label}: lane {i} t {float(got[0][i])!r} (prim "
              f"{int(got[1][i])}) against {float(ref[0][i])!r} (prim "
              f"{int(ref[1][i])})")
    if t_diff.any():
        raise AssertionError(f"{label}: t differs in {int(t_diff.sum())} "
                             f"lanes")
    tie = got[1] != ref[1]
    lanes = tie.nonzero().squeeze(1)
    if lanes.numel():
        tt, _, _, ok = mt_intersect(geom[got[1][lanes].long()], o[lanes],
                                    d[lanes])
        if not bool(ok.all()) or not torch.equal(_bits(tt),
                                                 _bits(got[0][lanes])):
            raise AssertionError(f"{label}: a prim that differs at equal t "
                                 f"does not hit its ray at that t")
    return int(tie.sum())


def _same_occluded(label, occ, ref) -> None:
    """Occlusion of two walks of the same rays, held exactly."""
    n = int((occ != ref).sum())
    if n:
        raise AssertionError(f"{label}: occluded differs in {n} lanes")


def compare_arity(name: str, width: int, height: int, rays, b1, scene8,
                  meta8, cluster8, device, results) -> None:
    """Phase A on one scene: its MT table and its cluster table (tc 128) at
    each of CARD_ARITIES, phase 3's rays. B1 closest and any-hit, B7 (W =
    2), B8 (Q = 2) and B4 bitwise their plain versions; B1's and B4's
    closest hits and B1's occlusion against arity 8's kernels
    (_order_diff); each kernel timed beside its arity-8 build on the same
    rays, with its bound. ``cluster8`` is the scene's cluster table at
    arity 8 (phase 4's)."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.scene import load_scene

    o, d, t_occ, on = rays
    n = o.shape[0]
    far = torch.full((n,), 1e20, device=device)
    kw8 = dict(stack_depth=meta8.stack_depth, leaf_size=meta8.leaf_size)
    for arity in CARD_ARITIES:
        t0 = time.perf_counter()
        scene, meta = load_scene(_scene_cfg(name, width, height,
                                            wide_arity=arity), device)
        rows = scene.node_rows
        tag = f"[{name} A={arity}]"
        print(f"{tag} ingest {time.perf_counter() - t0:.2f} s: "
              f"{rows.shape[0]} rows ({rows.numel() * 4 / 1e6:.1f} MB; arity "
              f"8 {scene8.node_rows.shape[0]}), stack depth "
              f"{meta.stack_depth} (8: {meta8.stack_depth})")
        kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
                  arity=arity)
        entries, pops_b1 = {}, None
        for sname, sched in (("", {}), ("_ilv", dict(interleave=2)),
                             ("_multi", dict(multi_pop=2))):
            pops_c, pops_a = {}, {}
            got = kt.closest(rows, o, d, far, on, **sched, **kw)
            want, plain_c = _timed(lambda: kt.closest_plain(
                rows, o, d, far, on, pops=pops_c, **sched, **kw))
            err_c = _hold_hits(f"{tag} trace_closest{sname}", got, want)
            occ = kt.anyhit(rows, o, d, t_occ, on, **sched, **kw)
            occ_want, plain_a = _timed(lambda: kt.anyhit_plain(
                rows, o, d, t_occ, on, pops=pops_a, **sched, **kw))
            err_a = _hold_occluded(f"{tag} trace_anyhit{sname}", occ,
                                   occ_want)
            if not sched:
                pops_b1 = (pops_c, pops_a)
                ties = _order_diff(f"{tag} trace_closest against arity 8's",
                                   got, b1["closest"], scene.tri_geom, o, d)
                _same_occluded(f"{tag} trace_anyhit against arity 8's", occ,
                               b1["occ"])
                print(f"{tag} B1 against arity 8's kernel: t and occluded "
                      f"bitwise equal, another triangle at bitwise the "
                      f"same t in {ties} lanes")
            times = []
            for rw, k in ((scene8.node_rows, kw8), (rows, kw),
                          (rows, kw), (scene8.node_rows, kw8)):
                times.append((_events_ms(lambda: kt.closest(
                    rw, o, d, far, on, **sched, **k), 10), _events_ms(
                    lambda: kt.anyhit(rw, o, d, t_occ, on, **sched, **k),
                    10)))
            ms = [sum(x[q] for x in times[1:3]) / 2 for q in (0, 1)]
            ms8 = [(times[0][q] + times[3][q]) / 2 for q in (0, 1)]
            for q, (query, err, plain, io) in enumerate((
                    ("closest", err_c, plain_c, 45),
                    ("anyhit", err_a, plain_a, 30))):
                key = kt.launch_key(f"trace_{query}{sname}", arity, None)
                entries[key] = (err, ms[q], plain, *bound(
                    pops_b1[q], leaf_bytes=mt_leaf_bytes,
                    slot_ops=MT_SLOT_OPS, io_bytes=n * io, arity=arity))
                print(f"{tag} {key} {ms[q]:.4f} ms (runs "
                      f"{times[1][q]:.4f}, {times[2][q]:.4f}; arity 8 "
                      f"{ms8[q]:.4f}: {times[0][q]:.4f}, {times[3][q]:.4f}), "
                      f"plain {plain:.1f} ms, bitwise the plain version")
        t0 = time.perf_counter()
        cscene, cmeta = load_scene(_scene_cfg(
            name, width, height, wide_arity=arity, cluster_tris=128), device)
        tabs = (cscene.node_rows, cscene.cluster_rows)
        refs = cscene.cluster_refs
        ck = dict(stack_depth=cmeta.stack_depth, arity=arity)
        tabs8 = (cluster8[0].node_rows, cluster8[0].cluster_rows)
        refs8 = cluster8[0].cluster_refs
        ck8 = dict(stack_depth=cluster8[1].stack_depth)
        pops_c, pops_a = {}, {}
        got = kc.closest_cluster(*tabs, refs, o, d, far, on, **ck)
        want, plain_c = _timed(lambda: kc.closest_cluster_plain(
            *tabs, refs, o, d, far, on, pops=pops_c, **ck))
        err_c = _hold_hits(f"{tag} trace_cluster_closest", got, want)
        occ = kc.anyhit_cluster(*tabs, o, d, t_occ, on, **ck)
        occ_want, plain_a = _timed(lambda: kc.anyhit_cluster_plain(
            *tabs, o, d, t_occ, on, pops=pops_a, **ck))
        err_a = _hold_occluded(f"{tag} trace_cluster_anyhit", occ, occ_want)
        ties = _order_diff(f"{tag} trace_cluster_closest against arity 8's",
                           got, kc.closest_cluster(*tabs8, refs8, o, d, far,
                                                   on, **ck8),
                           cscene.tri_geom, o, d)
        _same_occluded(f"{tag} trace_cluster_anyhit against arity 8's", occ,
                       kc.anyhit_cluster(*tabs8, o, d, t_occ, on, **ck8))
        print(f"{tag} B4: ingest {time.perf_counter() - t0:.2f} s, top tree "
              f"{tabs[0].shape[0]} rows (arity 8 {tabs8[0].shape[0]}); t "
              f"and occluded bitwise arity 8's, another triangle at bitwise "
              f"the same t in {ties} lanes")
        times = []
        for tb, k, rf in ((tabs8, ck8, refs8), (tabs, ck, refs),
                          (tabs, ck, refs), (tabs8, ck8, refs8)):
            times.append((_events_ms(lambda: kc.closest_cluster(
                *tb, rf, o, d, far, on, **k), 10), _events_ms(
                lambda: kc.anyhit_cluster(*tb, o, d, t_occ, on, **k), 10)))
        for q, (query, err, plain, io, pops) in enumerate((
                ("closest", err_c, plain_c, 45, pops_c),
                ("anyhit", err_a, plain_a, 30, pops_a))):
            key = kt.launch_key(f"trace_cluster_{query}", arity, None)
            ms = (times[1][q] + times[2][q]) / 2
            entries[key] = (err, ms, plain, *bound(
                pops, leaf_bytes=leaf_bytes_of(128),
                slot_ops=CLUSTER_SLOT_OPS, io_bytes=n * io, arity=arity))
            print(f"{tag} {key} {ms:.4f} ms (runs {times[1][q]:.4f}, "
                  f"{times[2][q]:.4f}; arity 8 {times[0][q]:.4f}, "
                  f"{times[3][q]:.4f}), plain {plain:.1f} ms, bitwise the "
                  f"plain version")
        results[f"{name}_a{arity}"] = entries
        _print_bounds(f"{name} A={arity}", entries)


def _cut_roots(cut_entry, n: int, leaf_entry: int):
    """Start entries for n rays in packets of ROOTS_PACKET: the cut's roots
    in turn, ``leaf_entry`` in packet 1 and INVALID in packet 2."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    packets = -(-n // ROOTS_PACKET)
    idx = torch.arange(packets, device=cut_entry.device) % cut_entry.shape[0]
    roots = cut_entry.to(torch.int32)[idx].clone()
    roots[1] = leaf_entry
    roots[2] = kt.INVALID_ENTRY
    return roots.contiguous()


def _a_leaf(rows, arity: int) -> int:
    """A leaf entry of a table: the first child entry that is one."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    e = rows[:, 6 * arity:7 * arity].contiguous().view(torch.int32)
    return int(e[(e < 0) & (e != kt.INVALID_ENTRY)][0])


def compare_roots(scene, meta, cscene, cmeta, rays, device, results):
    """Phase T, the start entries: B1 closest and any-hit on sponza's MT
    table and B4's two on its cluster table, ray i from roots[i // 2048]:
    the table's treelet-cut roots in turn, a leaf entry in packet 1 and
    INVALID in packet 2, each bitwise its plain version (the INVALID
    packet: t_max, no hit, not occluded), timed with its bound."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    o, d, t_occ, on = rays
    n = o.shape[0]
    far = torch.full((n,), 1e20, device=device)
    dead = slice(2 * ROOTS_PACKET, 3 * ROOTS_PACKET)
    entries = {}
    for table, sc, mt in (("MT", scene, meta), ("cluster", cscene, cmeta)):
        roots = _cut_roots(sc.cut_entry, n, _a_leaf(sc.node_rows, sc.arity))
        rk = dict(stack_depth=mt.stack_depth, roots=roots,
                  packet=ROOTS_PACKET)
        pops_c, pops_a = {}, {}
        if table == "MT":
            rk["leaf_size"] = mt.leaf_size
            cl, an = kt.closest, kt.anyhit
            clp, anp = kt.closest_plain, kt.anyhit_plain
            tabs, ctabs, prefix = (sc.node_rows,), (sc.node_rows,), "trace"
            leaf, slot_ops = mt_leaf_bytes, MT_SLOT_OPS
        else:
            cl, an = kc.closest_cluster, kc.anyhit_cluster
            clp, anp = kc.closest_cluster_plain, kc.anyhit_cluster_plain
            tabs = (sc.node_rows, sc.cluster_rows, sc.cluster_refs)
            ctabs = tabs[:2]
            prefix = "trace_cluster"
            leaf, slot_ops = leaf_bytes_of(128), CLUSTER_SLOT_OPS
        got = cl(*tabs, o, d, far, on, **rk)
        want, plain_c = _timed(lambda: clp(*tabs, o, d, far, on,
                                           pops=pops_c, **rk))
        err_c = _hold_hits(f"[sponza {table} roots] {prefix}_closest", got,
                           want)
        occ = an(*ctabs, o, d, t_occ, on, **rk)
        occ_want, plain_a = _timed(lambda: anp(*ctabs, o, d, t_occ, on,
                                               pops=pops_a, **rk))
        err_a = _hold_occluded(f"[sponza {table} roots] {prefix}_anyhit",
                               occ, occ_want)
        if not (torch.equal(got[0][dead], far[dead])
                and bool((got[1][dead] < 0).all()) and not occ[dead].any()):
            raise AssertionError(f"[sponza {table} roots] the INVALID packet "
                                 f"walked")
        ms_c = _events_ms(lambda: cl(*tabs, o, d, far, on, **rk), 10)
        ms_a = _events_ms(lambda: an(*ctabs, o, d, t_occ, on, **rk), 10)
        for query, err, ms, plain, pops, io in (
                ("closest", err_c, ms_c, plain_c, pops_c, 45),
                ("anyhit", err_a, ms_a, plain_a, pops_a, 30)):
            key = f"{prefix}_{query}_roots"
            entries[key] = (err, ms, plain, *bound(
                pops, leaf_bytes=leaf, slot_ops=slot_ops,
                io_bytes=n * io + 4 * roots.numel()))
            print(f"[sponza {table} roots] {key} {ms:.4f} ms, plain "
                  f"{plain:.1f} ms: {roots.numel()} start entries (cut "
                  f"roots, leaf {int(roots[1])}, INVALID), bitwise the "
                  f"plain version; hit rate "
                  f"{float((want[1] >= 0).float().mean()):.3f}")
    results["sponza_roots"] = entries
    _print_bounds("sponza roots", entries)


def compare_treelet(scene, meta, rays, b1, device) -> dict:
    """Phase T, the treelet traversal on phase 3's sponza rays:
    trace_closest_treelet and trace_occluded_treelet called once each, a
    driven path of their own; their hits against B1's whole-tree hits there
    (t and occlusion bitwise, prim but at true ties); then a timed run, its
    rounds and host time beside B1's kernel time. Returns the path's
    launches."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops import treelet

    o, d, t_occ, on = rays
    n = o.shape[0]
    far = torch.full((n,), 1e20, device=device)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              packet_size=ROOTS_PACKET)
    out = {}
    counts = _drive("treelet queries", ("trace_closest_roots",
                                        "trace_anyhit_roots"),
                    lambda: out.update(
                        hit=treelet.trace_closest_treelet(scene, o, d, far,
                                                          on, **kw),
                        occ=treelet.trace_occluded_treelet(scene, o, d,
                                                           t_occ, on, **kw)))
    ties = _order_diff("[sponza treelet] closest against B1's", out["hit"],
                       b1["closest"], scene.tri_geom, o, d)
    _same_occluded("[sponza treelet] occluded against B1's", out["occ"],
                   b1["occ"])
    before = dict(treelet.TRACES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    treelet.trace_closest_treelet(scene, o, d, far, on, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    treelet.trace_occluded_treelet(scene, o, d, t_occ, on, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rounds = treelet.TRACES["rounds"] - before["rounds"]
    fallbacks = treelet.TRACES["fallbacks"]
    b1_c = _events_ms(lambda: kt.closest(scene.node_rows, o, d, far, on,
                                         stack_depth=meta.stack_depth,
                                         leaf_size=meta.leaf_size), 10)
    b1_a = _events_ms(lambda: kt.anyhit(scene.node_rows, o, d, t_occ, on,
                                        stack_depth=meta.stack_depth,
                                        leaf_size=meta.leaf_size), 10)
    print(f"[sponza treelet] {n} rays, {scene.cut_entry.shape[0]} treelets: "
          f"t and occluded bitwise B1's, another triangle at bitwise the "
          f"same t in {ties} lanes; {rounds} rounds a pair of queries, "
          f"{fallbacks} fallbacks in all; closest {1e3 * (t1 - t0):.2f} ms "
          f"and occluded {1e3 * (t2 - t1):.2f} ms (host clock, its rounds' "
          f"reads included) against B1's {b1_c:.4f} and {b1_a:.4f} ms")
    return counts


# Phase T's renders through the CLI: sponza 1080p, 64 bounces, 1 spp, the
# default, on 16-wide tables and with treelet-binned bounce rays.
TREELET_RUNS = {
    "sponza_1spp": (["proc:sponza", "--width", "1920", "--height", "1080",
                     "--max-bounces", "64"], 1),
    "sponza_wide16": (["proc:sponza", "--width", "1920", "--height", "1080",
                       "--max-bounces", "64", "--wide-arity", "16"], 1),
    "sponza_treelet": (["proc:sponza", "--width", "1920", "--height", "1080",
                        "--max-bounces", "64", "--bounce-traversal",
                        "treelet"], 1),
}


def render_treelet_path(tmp: str, smi: str) -> dict:
    """Phase T's renders: the 16-wide and the treelet films against the
    default one of the same seed (ray counts within RAY_SHARE, at most
    PIXEL_SHARE of pixels outside rtol = atol = FILM_TOL, both printed);
    s/sample and Mrays/s beside the card."""
    import numpy as np

    stats = render_main_path(tmp, TREELET_RUNS)
    ref = np.load(os.path.join(tmp, "sponza_1spp.npy"))
    rays = stats["sponza_1spp"]["rays"]
    for k, want in (("sponza_wide16", dict(arity=16)),
                    ("sponza_treelet", dict(bounce_traversal="treelet"))):
        s = stats[k]
        for field, v in want.items():
            if s[field] != v:
                raise AssertionError(f"[{k}] {field} {s[field]}, not {v}")
        if k == "sponza_treelet" and not s["treelet"]["rounds"]:
            raise AssertionError(f"[{k}] no treelet round ran")
        film = np.load(os.path.join(tmp, f"{k}.npy"))
        outside = ~np.isclose(film, ref, rtol=FILM_TOL, atol=FILM_TOL).all(-1)
        dr = abs(s["rays"] - rays)
        print(f"[{k}] against the default film: {int(outside.sum())} of "
              f"{outside.size} pixels outside rtol = atol = {FILM_TOL:g} "
              f"({outside.mean():.2e}), {int((film != ref).any(-1).sum())} "
              f"not bitwise equal; rays {s['rays']} against {rays} (differ "
              f"by {dr}); {s['render_seconds'] / s['spp']:.3f} s/sample, "
              f"{s['mrays_per_sec']:.2f} Mrays/s (default "
              f"{stats['sponza_1spp']['render_seconds']:.3f} s, "
              f"{stats['sponza_1spp']['mrays_per_sec']:.2f}); treelet "
              f"{s['treelet']}; {smi}")
        _limit(f"[{k}] pixels outside the bound", int(outside.sum()),
               outside.size, PIXEL_SHARE)
        _limit(f"[{k}] rays", dr, rays, RAY_SHARE)
    return stats


def _tool_module(name: str, folder: str = "tools"):
    """<folder>/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_module():
    """tools/torch_kernel_bench.py as a module."""
    return _tool_module("torch_kernel_bench")


def compare_tsort(name: str, scene, meta, device) -> None:
    """Phase 3c: treelet-sorted dispatch on a scene's incoherent rays."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops import tsort
    from gpupathtracer_tpu_torch.ops.traverse import (trace_closest,
                                                      trace_occluded)

    n = 2 * N_RAYS
    o, d = _bench_module().make_rays(f"proc:{name}", scene, meta, n,
                                     device)["incoherent"]
    rng = np.random.RandomState(4321)
    far = torch.full((n,), 1e20, device=device)
    t_occ = torch.as_tensor(rng.uniform(0.05, 20.0, n).astype(np.float32),
                            device=device)
    on = torch.as_tensor(rng.rand(n) < 0.9, device=device)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    base = trace_closest(scene, o, d, far, on, **kw)
    occ = trace_occluded(scene, o, d, t_occ, on, **kw)
    _hold_hits("[tsort] trace_closest(traversal='tsort')",
               trace_closest(scene, o, d, far, on, traversal="tsort", **kw),
               base)
    _hold_occluded("[tsort] trace_occluded(traversal='tsort')",
                   trace_occluded(scene, o, d, t_occ, on, traversal="tsort",
                                  **kw), occ)
    rows = scene.node_rows
    ms_c = _events_ms(lambda: kt.closest(rows, o, d, far, on, **kw), 10)
    ms_a = _events_ms(lambda: kt.anyhit(rows, o, d, t_occ, on, **kw), 10)
    print(f"[tsort] {name}, {n} incoherent rays, "
          f"{int(scene.cut_bounds.shape[0])} treelets: closest and occluded "
          f"bitwise equal to the unsorted traversal; unsorted trace_closest "
          f"{ms_c:.3f} ms, trace_anyhit {ms_a:.3f} ms")
    for key_mode in ("top1", "top2"):
        def sort():
            perm = tsort._sort_perm(scene.cut_bounds, o, d, far, on,
                                    key_mode=key_mode, scene=scene)
            return perm, torch.argsort(perm)

        perm, _ = sort()
        sort_ms = _events_ms(sort, 10)
        os_, ds_, fs_, ts_, ons_ = (x[perm].contiguous()
                                    for x in (o, d, far, t_occ, on))
        sorted_c = _events_ms(lambda: kt.closest(rows, os_, ds_, fs_, ons_,
                                                 **kw), 10)
        sorted_a = _events_ms(lambda: kt.anyhit(rows, os_, ds_, ts_, ons_,
                                                **kw), 10)
        whole_c = _events_ms(lambda: tsort.trace_closest_tsort(
            scene, o, d, far, on, key_mode=key_mode, **kw), 10)
        print(f"[tsort] key {key_mode}: sort (key, argsort, inverse) "
              f"{sort_ms:.3f} ms; kernels on sorted rays: trace_closest "
              f"{sorted_c:.3f} ms ({sorted_c / ms_c:.2f}x unsorted), "
              f"trace_anyhit {sorted_a:.3f} ms ({sorted_a / ms_a:.2f}x); "
              f"trace_closest_tsort whole (sort, gathers, kernel, "
              f"unpermute) {whole_c:.3f} ms ({whole_c / ms_c:.2f}x)")


def compare_cluster(name: str, width: int, height: int, rays, device,
                    results):
    """Phase 4 for one scene: the cluster entry points against their plain
    versions on the scene's cluster table, with phase 3's rays."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
    from gpupathtracer_tpu_torch.scene import load_scene

    cfg = _scene_cfg(name, width, height, cluster_tris=128)
    t0 = time.perf_counter()
    scene, meta = load_scene(cfg, device)
    tc = scene.cluster_rows.shape[1] // 3
    print(f"[{name} cluster] ingest {time.perf_counter() - t0:.2f} s: "
          f"{scene.cluster_rows.shape[0] // 8} clusters of {tc} "
          f"({scene.cluster_rows.numel() * 4 / 1e6:.1f} MB), "
          f"{scene.node_rows.shape[0]} top-tree rows, stack depth "
          f"{meta.stack_depth}")
    o, d, t_occ, on = rays
    far = torch.full((o.shape[0],), 1e20, device=device)
    tabs = (scene.node_rows, scene.cluster_rows)
    refs = scene.cluster_refs
    kw = dict(stack_depth=meta.stack_depth)
    pops_c, pops_a = {}, {}
    got = kc.closest_cluster(*tabs, refs, o, d, far, on, **kw)
    want = kc.closest_cluster_plain(*tabs, refs, o, d, far, on, pops=pops_c,
                                    **kw)
    err_c = _hold_hits(f"[{name} cluster] trace_cluster_closest", got, want)
    occ = kc.anyhit_cluster(*tabs, o, d, t_occ, on, **kw)
    occ_want = kc.anyhit_cluster_plain(*tabs, o, d, t_occ, on, pops=pops_a,
                                       **kw)
    err_a = _hold_occluded(f"[{name} cluster] trace_cluster_anyhit", occ,
                           occ_want)
    ms_c = _events_ms(lambda: kc.closest_cluster(*tabs, refs, o, d, far, on,
                                                 **kw), 10)
    plain_c = _events_ms(lambda: kc.closest_cluster_plain(
        *tabs, refs, o, d, far, on, **kw), 1)
    ms_a = _events_ms(lambda: kc.anyhit_cluster(*tabs, o, d, t_occ, on, **kw),
                      10)
    plain_a = _events_ms(lambda: kc.anyhit_cluster_plain(
        *tabs, o, d, t_occ, on, **kw), 1)
    n = o.shape[0]
    mt = results[name]
    print(f"[{name} cluster] {n} rays: bitwise equal to the plain versions; "
          f"hit rate {float((want[1] >= 0).float().mean()):.3f}, occluded "
          f"{float(occ.float().mean()):.3f}; pops per ray: closest "
          f"{pops_c.get('node', 0) / n:.2f} node, "
          f"{pops_c.get('leaf', 0) / n:.2f} cluster")
    print(f"[{name} cluster] trace_cluster_closest {ms_c:.3f} ms "
          f"({n / ms_c / 1e3:.1f} Mrays/s; MT trace_closest "
          f"{mt['trace_closest'][1]:.3f} ms), plain {plain_c:.1f} ms")
    print(f"[{name} cluster] trace_cluster_anyhit  {ms_a:.3f} ms "
          f"({n / ms_a / 1e3:.1f} Mrays/s; MT trace_anyhit "
          f"{mt['trace_anyhit'][1]:.3f} ms), plain {plain_a:.1f} ms")
    # Phase S on the cluster table: the counters, and pop_skip (closest).
    for skip in (False, True):
        label = f"[{name} cluster] closest" + (" pop_skip" if skip else "")
        st = kc.closest_cluster(*tabs, refs, o, d, far, on, with_stats=True,
                                pop_skip=skip, **kw)
        _hold_stats(label, st, kc.closest_cluster_plain(
            *tabs, refs, o, d, far, on, with_stats=True, pop_skip=skip, **kw))
        _hold_stats(f"{label} (hits without counters)", st[:4], got)
        _hold_stats(f"{label} (pop_skip alone)", kc.closest_cluster(
            *tabs, refs, o, d, far, on, pop_skip=skip, **kw), got)
        if skip:
            ms_skip = _events_ms(lambda: kc.closest_cluster(
                *tabs, refs, o, d, far, on, pop_skip=True, **kw), 10)
            skipped = int(st[4][:, 2].sum())
        else:
            counts = st[4]
    occ_st = kc.anyhit_cluster(*tabs, o, d, t_occ, on, with_stats=True, **kw)
    _hold_stats(f"[{name} cluster] any-hit", occ_st, kc.anyhit_cluster_plain(
        *tabs, o, d, t_occ, on, with_stats=True, **kw))
    _hold_stats(f"[{name} cluster] any-hit (without counters)", occ_st[:1],
                (occ,))
    results[name + "_cluster_pops_anyhit"] = tuple(
        int(x) for x in occ_st[1][:, :2].sum(dim=0))
    node, cl = (int(x) for x in counts[:, :2].sum(dim=0))
    print(f"[{name} cluster] counters: closest and any-hit, with and without "
          f"pop_skip, every ray bitwise equal to the plain version, hits "
          f"bitwise those without; closest {node / n:.2f} node and "
          f"{cl / n:.2f} cluster pops a ray; pop_skip skips {skipped} of "
          f"{cl} cluster pops ({skipped / max(cl, 1):.2%}), closest "
          f"{ms_skip:.3f} ms with it against {ms_c:.3f} without")
    results[name + "_cluster_pops"] = (node, cl)
    leaf = leaf_bytes_of(tc)
    results[name + "_cluster"] = {
        "trace_cluster_closest": (err_c, ms_c, plain_c, *bound(
            pops_c, leaf_bytes=leaf, slot_ops=CLUSTER_SLOT_OPS,
            io_bytes=n * 45)),
        "trace_cluster_anyhit": (err_a, ms_a, plain_a, *bound(
            pops_a, leaf_bytes=leaf, slot_ops=CLUSTER_SLOT_OPS,
            io_bytes=n * 30))}
    _print_bounds(name + " cluster", results[name + "_cluster"])
    return scene, meta


def compare_cluster_ties(device) -> None:
    """Phase 4 on the tie case of tests/test_torch_kernel.py: a soup whose
    every triangle appears twice, the twins in one block (checked), so
    each hit ties on two slots and the lower slot must win. 131,072 rays;
    closest and any-hit, with and without counters and pop_skip, every
    output bitwise the plain version's."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_cluster as kc

    tests = _tool_module("test_torch_kernel", "tests")
    case = tests.cluster_soup_case(tc=128, n_tris=600, n_rays=2 * N_RAYS,
                                   duplicate=True)
    blk0, blk1, slot0, slot1 = tests.twin_slots(case)
    if not (blk0 == blk1).all():
        raise AssertionError("tie case: twins in different blocks")
    tabs = [torch.as_tensor(case["tables"][k], device=device)
            for k in ("node_rows", "cluster_rows", "cluster_refs")]
    o, d, far, t_occ, on = (torch.as_tensor(case[k], device=device)
                            for k in ("o", "d", "far", "t_occ", "act"))
    kw = dict(stack_depth=case["depth"])
    label = "[ties] trace_cluster_closest"
    got = kc.closest_cluster(*tabs, o, d, far, on, **kw)
    _hold_hits(label, got, kc.closest_cluster_plain(*tabs, o, d, far, on,
                                                    **kw))
    won = got[1][got[1] >= 0].cpu().numpy()
    lower = np.where(slot0 < slot1, 0, 1)
    if not (won % 2 == lower[won // 2]).all():
        raise AssertionError(f"{label}: a tie went to the higher slot")
    for skip in (False, True):
        st = kc.closest_cluster(*tabs, o, d, far, on, with_stats=True,
                                pop_skip=skip, **kw)
        _hold_stats(f"{label} counters, pop_skip {skip}", st,
                    kc.closest_cluster_plain(*tabs, o, d, far, on,
                                             with_stats=True, pop_skip=skip,
                                             **kw))
        _hold_stats(f"{label} (hits without counters)", st[:4], got)
    occ = kc.anyhit_cluster(*tabs[:2], o, d, t_occ, on, **kw)
    _hold_occluded("[ties] trace_cluster_anyhit", occ, kc.anyhit_cluster_plain(
        *tabs[:2], o, d, t_occ, on, **kw))
    st = kc.anyhit_cluster(*tabs[:2], o, d, t_occ, on, with_stats=True, **kw)
    _hold_stats("[ties] trace_cluster_anyhit counters", st,
                kc.anyhit_cluster_plain(*tabs[:2], o, d, t_occ, on,
                                        with_stats=True, **kw))
    print(f"[ties] {len(blk0) * 2} triangles as twins in "
          f"{case['tables']['cluster_rows'].shape[0] // 8} blocks, "
          f"{o.shape[0]} rays: {len(won)} closest hits, each a tie won by "
          f"the lower slot; closest (counters, pop_skip) and any-hit "
          f"(counters) bitwise equal to the plain versions; occluded "
          f"{float(occ.float().mean()):.3f}")


def golden_check(device) -> None:
    """Phase 5: tests/test_golden.py's cornell recipe on the card."""
    import numpy as np

    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.render import Renderer

    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=32, height=32, ray_chunk=1024, max_bounces=8,
                       bvh_builder="cpp")
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    r = Renderer(cfg, device)
    for _ in range(8):
        r.render_frame()
    img = r.film_hdr()
    gold = np.load(os.path.join(ROOT, "tests", "golden",
                                "cornell_32_8spp.npz"))["hdr"]
    # The golden's own tolerance (tests/test_golden.py): rtol = atol = 2e-3.
    outside = (np.abs(img - gold) > 2e-3 + 2e-3 * np.abs(gold)).any(-1)
    print(f"[golden] cornell 32x32 8 spp on the card: max |diff| "
          f"{float(np.abs(img - gold).max()):.3g}, {int(outside.sum())} of "
          f"{outside.size} pixels outside rtol=atol=2e-3")
    if outside.mean() > 0.01:
        raise AssertionError("cornell golden: more than 1% of pixels differ")


# The wavefront rows (phase 6) and the cluster rows (phase 7): name ->
# CLI arguments, spp.
MAIN_RUNS = {
    "sponza": (["proc:sponza", "--width", "1920", "--height", "1080",
                "--max-bounces", "64", "--bounce-traversal", "tsort"], 3),
    "sponza_auto": (["proc:sponza", "--width", "1920", "--height", "1080",
                     "--max-bounces", "64", "--bounce-traversal", "auto"], 3),
    # Once more in the other order (tsort, auto, auto, tsort): a host-bound
    # frame drifts within a call.
    "sponza_auto_b": (["proc:sponza", "--width", "1920", "--height", "1080",
                       "--max-bounces", "64", "--bounce-traversal", "auto"],
                      3),
    "sponza_b": (["proc:sponza", "--width", "1920", "--height", "1080",
                  "--max-bounces", "64", "--bounce-traversal", "tsort"], 3),
    "bathroom": (["proc:bathroom", "--width", "1280", "--height", "720",
                  "--microfacet", "beckmann"], 4),
}
CLUSTER_RUNS = {
    "bathroom_cluster": (["proc:bathroom", "--width", "1280", "--height",
                          "720", "--microfacet", "beckmann",
                          "--cluster-tris", "128"], 4),
    "sponza_cluster": (["proc:sponza", "--width", "1920", "--height", "1080",
                        "--max-bounces", "64", "--cluster-tris", "128"], 1),
}


def render_main_path(tmp: str, runs):
    """Phases 6 and 7: the wavefront CLI on each run. Returns per-run
    stats."""
    import numpy as np

    from gpupathtracer_tpu_torch import cli

    stats = {}
    for name, (args, spp) in runs.items():
        png = os.path.join(tmp, f"{name}.png")
        hdr = os.path.join(tmp, f"{name}.npy")
        sj = os.path.join(tmp, f"{name}.json")
        rc = cli.main(args + ["--device", "cuda", "--spp", str(spp),
                              "--bvh-builder", "cpp", "--no-cache",
                              "--out", png,
                              "--hdr-out", hdr, "--stats-json", sj])
        if rc != 0:
            raise AssertionError(f"[{name}] CLI returned {rc}")
        with open(png, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"[{name}] {png} is not a PNG")
        film = np.load(hdr)
        h, w = int(args[4]), int(args[2])
        if film.shape != (h, w, 3):
            raise AssertionError(f"[{name}] film shape {film.shape}")
        if not np.isfinite(film).all() or not (film > 0).any():
            raise AssertionError(f"[{name}] film is not finite and nonzero")
        with open(sj) as f:
            s = json.load(f)
        spf = s["render_seconds"] / s["spp"]
        print(f"[{name}] {w}x{h}, {spp} spp: {spf:.3f} s/frame (frames "
              f"{', '.join(f'{x:.3f}' for x in s['frame_seconds'])} s), "
              f"{s['mrays_per_sec']:.1f} Mrays/s, {s['rays']} rays, film "
              f"mean {float(film.mean()):.4f}")
        stats[name] = s
    return stats


def render_wavefront_path(tmp: str):
    """Phase 6: the wavefront rows; and the sponza film with treelet-sorted
    bounce rays (named: "auto" is "same" on the card) against the film of
    "auto"."""
    import numpy as np

    stats = render_main_path(tmp, MAIN_RUNS)
    sorted_runs, auto_runs = ("sponza", "sponza_b"), ("sponza_auto",
                                                      "sponza_auto_b")
    for k, s in stats.items():
        want = "tsort" if k in sorted_runs else "same"
        if s["bounce_traversal"] != want:
            raise AssertionError(f"[{k}] bounce traversal resolved to "
                                 f"{s['bounce_traversal']}, not {want}")
        # The sorted branch really ran (wide phases only), and only there.
        ran = s["sorted"]
        if (min(ran.values()) <= 0) if k in sorted_runs else any(
                ran.values()):
            raise AssertionError(f"[{k}] sorts and sorted traces {ran} "
                                 f"under bounce traversal {want}")
    ref = np.load(os.path.join(tmp, "sponza_auto.npy")).view(np.int32)
    for k in sorted_runs + auto_runs[1:]:
        film = np.load(os.path.join(tmp, f"{k}.npy")).view(np.int32)
        differ = int((film != ref).any(-1).sum())
        if differ or stats[k]["rays"] != stats["sponza_auto"]["rays"]:
            raise AssertionError(f"[{k}] {differ} pixels differ from the "
                                 f"unsorted film's")

    def spf(keys):
        return " and ".join(
            f"{stats[k]['render_seconds'] / stats[k]['spp']:.3f}"
            for k in keys)

    def mrays(keys):
        return " and ".join(f"{stats[k]['mrays_per_sec']:.2f}" for k in keys)

    print(f"[sponza] --bounce-traversal tsort against auto (same on the "
          f"card), runs in the order tsort, auto, auto, tsort: films bitwise "
          f"equal ({ref.shape[0] * ref.shape[1]} pixels, "
          f"{stats['sponza']['rays']} rays each); tsort {spf(sorted_runs)} "
          f"s/frame ({mrays(sorted_runs)} Mrays/s), auto {spf(auto_runs)} "
          f"s/frame ({mrays(auto_runs)} Mrays/s); sorts and sorted traces "
          f"a run: {stats['sponza']['sorted']} (tsort), "
          f"{stats['sponza_auto']['sorted']} (auto)")
    return stats


# Rays of each of the tool's sets on which it holds every variant against
# the kernel's plain version (its sets are all active: phase 3's have 10%
# inactive lanes).
BENCH_CHECK = 8192
# The kernel A/B entry point's sweeps (phase 6b): arguments, and the entry
# points each must launch (make_rays traces the primaries with
# trace_closest in every sweep).
BENCH_ARGS = ["--device", "cuda", "--reps", "3", "--check", str(BENCH_CHECK)]
BENCH_RUNS = (
    ("sponza", ["--mode", "packet,tsort,subpacket,tsort-sub",
                "--interleave", "1,2", "--multi-pop", "2"],
     ("trace_closest", "trace_closest_ilv", "trace_closest_multi",
      "subpacket_closest")),
    ("sponza", ["--mode", "packet,tsort,subpacket,tsort-sub",
                "--interleave", "1,2", "--multi-pop", "2", "--any-hit"],
     ("trace_closest", "trace_anyhit", "trace_anyhit_ilv",
      "trace_anyhit_multi", "subpacket_anyhit")),
    ("bathroom", ["--mode", "dense,dense-vpu", "--k", "1024"],
     ("trace_closest", "dense_closest")),
    ("bathroom", ["--mode", "dense,dense-vpu", "--k", "1024", "--any-hit"],
     ("trace_closest", "dense_anyhit")),
)
# The kernel-accounting entry point (tools/kernel_bench.py --stats and
# tools/cluster_pops.py's A/B): the pop counters of the per-ray walks, the
# sub-packet stacks and the cluster walk with and without pop_skip, on
# sponza at the tool's 2^19 rays a set.
STATS_RUN = ("sponza", ["--mode", "packet,subpacket", "--interleave", "1,2",
                        "--multi-pop", "2", "--stats", "--cluster-tc", "128",
                        "--pop-skip"],
             ("trace_closest", "trace_closest_ilv", "trace_closest_multi",
              "subpacket_closest", "trace_closest_stats",
              "trace_cluster_closest", "trace_cluster_closest_stats"))


def run_kernel_bench(scenes) -> dict:
    """Phase 6b: tools/torch_kernel_bench.py main over BENCH_RUNS and
    STATS_RUN, each a driven path of its own. Returns the launches by entry
    point."""
    bench = _bench_module()
    launches = {}
    for name, argv, want in BENCH_RUNS + (STATS_RUN,):
        label = f"kernel bench {name} {' '.join(argv)}"
        got = {}
        counts = _drive(label, want, lambda: got.update(bench.main(
            ["--scene", f"proc:{name}"] + BENCH_ARGS + argv,
            loaded=scenes[name])))
        if any(v["plain_equal"] != 1.0 for v in got.values()):
            raise AssertionError(f"[{label}] a variant differs from its "
                                 f"kernel's plain version: {got}")
        worst = min(v["equal"] for v in got.values())
        if "dense" not in argv[1] and worst != 1.0:
            raise AssertionError(f"[{label}] a variant differs from the "
                                 f"first: {got}")
        if "--stats" in argv and any("pops" not in v for v in got.values()):
            raise AssertionError(f"[{label}] a variant printed no counters")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def run_arity_bench() -> dict:
    """Phase A's driven path: tools/torch_kernel_bench.py --arity A on
    bathroom (131,072 rays a set) for each of CARD_ARITIES, closest and
    any-hit, B1, B7 (W = 2), B8 (Q = 2) and B4 (tc 128), every variant's t
    or occlusion held to its plain version. Returns the launches by entry
    point."""
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    bench = _bench_module()
    launches = {}
    for arity in CARD_ARITIES:
        for any_hit in (False, True):
            q = "anyhit" if any_hit else "closest"
            want = tuple(kt.launch_key(k, arity, None) for k in (
                f"trace_{q}", f"trace_{q}_ilv", f"trace_{q}_multi",
                f"trace_cluster_{q}"))
            if any_hit:
                want += (kt.launch_key("trace_closest", arity, None),)
            argv = ["--scene", "proc:bathroom", "--arity", str(arity),
                    "--n", "131072", "--mode", "packet", "--interleave",
                    "1,2", "--multi-pop", "2", "--cluster-tc", "128"] + (
                        ["--any-hit"] if any_hit else [])
            label = f"kernel bench {' '.join(argv)}"
            got = {}
            counts = _drive(label, want, lambda: got.update(bench.main(
                argv + BENCH_ARGS)))
            if any(v["plain_equal"] != 1.0 for v in got.values()):
                raise AssertionError(f"[{label}] a variant differs from its "
                                     f"kernel's plain version: {got}")
            _add(launches, counts)
    return launches


def bench_quick() -> None:
    """Phase 7b: tools/torch_bench.py --quick in process (sponza 640x360:
    the realtime direct row, the probe of default, fpair and tsort, the
    winner's timed batches): every quick row present, its times finite and
    positive, its launches counted; the headline finite and positive."""
    tool = _tool_module("torch_bench")
    line = {}
    _drive("bench quick path", ("trace_closest", "trace_anyhit"),
           lambda: line.update(tool.main(["--quick"])))
    rows = line["extra"]["rows"]
    if list(rows) != tool.row_names(quick=True):
        raise AssertionError(f"[bench] rows {list(rows)}, expected "
                             f"{tool.row_names(quick=True)}")
    for name, row in rows.items():
        bad = [k for k in ("s_per_call", "spp_s", "mrays_s")
               if not (math.isfinite(row[k]) and row[k] > 0)]
        if bad or row["launches"]["trace_closest"] <= 0:
            raise AssertionError(f"[bench] row {name}: {bad or 'no launch'} "
                                 f"({row})")
    if line["metric"] != "mrays_per_sec_sponza_360p" or not (
            math.isfinite(line["value"]) and line["value"] > 0):
        raise AssertionError(f"[bench] headline {line['metric']} "
                             f"{line['value']}")
    print(f"[bench] --quick: {line['value']:.2f} Mrays/s, probe "
          f"{line['extra']['probes']}, rows "
          + ", ".join(f"{k} {v['s_per_call']:.4f} s" for k, v in rows.items()))


def _scene_cfg(name: str, width: int, height: int, **kw):
    """RenderConfig of a procedural scene at its default camera, C++ SBVH."""
    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    cfg = RenderConfig(scene_path=f"proc:{name}", width=width, height=height,
                       bvh_builder="cpp", **kw)
    pos, yaw, pitch, fov, aperture, focus = default_camera(name)
    cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                              fov=math.radians(fov), aspect=width / height,
                              aperture=aperture, focal_distance=focus)
    return cfg


def _kernel_name(mangled: str):
    """A kernel's name and template arguments (Li2E = 2, Lb1E = true) from
    its mangled name, where the name follows its length after the source's
    hashed anonymous namespace; None if there is none."""
    import re

    for m in re.finditer(r"\d+", mangled):
        for a in range(len(m.group())):
            n = int(m.group()[a:])
            ident = mangled[m.end():m.end() + n]
            if len(ident) == n and ident.endswith("kernel") and \
                    re.fullmatch(r"[A-Za-z_]\w*", ident):
                t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[m.end() + n:])
                targs = re.findall(r"L[ib](\d+)E", t.group(1) if t else "")
                return ident + (f"<{', '.join(targs)}>" if targs else "")
    return None


def _ptxas_summary(log: str):
    """One line per compiled kernel: registers, stack frame and spills."""
    import re

    from gpupathtracer_tpu_torch.ops.megakernel import MODELS

    out, name = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
            m = re.search(r"mega_kernelILi(\d)ELb(\d)ELb(\d)ELb(\d)E"
                          r"(?:Lb(\d)E)?", name)
            t = _kernel_name(name)
            if m:
                name = (f"mega_kernel<{MODELS[int(m.group(1))]}, "
                        f"nee={m.group(2)}, regen={m.group(3)}, "
                        f"cluster={m.group(4)}"
                        + (f", stats={m.group(5)}>" if m.group(5) else ">"))
            elif t:
                name = t
        elif "stack frame" in line and name:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[-1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {frame}")
            name = None
    return out


def build_kernels() -> None:
    """Phase 2: one nvcc per source, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from gpupathtracer_tpu_torch.ops import cuda_build

    names = ("traverse", "cluster_traverse", "megakernel", "dense_intersect",
             "subpacket_traverse", "roofline")
    # The walks again at each arity phase A runs (-DGPT_ARITY=A), all at once.
    jobs = [(n, ()) for n in names] + [
        (n, cuda_build.arity_defines(a)) for a in CARD_ARITIES
        for n in ("traverse", "cluster_traverse")]

    def one(job):
        t0 = time.perf_counter()
        _, log = cuda_build.build(*job)
        return time.perf_counter() - t0, log

    def host_build(load):
        # Phase 20's JPEG decoder, the codecs of phases 21 and 24, phase
        # 22's WebP decoders and phase 25's CCITT / ThunderScan and ZSTD
        # decoders and phase 26's JPEG 2000 decoder (g++), beside the nvcc
        # builds.
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    from gpupathtracer_tpu_torch.utils import codecs, jpeg, jpeg2000, webp, \
        zstd
    with ThreadPoolExecutor(len(jobs) + 6) as pool:
        j2k_secs = pool.submit(host_build, jpeg2000._load)
        jpeg_secs = pool.submit(host_build, jpeg._load)
        codecs_secs = pool.submit(host_build, codecs._load)
        webp_secs = pool.submit(host_build, webp._load)
        fax_secs = pool.submit(host_build, codecs._load_fax)
        zstd_secs = pool.submit(host_build, zstd._load)
        for (name, defines), (secs, log) in zip(jobs, pool.map(one, jobs)):
            print(f"[build] {os.path.relpath(cuda_build.source(name), ROOT)}"
                  + (f" {' '.join(defines)}" if defines else "")
                  + f": {secs:.2f} s")
            for line in _ptxas_summary(log):
                print(f"[build]   {line}")
            for line in log.splitlines():
                if "wgmma.mma_async instructions are serialized" in line:
                    print(f"[build]   {line.strip()}")
        print(f"[build] gpupathtracer_tpu_torch/utils/jpeg_cpp/jpeg.cpp (g++): "
              f"{jpeg_secs.result():.2f} s")
        print(f"[build] gpupathtracer_tpu_torch/utils/codecs_cpp/codecs.cpp "
              f"(g++): {codecs_secs.result():.2f} s")
        print(f"[build] gpupathtracer_tpu_torch/utils/webp_cpp/webp.cpp "
              f"(g++): {webp_secs.result():.2f} s")
        print(f"[build] gpupathtracer_tpu_torch/utils/fax_cpp/fax.cpp "
              f"(g++): {fax_secs.result():.2f} s")
        print(f"[build] gpupathtracer_tpu_torch/utils/zstd_cpp/zstd.cpp "
              f"(g++): {zstd_secs.result():.2f} s")
        print(f"[build] gpupathtracer_tpu_torch/utils/j2k_cpp/j2k.cpp "
              f"(g++): {j2k_secs.result():.2f} s")
    hgmma = _sass_count(cuda_build.build("roofline")[0], "mxu_wgmma_kernel",
                        "HGMMA")
    print(f"[build] HGMMA instructions in the SASS of each mxu_wgmma_kernel "
          f"instantiation: {hgmma}")
    if not hgmma or not all(hgmma.values()):
        raise AssertionError("the bf16 product's kernel issues no wgmma")
    mix = _sass_loop_mix(cuda_build.build("roofline")[0], "node_slab_kernel")
    print(f"[build] node_slab_kernel SASS, its longest loop by opcode: {mix}")
    if not mix["pops"]:
        raise AssertionError("node_slab_kernel: no loop of node pops found "
                             "in its SASS")


def _sass(lib: str) -> str:
    """cuobjdump -sass of a library."""
    import shutil

    from gpupathtracer_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout


def _sass_count(lib: str, function: str, opcode: str) -> dict:
    """Instructions of `opcode` in the SASS of each compiled function of
    `lib` whose name holds `function` (cuobjdump -sass)."""
    counts, name = {}, None
    for line in _sass(lib).splitlines():
        if "Function :" in line:
            name = line.split("Function :")[-1].strip()
            name = _kernel_name(name) if function in name else None
            if name:
                counts[name] = 0
        elif name and opcode in line:
            counts[name] += 1
    return counts


def _sass_loop_mix(lib: str, function: str) -> dict:
    """The instructions of the longest loop (the span from a backward
    branch's target to the branch) in the SASS of the first compiled
    function of `lib` whose name holds `function`: {opcode without its
    modifiers: count}, plus "pops": the FFMA count over the 48 a node pop
    has (the node probe's ray-pops a loop step)."""
    import re

    instr, inside = [], False
    for line in _sass(lib).splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = function in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)[.A-Z0-9_]*\s*([^;]*);", line)
        if inside and m:
            instr.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loop = (0, 0)
    for addr, op, args in instr:
        target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr and \
                addr - int(target.group(1), 16) > loop[1] - loop[0]:
            loop = (int(target.group(1), 16), addr)
    mix = {}
    for addr, op, _ in instr:
        if loop[0] <= addr <= loop[1]:
            mix[op] = mix.get(op, 0) + 1
    mix = dict(sorted(mix.items(), key=lambda kv: -kv[1]))
    mix["pops"] = mix.get("FFMA", 0) / (6 * 8)
    return mix


# The roofline probes (phase R): FP32 instructions issue at half the 67
# TFLOP/s of the data sheet (an FMA is two operations); bf16 products run at
# its 989 TFLOP/s on the tensor cores. A probe's bound is its own
# instructions (ops/roofline.py counts them) or its bf16 operations at that
# rate: it moves no bytes but its tile's.
PEAK_FP32_INSTR = PEAK_FLOPS / 2
PEAK_BF16_FLOPS = 989e12
# Iterations of the timed launch, per probe, and of every check.
PROBE_ITERS = {"roofline_vpu": 2048, "roofline_mxu_f32": 32,
               "roofline_mxu_bf16": 32, "roofline_node_slab": 256,
               "roofline_leaf_mt": 128, "roofline_cluster_dense": 64}
PROBE_CHECK_ITERS = 5
# Pops of the node and leaf probes' wrapping checks: not a multiple of
# their 64 rows.
WRAP_ITERS = 70
# Largest |kernel - plain| of the bf16 product, as a share of
# max_i sum_k |a_ik| max |b| * iters (tests/test_torch_roofline.py).
BF16_BOUND = 1e-6


def _probe_cases(device, tool):
    """Every probe launch of tools/torch_roofline.py run_compact, at its
    shapes and copies, then the f32 product at the other shapes of its
    main(), on seeded random inputs: a list of (name, case,
    kernel(iters, copies), plain(iters), blocks a copy, FP32 instructions
    or bf16 operations an iteration a copy, torch.matmul yardstick or None,
    bf16 tolerance scale an iteration or None for bitwise). The first case
    of each name is the one timed."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.ops import roofline as rl

    rng = np.random.RandomState(11)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def matmul(a_, b_):
        def run(iters, copies):
            big = a_.expand(copies, *a_.shape).reshape(-1, a_.shape[1])
            for _ in range(iters):
                torch.matmul(big, b_)
        return run

    x = t(rng.uniform(0.1, 1, tool.COMPACT_VPU))
    cases = [("roofline_vpu", f"{tuple(x.shape)} ilp 8",
              lambda it, c: rl.vpu(x, iters=it, ilp=8, copies=c),
              lambda it: rl.vpu_plain(x, iters=it, ilp=8),
              x.numel() // rl.THREADS, x.numel() * 8 * rl.VPU_STEP, None,
              None)]
    compact = [(m, k, n, dtype) for _, m, k, n, dtype, _, _ in
               tool.COMPACT_MXU]
    for m, k, n, dtype in compact + [
            (m, k, n, dtype) for m, k, n, dtype, _ in tool.MAIN_MXU
            if dtype == "float32" and (m, k, n, dtype) not in compact]:
        a, b = t(rng.uniform(-1, 1, (m, k))), t(rng.uniform(-1, 1, (k, n)))
        bf16 = dtype == "bfloat16"
        if bf16:
            a, b = a.bfloat16(), b.bfloat16()
        scale = (float(a.float().abs().sum(1).max() * b.float().abs().max())
                 if bf16 else None)
        cases.append((
            "roofline_mxu_bf16" if bf16 else "roofline_mxu_f32",
            f"[{m},{k}]x[{k},{n}] {dtype}",
            lambda it, c, a=a, b=b: rl.mxu(a, b, iters=it, copies=c),
            lambda it, a=a, b=b: rl.mxu_plain(a, b, iters=it),
            -(-m // 64) * -(-n // 64), (2 if bf16 else 1) * m * k * n,
            matmul(a, b), scale))
    g = tool.COMPACT_G
    rows = t(rng.uniform(0, 1, (64, 128)))
    o = t(rng.uniform(-0.5, 1.5, (3, g, 128)))
    d = torch.nn.functional.normalize(t(rng.normal(size=(3, g, 128))), dim=0)
    inv = 1.0 / d
    lanes = g * 128
    cases += [
        ("roofline_node_slab", f"G={g}",
         lambda it, c: rl.node_slab(rows, o, d, inv, iters=it, copies=c),
         lambda it: rl.node_slab_plain(rows, o, d, inv, iters=it),
         lanes // rl.THREADS, lanes * rl.NODE_POP, None, None),
        ("roofline_leaf_mt", f"G={g}",
         lambda it, c: rl.leaf_mt(rows, o, d, inv, iters=it, copies=c),
         lambda it: rl.leaf_mt_plain(rows, o, d, inv, iters=it),
         lanes // rl.THREADS, lanes * rl.LEAF_SIZE * rl.MT_SLOT, None,
         None)]
    # The leaf body on the edge rows of tests/test_torch_kernel.py (det = 0,
    # equal t, rays parallel to a triangle or pointing away), and the node
    # body on its own (flat, point, inverted and half-unbounded boxes, a box
    # around every origin, so tmin < 0; zero direction components, o * inv
    # NaN), at G = 16 and 1, and at WRAP_ITERS pops (the 64 rows wrap), in
    # every copy.
    tests = _tool_module("test_torch_kernel", "tests")
    for name, probe, plain, case_of, per_lane in (
            ("roofline_leaf_mt", rl.leaf_mt, rl.leaf_mt_plain,
             tests.leaf_probe_case, rl.LEAF_SIZE * rl.MT_SLOT),
            ("roofline_node_slab", rl.node_slab, rl.node_slab_plain,
             tests.node_probe_case, rl.NODE_POP)):
        for gg in (g, 1):
            edge = [t(x) for x in case_of(gg, seed=gg)]
            for label, iters in ((f"G={gg} edge rows", None),
                                 (f"G={gg} edge rows, {WRAP_ITERS} pops",
                                  WRAP_ITERS)):
                cases.append((
                    name, label,
                    lambda it, c, p=probe, a=edge, n=iters: p(
                        *a, iters=n or it, copies=c),
                    lambda it, p=plain, a=edge, n=iters: p(
                        *a, iters=n or it),
                    gg * 128 // rl.THREADS, gg * 128 * per_lane, None, None))
    for tc, any_hit in tool.COMPACT_CLUSTER:
        blk = t(rng.uniform(-1, 1, (16, 3 * tc)))
        cases.append((
            "roofline_cluster_dense",
            f"G={g} tc={tc}" + (" any-hit" if any_hit else ""),
            lambda it, c, blk=blk, ah=any_hit: rl.cluster_dense(
                blk, o, d, inv, iters=it, any_hit=ah, copies=c),
            lambda it, blk=blk, ah=any_hit: rl.cluster_dense_plain(
                blk, o, d, inv, iters=it, any_hit=ah),
            lanes // rl.THREADS,
            lanes * (tc * rl.CLUSTER_SLOT + rl.CLUSTER_EPILOGUE), None,
            None))
    # The tie case of tests/test_torch_kernel.py: slots j, j + 32, ... in
    # one plane (equal t), the lowest slot must win.
    for tc in (128, 256):
        blk = t(tests.cluster_tie_blocks(tc))
        cases.append((
            "roofline_cluster_dense", f"G={g} tc={tc} ties",
            lambda it, c, blk=blk: rl.cluster_dense(blk, o, d, inv, iters=it,
                                                    copies=c),
            lambda it, blk=blk: rl.cluster_dense_plain(blk, o, d, inv,
                                                       iters=it),
            lanes // rl.THREADS,
            lanes * (tc * rl.CLUSTER_SLOT + rl.CLUSTER_EPILOGUE), None,
            None))
    return cases


def roofline_phase(device, results) -> dict:
    """Phase R: every probe launch of run_compact against its plain version
    (every copy), the first of each probe timed beside it; then
    tools/torch_roofline.py run_compact, a driven path of its own. Returns
    run_compact's rates."""
    import torch

    from gpupathtracer_tpu_torch.ops import roofline as rl

    tool = _tool_module("torch_roofline")
    tool.set_device(device)
    for name, case, kernel, plain, blocks, work, lib, scale in _probe_cases(
            device, tool):
        copies = tool.copies_for(blocks)
        got = kernel(PROBE_CHECK_ITERS, copies)
        want = plain(PROBE_CHECK_ITERS)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        label = f"[roofline] {name} {case}, {copies} copies"
        if scale is not None:
            bound = BF16_BOUND * scale * PROBE_CHECK_ITERS
            if err > bound or not all(torch.equal(got[0], c) for c in got):
                raise AssertionError(f"{label}: max |diff| {err:.3g} (bound "
                                     f"{bound:.3g}), or copies differ")
            held = (f"every copy equal, within {bound:.3g} of the plain "
                    f"version (max |diff| {err:.3g})")
        else:
            bad = [c for c in range(copies) if not torch.equal(
                got[c].view(torch.int32), want.view(torch.int32))]
            if bad:
                raise AssertionError(f"{label}: copies {bad[:5]} differ from "
                                     f"the plain version")
            held = "every copy bitwise equal to the plain version"
        # The first case of each probe is timed; the bf16 product at each of
        # its shapes (128^3 and 512^3), its first in the kernels line.
        if name in results["roofline"] and scale is None:
            worst, *rest = results["roofline"][name]
            results["roofline"][name] = (max(worst, err), *rest)
            print(f"{label}: {held}")
            continue
        iters = PROBE_ITERS[name]
        ms = _events_ms(lambda: kernel(iters, copies), 3)
        plain_ms = _events_ms(lambda: plain(iters), 1)
        peak = PEAK_BF16_FLOPS if scale is not None else PEAK_FP32_INSTR
        bound_ms = 1e3 * work * iters * copies / peak
        if lib and torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("torch.matmul would run TF32: not the "
                                 "probe's work")
        lib_ms = _events_ms(lambda: lib(iters, copies), 3) if lib else None
        print(f"{label}: {held}; {iters} iterations {ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms (one copy), bound {bound_ms:.4f} ms "
              f"(operations), kernel at {bound_ms / ms:.1%} of it"
              + (f"; torch.matmul on the same work {lib_ms:.3f} ms "
                 f"({ms / lib_ms:.2f}x; float32 matmul precision "
                 f"{torch.get_float32_matmul_precision()!r}, allow_tf32 "
                 f"{torch.backends.cuda.matmul.allow_tf32})"
                 if lib else ""))
        if name in results["roofline"]:
            worst, *rest = results["roofline"][name]
            results["roofline"][name] = (max(worst, err), *rest)
        else:
            results["roofline"][name] = (err, ms, plain_ms, bound_ms,
                                         "operations", lib_ms)
        if lib and ms > lib_ms:
            print(f"{label}: the kernel is slower than torch.matmul on the "
                  f"same work")
    rates = {}
    results["roofline_launches"] = _drive(
        "roofline path", tuple(rl.LAUNCHES), lambda: rates.update(
            tool.run_compact(reps=3, to_stderr=False, device=device,
                             strict=True)))
    print(f"[roofline] run_compact: {json.dumps(rates)}")
    return rates


def _mega_bound(pops: dict, rays: int, lanes: int, leaf_bytes: int,
                slot_ops: int):
    """The megakernel's bound from its plain version's pops over both walks,
    plus SHADE_OPS per traced ray; in/out about 21 bytes per lane."""
    return bound(pops, leaf_bytes=leaf_bytes, slot_ops=slot_ops,
                 io_bytes=lanes * 21, extra_ops=rays * SHADE_OPS)


def compare_mega(device, results, cluster_tris: int = 0) -> None:
    """Phase 8: trace_mega against trace_mega_plain on the same inputs, on
    MT leaves or (cluster_tris > 0) on cluster leaves."""
    import torch

    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.math.camera import generate_image_plane
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.scene import load_scene

    entry = "trace_mega_cluster" if cluster_tris else "trace_mega"
    cases = [("bathroom", 256, 144, "beckmann", 64, 1),
             ("bathroom", 256, 144, "beckmann", 64, 4),
             ("table", 200, 150, "trowbridge_reitz", 0, 8)]
    scenes, errs = {}, []
    for name, w, h, model, mb, spp in cases:
        cfg = _scene_cfg(name, w, h, skybox="GENERATE COLOR BLACK",
                         microfacet=model, cluster_tris=cluster_tris)
        if name not in scenes:
            scenes[name] = load_scene(cfg, device)
        scene, meta = scenes[name]
        lane = torch.arange(w * h, device=device)
        args, kw = mk.prepare_mega(
            scene, mk.pack_mega_tables(scene),
            generate_image_plane(cfg.camera, device),
            (lane % w).float(), (lane // w).float(), random.PRNGKey(7, device),
            width=w, height=h, stack_depth=meta.stack_depth,
            leaf_size=meta.leaf_size, max_bounces=mb, nee=True, model=model,
            n_mats=meta.num_materials,
            n_lights=int(scene.light_rows.shape[0]),
            packet_size=cfg.pallas_packet_size, spp=spp)
        label = (f"[{entry} {name} {w}x{h} {model} max_bounces={mb} "
                 f"spp={spp}]")
        got, rays = mk.trace_mega(*args, **kw)
        pops = {}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want, rays_plain, st_plain = mk.trace_mega_plain(
            *args, pops=pops, with_stats=True, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        errs.append(_hold_mega(label, got, want, rays, rays_plain))
        st = _hold_mega_stats(label, mk.trace_mega(*args, with_stats=True,
                                                   **kw),
                              got, want, st_plain, kw["packet_size"])
        ms = _events_ms(lambda: mk.trace_mega(*args, **kw), 3)
        slot_ops = CLUSTER_SLOT_OPS if cluster_tris else MT_SLOT_OPS
        b_ms, by = _mega_bound(pops, int(rays), args[7].shape[0],
                               leaf_bytes_of(cluster_tris), slot_ops)
        print(f"{label} {entry} {ms:.2f} ms ({int(rays) / ms / 1e3:.1f} "
              f"Mrays/s), trace_mega_plain {plain_ms:.1f} ms (with pop "
              f"counting); bound {b_ms:.4f} ms ({by}), kernel at "
              f"{b_ms / ms:.1%} of it")
        if (name, spp) == ("bathroom", 4):  # the regenerating path's case
            timed = (ms, plain_ms, b_ms, by)
            node = int(st[:, 2].sum() + st[:, 4].sum())
            leaf = int(st[:, 3].sum() + st[:, 5].sum())
            rates = results["rates"]
            if cluster_tris:
                pop_account(f"B2 {label} (cluster pops at the tc = 128 "
                            f"body)", ms, node, leaf, rates,
                            "cluster_pop_ray_ps_tc128")
            else:
                pop_account(f"B2 {label} (leaf pops at the slots they "
                            f"test)", ms, node, leaf, rates,
                            "leaf_pop_ray_ps",
                            pops.get("slots", 0) / max(leaf, 1) / 10)
    results["mega"][entry] = (max(errs), *timed)
    if not cluster_tris:
        from gpupathtracer_tpu_torch.ops import cuda_build

        # Every MT instantiation (its frame is the walks' local stack).
        for line in _ptxas_summary(cuda_build.build("megakernel")[1]):
            if "cluster=0" in line:
                print(f"[{entry}] ptxas {line}")


def compare_mega_soups(device, results) -> None:
    """Phase 8 on the soups of tests/test_torch_kernel.py, through the
    cluster megakernel (each cluster pop run by the whole warp): the
    twin-triangle tie case (tc 128) and a tc 256 soup, 97 x 61 lanes in
    one packet (not a multiple of 32: the last warp has idle lanes), one
    sample and four with regeneration (lanes end their samples at
    different bounces). Ray counts, contributions and the [P, 9] counters
    bitwise the plain version's, and the counting variant's contributions
    the kernel's."""
    import torch

    from gpupathtracer_tpu_torch.ops import megakernel as mk

    tests = _tool_module("test_torch_kernel", "tests")
    errs = []
    for tc, duplicate in ((128, True), (256, False)):
        for spp in (1, 4):
            args, kw = tests.soup_mega_case(tc, duplicate, 97, 61, spp, 16,
                                            device)
            label = (f"[trace_mega_cluster soup tc {tc}"
                     + (" twins" if duplicate else "") + f" 97x61 spp={spp}]")
            got, rays = mk.trace_mega(*args, **kw)
            want, rays_plain, st_plain = mk.trace_mega_plain(
                *args, with_stats=True, **kw)
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                raise AssertionError(f"{label} lanes differ from the plain "
                                     f"version")
            errs.append(_hold_mega(label, got, want, rays, rays_plain))
            c, rays_st, st = mk.trace_mega(*args, with_stats=True, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(c.view(torch.int32), got.view(torch.int32))
                    and torch.equal(st, st_plain)
                    and int(rays_st) == int(rays)):
                raise AssertionError(f"{label} the counting variant differs")
            print(f"{label} counters bitwise the plain version's: "
                  f"{st[0].tolist()}")
    worst, *rest = results["mega"]["trace_mega_cluster"]
    results["mega"]["trace_mega_cluster"] = (max([worst] + errs), *rest)


def _hold_mega_stats(label, out, got, want, st_plain, packet: int):
    """The counting variant against the kernel and the plain version: its
    contributions bitwise the kernel's, its counters the plain version's in
    every packet whose lanes the kernel and the plain version computed
    bitwise alike (_hold_mega bounds the others). Returns the counters."""
    import torch

    c, rays, st = out
    torch.cuda.synchronize()
    if not torch.equal(c.view(torch.int32), got.view(torch.int32)):
        raise AssertionError(f"{label} the counting variant's contributions "
                             f"differ from the kernel's")
    same = ~(got.view(torch.int32) != want.view(torch.int32)).any(1)
    whole = same.reshape(-1, packet).all(1)
    bad = whole & (st != st_plain).any(1)
    if bad.any():
        raise AssertionError(f"{label} counters of {int(bad.sum())} packets "
                             f"differ from the plain version's")
    if int(st[:, 0:2].sum()) != int(rays):
        raise AssertionError(f"{label} counters' rays {int(st[:, 0:2].sum())}"
                             f" against {int(rays)}")
    tot = st.sum(dim=0).tolist()
    print(f"{label} counters equal to the plain version's in {int(whole.sum())}"
          f" of {whole.numel()} packets (the rest hold a lane that differs): "
          f"closest {tot[2]} node + {tot[3]} leaf pops, any-hit {tot[4]} + "
          f"{tot[5]}, tail {tot[6]} + {tot[7]}, iterations p50 "
          f"{int(st[:, 8].median())}")
    return st


def _hold_mega(label, got, want, rays, rays_plain) -> float:
    """The kernel's lanes against the plain version's on the same inputs:
    ray counts equal, and every lane bitwise equal but at most
    MEGA_LANE_BOUND of them, which are printed. Returns the max |diff|."""
    import torch

    if int(rays) != int(rays_plain):
        raise AssertionError(f"{label} rays: kernel {int(rays)}, plain "
                             f"{int(rays_plain)}")
    differ = (got.view(torch.int32) != want.view(torch.int32)).any(1)
    bad = torch.nonzero(differ).squeeze(1)
    err = float((got - want).abs().max())
    n = got.shape[0]
    if bad.numel():
        for i in bad[:10].tolist():
            print(f"{label} lane {i}: kernel {got[i].tolist()}, plain "
                  f"{want[i].tolist()}")
        print(f"{label} {bad.numel()} of {n} lanes differ, max |diff| "
              f"{err:.3g} (bound: {MEGA_LANE_BOUND:.1%} of lanes)")
        if bad.numel() > MEGA_LANE_BOUND * n:
            raise AssertionError(f"{label} {bad.numel()} lanes differ")
    print(f"{label} {n} lanes, {int(rays)} rays equal, {n - bad.numel()} "
          f"lanes bitwise equal")
    return err


def _first_packets(args, kw, packets: int):
    """The trace_mega arguments of the first ``packets`` packets alone. A
    lane depends only on its packet's seed and its index in the packet, so
    these lanes compute what they compute in the whole launch."""
    m = packets * kw["packet_size"]
    rows, mats, lights, cdf, params, o, d, act, seeds = args

    def cut(x):
        return None if x is None else x[:m]
    return ((rows, mats, lights, cdf, params, cut(o), cut(d), act[:m],
             seeds[:packets]),
            dict(kw, pxn=cut(kw.get("pxn")), pyn=cut(kw.get("pyn"))))


def compare_mega_rows(device, results, runs) -> None:
    """Phase 9: for each row of ``runs`` (phase 10's or 11's), the first
    chunk of its first frame as the Renderer builds it (same
    configuration, lanes, key and arguments). The kernel runs on all the
    chunk's lanes, and on its first MEGA_PACKETS packets alone, which must
    give the same lanes; then the kernel and the plain version run on those
    packets at no more than MEGA_CHECK_SPP samples a lane."""
    import torch

    from gpupathtracer_tpu_torch import cli
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.render import Renderer

    for name, args, batch, frames in runs:
        cfg = cli.build_config(cli.parse_args(
            _mega_argv(args, batch, frames)))
        r = Renderer(cfg, device)
        if not r.use_mega:
            raise AssertionError(f"[{name}] the scene is not mega-eligible")
        entry = "trace_mega_cluster" if cfg.cluster_tris else "trace_mega"
        sl = slice(0, r.chunk)
        statics = r.mega_statics(cfg.integrator)
        margs, kw = mk.prepare_mega(
            r.scene, r.mega_tables, r.camera, r.pixel_x[sl], r.pixel_y[sl],
            r.chunk_key(0), sample_idx=0, spp=batch, **statics)
        n = margs[7].shape[0]
        full, rays_full = mk.trace_mega(*margs, **kw)
        ms = _events_ms(lambda: mk.trace_mega(*margs, **kw), 2)
        sargs, skw = _first_packets(margs, kw, MEGA_PACKETS)
        m = sargs[7].shape[0]
        got, rays = mk.trace_mega(*sargs, **skw)
        label = (f"[{entry} {name} first chunk, {statics['model']}, "
                 f"max_bounces={statics['max_bounces']}, spp={batch}]")
        if not torch.equal(got.view(torch.int32),
                           full[:m].view(torch.int32)):
            raise AssertionError(f"{label} the first {MEGA_PACKETS} packets "
                                 f"alone differ from the whole launch")
        spp = min(batch, MEGA_CHECK_SPP)
        if spp != batch:
            cargs, ckw = mk.prepare_mega(
                r.scene, r.mega_tables, r.camera, r.pixel_x[sl],
                r.pixel_y[sl], r.chunk_key(0), sample_idx=0, spp=spp,
                **statics)
            sargs, skw = _first_packets(cargs, ckw, MEGA_PACKETS)
            got, rays = mk.trace_mega(*sargs, **skw)
        t0 = time.perf_counter()
        want, rays_plain = mk.trace_mega_plain(*sargs, **skw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = _hold_mega(f"{label} packets 0-{MEGA_PACKETS - 1} at spp="
                         f"{spp}", got, want, rays, rays_plain)
        worst, *rest = results["mega"][entry]
        results["mega"][entry] = (max(worst, err), *rest)
        print(f"{label} {entry} on all {n} lanes: {ms:.1f} ms, "
              f"{int(rays_full)} rays ({int(rays_full) / ms / 1e3:.1f} "
              f"Mrays/s); trace_mega_plain on {m} lanes at spp={spp}: "
              f"{plain_s:.1f} s")


# The megakernel rows of the JAX bench (bench.py:186-225, 352-371) at their
# published sizes: (name, CLI arguments, frame batch, frames).
MEGA_RUNS = (
    ("bathroom_mega", ["proc:bathroom", "--width", "1280", "--height", "720",
                       "--microfacet", "beckmann"], 64, 64),
    ("table_mega", ["proc:table", "--width", "800", "--height", "600",
                    "--max-bounces", "64"], 128, 64),
    ("table_direct_mega", ["proc:table", "--width", "800", "--height", "600",
                           "--integrator", "direct"], 8, 16),
)
# The bench's megacluster rows (bathroom, bench.py:382-387, frame batch 1)
# with their frame-batched counterparts, and table's (bench.py:219-221).
MEGACLUSTER_RUNS = (
    ("bathroom_megacluster", ["proc:bathroom", "--width", "1280", "--height",
                              "720", "--microfacet", "beckmann",
                              "--cluster-tris", "128"], 1, 32),
    ("bathroom_megacluster64", ["proc:bathroom", "--width", "1280",
                                "--height", "720", "--microfacet",
                                "beckmann", "--cluster-tris", "128"], 64, 8),
    ("table_megacluster", ["proc:table", "--width", "800", "--height", "600",
                           "--max-bounces", "64", "--cluster-tris", "128"],
     1, 32),
    ("table_megacluster128", ["proc:table", "--width", "800", "--height",
                              "600", "--max-bounces", "64", "--cluster-tris",
                              "128"], 128, 8),
)
# Phase 9 holds the kernel to its plain version on this many packets of
# each row's first chunk, at the row's arguments but for its samples a lane,
# cut to MEGA_CHECK_SPP (the 128-sample rows ran at 128 until phase 17 took
# the smoke past 800 s, the rows at 64 at 64 until phase 18 did). The plain
# version's time is its loop, one step a bounce of every sample in turn,
# about half a minute a row at 32 samples, and neither fewer lanes nor a
# lower bounce cap shortens it.
MEGA_PACKETS = 2
MEGA_CHECK_SPP = 32


def _mega_argv(args, batch: int, frames: int):
    """The CLI arguments of a megakernel row: black sky, one chunk, no scene
    disk cache."""
    return args + ["--device", "cuda", "--megakernel", "on", "--frame-batch",
                   str(batch), "--spp", str(frames), "--skybox",
                   "GENERATE COLOR BLACK", "--bvh-builder", "cpp", "--chunk",
                   "2097152", "--no-cache"]


def render_mega_path(tmp: str, runs, entry: str):
    """Phases 10 and 11: the megakernel path through the CLI; ``entry``
    must launch and no other kernel. Returns per-run stats."""
    import numpy as np

    from gpupathtracer_tpu_torch import cli

    stats = {}
    for name, args, batch, frames in runs:
        png = os.path.join(tmp, f"{name}.png")
        hdr = os.path.join(tmp, f"{name}.npy")
        sj = os.path.join(tmp, f"{name}.json")
        before = _launches()[entry]
        rc = cli.main(_mega_argv(args, batch, frames) + [
            "--out", png, "--hdr-out", hdr, "--stats-json", sj])
        if rc != 0:
            raise AssertionError(f"[{name}] CLI returned {rc}")
        with open(png, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"[{name}] {png} is not a PNG")
        film = np.load(hdr)
        w, h = int(args[2]), int(args[4])
        if film.shape != (h, w, 3):
            raise AssertionError(f"[{name}] film shape {film.shape}")
        if not np.isfinite(film).all() or not (film > 0).any():
            raise AssertionError(f"[{name}] film is not finite and nonzero")
        counts = _launches()
        if counts[entry] <= before:
            raise AssertionError(f"[{name}] never launched {entry}")
        others = {k: v for k, v in counts.items() if k != entry and v}
        if others:
            raise AssertionError(f"[{name}] launched other kernels: {others}")
        with open(sj) as f:
            s = json.load(f)
        samples = frames * batch
        print(f"[{name}] {w}x{h}, {frames} frames x {batch} samples: "
              f"{s['render_seconds'] / samples:.5f} s/sample, "
              f"{s['render_seconds'] / frames:.4f} s/frame, "
              f"{s['mrays_per_sec']:.1f} Mrays/s, {s['rays']} rays, "
              f"{counts[entry] - before} {entry} launches, "
              f"film mean {float(film.mean()):.4f}")
        stats[name] = s
    return stats


def mega_vs_wavefront(device) -> None:
    """Phase 12: the two integrators' films agree in the mean (the random
    streams differ, so the agreement is statistical)."""
    from gpupathtracer_tpu_torch.render import Renderer

    means = {}
    for mode in ("on", "off"):
        cfg = _scene_cfg("table", 200, 150, skybox="GENERATE COLOR BLACK",
                         max_bounces=64, frame_batch=64, megakernel=mode)
        r = Renderer(cfg, device)
        if r.use_mega != (mode == "on"):
            raise AssertionError(f"megakernel={mode}: use_mega={r.use_mega}")
        r.render_frame(sync=True)
        means[mode] = float(r.film_hdr().mean())
    rel = abs(means["on"] - means["off"]) / means["off"]
    print(f"[mega vs wavefront] table 200x150, 64 bounces, 64 spp: film "
          f"mean {means['on']:.5f} (megakernel) vs {means['off']:.5f} "
          f"(wavefront), {rel:.2%} apart (bound 2%)")
    if rel > 0.02:
        raise AssertionError("megakernel and wavefront means differ by more "
                             "than 2%")


def cluster_vs_mt(device) -> None:
    """Phase 13: the same megakernel render on cluster and on MT leaves.
    Both trace the same hits in exact arithmetic and draw the same random
    numbers; the films' means must agree within 2%."""
    from gpupathtracer_tpu_torch.render import Renderer

    means = {}
    for tc in (128, 0):
        cfg = _scene_cfg("table", 200, 150, skybox="GENERATE COLOR BLACK",
                         max_bounces=64, frame_batch=64, megakernel="on",
                         cluster_tris=tc)
        r = Renderer(cfg, device)
        if not r.use_mega or (r.scene.cluster_rows is not None) != bool(tc):
            raise AssertionError(f"cluster_tris={tc}: not the megakernel "
                                 f"on the expected leaves")
        r.render_frame(sync=True)
        means[tc] = float(r.film_hdr().mean())
    rel = abs(means[128] - means[0]) / means[0]
    print(f"[cluster vs MT] table 200x150, 64 bounces, 64 spp, megakernel: "
          f"film mean {means[128]:.6f} (cluster leaves) vs {means[0]:.6f} "
          f"(MT leaves), {rel:.4%} apart (bound 2%)")
    if rel > 0.02:
        raise AssertionError("cluster and MT means differ by more than 2%")


# Phase 14: name -> (CLI arguments, spp); the reference's rows launch the
# closest-hit kernel alone.
REFERENCE_RUNS = {
    "sponza_reference": (["proc:sponza", "--width", "1920", "--height",
                          "1080", "--max-bounces", "64", "--integrator",
                          "reference"], 2),
}
AO_RUNS = {
    "sponza_ao": (["proc:sponza", "--width", "1920", "--height", "1080",
                   "--integrator", "ao"], 4),
}
# The generated town's framing (tests/test_textured_town.py's camera).
TOWN_CAMERA = ["--position", "0,9,-26", "--rotation", f"{math.pi},-0.28",
               "--fov", "55", "--skybox", "GENERATE COLOR BLACK"]


def _spp_line(stats, smi) -> None:
    for name, s in stats.items():
        print(f"[{name}] {s['render_seconds'] / s['spp']:.4f} s/sample "
              f"({s['spp']} samples, {s['mrays_per_sec']:.1f} Mrays/s) on "
              f"{smi}")


def render_ao_path(tmp: str, smi: str):
    """Phase 14: AO through the CLI; its film must lie in [0, 1]."""
    import numpy as np

    stats = render_main_path(tmp, AO_RUNS)
    for name in AO_RUNS:
        film = np.load(os.path.join(tmp, f"{name}.npy"))
        if film.min() < 0 or film.max() > 1:
            raise AssertionError(f"[{name}] AO film outside [0, 1]: "
                                 f"{film.min()} .. {film.max()}")
    _spp_line(stats, smi)


def render_town_path(tmp: str, town: str, smi: str):
    """Phase 14: the port's generated textured town (its default 24 houses)
    through the CLI at 1280x720 with 4 mip levels."""
    stats = render_main_path(tmp, {"town_mips": (
        [town, "--width", "1280", "--height", "720", "--mip-levels", "4",
         *TOWN_CAMERA], 4)})
    cfg = stats["town_mips"]["config"]
    if cfg["mip_levels"] != 4:
        raise AssertionError(f"--mip-levels reached the config as "
                             f"{cfg['mip_levels']}")
    print(f"[town_mips] {stats['town_mips']['triangles']} triangles")
    _spp_line(stats, smi)


def _sun_cfg(width: int, height: int, mode: str, **kw):
    """proc:bunny with the sun under a black sky, framed as the JAX
    package's tests/test_integrator.py frames it."""
    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig

    cfg = RenderConfig(scene_path="proc:bunny", skybox="GENERATE COLOR BLACK",
                       width=width, height=height, ray_chunk=width * height,
                       sun_enabled=True, sun_mode=mode, bvh_builder="cpp",
                       **kw)
    cfg.camera = CameraConfig(position=(0.0, 4.0, -12.0), yaw=math.pi,
                              pitch=-0.25, fov=math.radians(45), aspect=1.0)
    return cfg


def render_sun_path(tmp: str, device, smi: str, width=1280, height=720,
                    spp=4):
    """Phase 14: the Renderer with the sun, disk and cone; a PNG each, the
    film finite and nonzero (the sun is the only light)."""
    from gpupathtracer_tpu_torch.render import Renderer

    for mode in ("disk", "cone"):
        r = Renderer(_scene_cfg("bunny", width, height, sun_enabled=True,
                                sun_mode=mode,
                                skybox="GENERATE COLOR BLACK"), device)
        if r.use_mega:
            raise AssertionError("the sun took the megakernel")
        _renderer_frames(f"sun_{mode}", r, spp, tmp, smi)


def _means(cfg, device, frames: int, integrator: str):
    import numpy as np

    from gpupathtracer_tpu_torch.render import Renderer

    r = Renderer(cfg, device)
    for _ in range(frames):
        r.render_frame(integrator)
    img = r.film_hdr()
    if not np.isfinite(img).all():
        raise AssertionError(f"{integrator} film is not finite")
    return img


def integrator_agreement(device) -> None:
    """Phase 15: the JAX package's statistical checks of the integrators
    (tests/test_integrator.py, their recipes and bounds) on the card."""
    import numpy as np

    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig

    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=32, height=32, ray_chunk=1024, bvh_builder="cpp")
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    img_w = _means(cfg, device, 12, "wavefront")
    img_r = _means(cfg, device, 48, "reference")
    mw, mr = img_w.mean(axis=(0, 1)), img_r.mean(axis=(0, 1))
    rel = float((np.abs(mw - mr) / (mr + 1e-6)).max())
    print(f"[agreement] cornell 32x32: wavefront 12 spp means {mw}, "
          f"reference 48 spp {mr}: {rel:.2%} apart at most (bound 8%); "
          f"channel spread {float(mw.std()):.4f} (> 0.005)")
    if rel >= 0.08 or mw.std() <= 0.005:
        raise AssertionError("cornell: wavefront and reference disagree")

    img_w = _means(_sun_cfg(24, 24, "disk", max_bounces=8), device, 12,
                   "wavefront")
    img_r = _means(_sun_cfg(24, 24, "disk", max_bounces=8), device, 48,
                   "reference")
    mw, mr = float(img_w.mean()), float(img_r.mean())
    rel = abs(mw - mr) / (mr + 1e-9)
    print(f"[agreement] bunny 24x24 with the sun: wavefront 12 spp mean "
          f"{mw:.5f}, reference 48 spp {mr:.5f}: {rel:.2%} apart (bound "
          f"25%); wavefront max {float(img_w.max()):.4f} (> 0.05)")
    if rel >= 0.25 or img_w.max() <= 0.05:
        raise AssertionError("sun: wavefront and reference disagree")

    imgs = {mode: _means(_sun_cfg(24, 24, mode, max_bounces=8, seed=5),
                         device, 16, "wavefront") for mode in ("disk", "cone")}
    md, mc = float(imgs["disk"].mean()), float(imgs["cone"].mean())
    rel = abs(md - mc) / (md + 1e-9)
    print(f"[agreement] bunny 24x24, sun cone against disk, 16 spp: means "
          f"{mc:.5f} and {md:.5f}, {rel:.2%} apart (bound 15%); cone max "
          f"{float(imgs['cone'].max()):.4f} (> 0.05)")
    if rel >= 0.15 or imgs["cone"].max() <= 0.05:
        raise AssertionError("sun: cone and disk disagree")


# Phase 16: a pixel is outside when a channel leaves rtol = atol = 2e-3 of
# the CPU's; at most this share may be, and the channel means must agree
# within CPU_MEAN_BOUND.
CPU_PIXEL_SHARE = 0.01
CPU_MEAN_BOUND = 0.01


def card_vs_cpu(device, town: str, mirror_glass: str, cubemap: str,
                size: int = 32, spp: int = 4) -> None:
    """Phase 16: the new paths at size x size on the card and through the
    port's plain versions on the CPU, the same seed and configuration: the
    reference, AO, the sun, textures with mips; mirrors and glass, a
    cubemap sky, the ld sampler, light-end shadow rays and the coherence
    sort."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.render import Renderer

    cornell = dict(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                   width=size, height=size, max_bounces=8, bvh_builder="cpp")
    cases = {
        "reference": (RenderConfig(**cornell), "reference"),
        "ao": (RenderConfig(**cornell), "ao"),
        "sun_disk": (_sun_cfg(size, size, "disk", max_bounces=8),
                     "wavefront"),
        "sun_cone": (_sun_cfg(size, size, "cone", max_bounces=8),
                     "wavefront"),
        "town_mips": (RenderConfig(scene_path=town, width=size, height=size,
                                   skybox="GENERATE COLOR BLACK",
                                   max_bounces=8, mip_levels=4,
                                   bvh_builder="cpp"), "wavefront"),
    }
    cases.update({
        "mirror_glass": (_mirror_cfg(mirror_glass, size, 8), "wavefront"),
        "cubemap": (_scene_cfg("bunny", size, size, skybox=cubemap,
                               max_bounces=8), "wavefront"),
        "ld": (RenderConfig(**cornell, sampler="ld"), "wavefront"),
        "shadow_rev": (RenderConfig(**cornell, shadow_rev=True),
                       "wavefront"),
        "sort_rays": (RenderConfig(**cornell, sort_rays=True), "wavefront"),
    })
    for name in ("reference", "ao", "ld", "shadow_rev", "sort_rays"):
        cases[name][0].camera = CameraConfig(
            position=(2.75, 2.75, -7.0), yaw=math.pi, fov=math.radians(45),
            aspect=1.0)
    cases["town_mips"][0].camera = CameraConfig(
        position=(0.0, 9.0, -26.0), yaw=math.pi, pitch=-0.28,
        fov=math.radians(55), aspect=1.0)
    for name, (cfg, integrator) in cases.items():
        films, rays = {}, {}
        for dev in (device, torch.device("cpu")):
            r = Renderer(cfg, dev)
            for _ in range(spp):
                r.render_frame(integrator)
            films[dev.type] = r.film_hdr()
            r.stats.finalize()
            rays[dev.type] = r.stats.rays_traced
        card, cpu = films[device.type], films["cpu"]
        outside = (np.abs(card - cpu) > 2e-3 + 2e-3 * np.abs(cpu)).any(-1)
        mc, mp = card.mean(axis=(0, 1)), cpu.mean(axis=(0, 1))
        rel = float((np.abs(mc - mp) / (np.abs(mp) + 1e-6)).max())
        print(f"[card vs CPU] {name} {size}x{size}, {spp} spp: "
              f"{int(outside.sum())} of {outside.size} pixels outside "
              f"rtol = atol = 2e-3, max |diff| "
              f"{float(np.abs(card - cpu).max()):.3g}, channel means "
              f"{rel:.3%} apart, rays {rays[device.type]} (card) and "
              f"{rays['cpu']} (CPU)")
        if not np.isfinite(card).all() or card.max() <= 0:
            raise AssertionError(f"[card vs CPU] {name}: the card's film is "
                                 f"not finite and nonzero")
        if outside.mean() > CPU_PIXEL_SHARE or rel > CPU_MEAN_BOUND:
            raise AssertionError(f"[card vs CPU] {name}: the card's film "
                                 f"leaves the CPU's bound")


# Phase 17: the delta materials, glTF, image skies, the coherence sort and
# light-end shadow rays, and the ld sampler at full width.
SPONZA_1080 = ["--width", "1920", "--height", "1080", "--max-bounces", "64"]
# The sample indices at which the card's LD sequences must be the CPU's:
# the ends of float32's exact integers and of 32 bits.
LD_INDICES = (0, 1, (1 << 24) - 1, (1 << 32) - 2)
# Phase 17d: the shadow_rev film's channel means against the default's.
REV_MEAN_BOUND = 0.01


def _camera_args(name: str):
    """A procedural scene's default camera as CLI flags, for a file that
    holds its mesh."""
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    pos, yaw, pitch, fov, aperture, focus = default_camera(name)
    # "=" keeps argparse from reading a leading minus sign as a flag.
    return [f"--position={','.join(str(x) for x in pos)}",
            f"--rotation={yaw},{pitch}", f"--fov={fov}",
            f"--aperture={aperture}", f"--focus={focus}"]


def _delta_materials(materials):
    """proc:sponza's materials with its columns and sphere stone
    ("stone2") made a mirror and its banners ("banner") glass, ior 1.5."""
    from dataclasses import replace

    from gpupathtracer_tpu_torch.scene.materials import (MATERIAL_MIRROR,
                                                         MATERIAL_REFRACTIVE)

    kinds = {"stone2": dict(material_type=MATERIAL_MIRROR),
             "banner": dict(material_type=MATERIAL_REFRACTIVE, ior=1.5)}
    return [replace(m, **kinds.get(m.name, {})) for m in materials]


def _renderer_frames(label: str, r, frames: int, tmp: str, smi: str):
    """Renders ``frames`` frames (synchronized), writes the PNG, holds the
    film finite and nonzero, prints s/sample; returns the film."""
    import numpy as np

    for _ in range(frames):
        r.render_frame(sync=True)
    png = r.save_screenshot(os.path.join(tmp, f"{label}.png"))
    with open(png, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"[{label}] {png} is not a PNG")
    film = r.film_hdr()
    if not np.isfinite(film).all() or not (film > 0).any():
        raise AssertionError(f"[{label}] film is not finite and nonzero")
    r.stats.finalize()
    print(f"[{label}] {r.width}x{r.height}, {frames} spp: "
          f"{sum(r.stats.frame_times) / frames:.4f} s/sample "
          f"({r.stats.mrays_per_sec:.1f} Mrays/s, {r.stats.rays_traced} "
          f"rays, film mean {float(film.mean()):.4f}) on {smi}")
    return film


def render_delta_path(tmp: str, device, smi: str) -> None:
    """Phase 17a: proc:sponza with mirror columns and spheres and glass
    banners, 1920x1080, 64 bounces, 2 spp, through the Renderer."""
    from gpupathtracer_tpu_torch.models import wavefront
    from gpupathtracer_tpu_torch.render import Renderer
    from gpupathtracer_tpu_torch.scene import pack_scene
    from gpupathtracer_tpu_torch.scene.envmap import environment_image
    from gpupathtracer_tpu_torch.scene.mesh import build_triangle_soup
    from gpupathtracer_tpu_torch.scene.procedural import load_procedural

    cfg = _scene_cfg("sponza", 1920, 1080, max_bounces=64)
    mesh, materials = load_procedural("proc:sponza")
    scene, meta = pack_scene(build_triangle_soup(mesh),
                             _delta_materials(materials),
                             environment_image(cfg.skybox), cfg, device)
    if not meta.has_delta:
        raise AssertionError("[sponza delta] has_delta is false")
    r = Renderer(cfg, device, scene=scene, meta=meta)
    wavefront.DELTA_LANES = counts = {"hits": 0, "delta": 0}
    try:
        _renderer_frames("sponza_delta", r, 2, tmp, smi)
    finally:
        wavefront.DELTA_LANES = None
    hits, on_delta = counts["hits"], counts["delta"]
    print(f"[sponza_delta] {meta.num_triangles} triangles; {on_delta} of "
          f"{hits} lanes that hit a surface ({on_delta / max(hits, 1):.2%}) "
          f"hit a mirror or glass")
    if not on_delta:
        raise AssertionError("[sponza delta] no lane hit a delta surface")


def write_sponza_glb(path: str):
    """proc:sponza as a .glb: one primitive per material (its corners,
    u32 indices), baseColorFactor the albedo, the emission as an
    emissiveFactor times KHR_materials_emissive_strength, the banners
    transmissive (KHR_materials_transmission 1.0, ior 1.5). Returns the
    path and the triangle count."""
    import struct

    import numpy as np

    from gpupathtracer_tpu_torch.scene.procedural import load_procedural

    mesh, materials = load_procedural("proc:sponza")
    tri_mat = mesh.mat_ids[mesh.triangles[:, 0]]
    blob, views, accessors, meshes, gmats = bytearray(), [], [], [], []

    def add(arr, kind, ctype, **extra):
        raw = arr.tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(raw)})
        blob.extend(raw + b"\0" * ((-len(raw)) % 4))
        accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                          "count": int(len(arr)), "type": kind, **extra})
        return len(accessors) - 1

    for m, desc in enumerate(materials):
        sel = mesh.triangles[tri_mat == m]
        if m == 0 or not len(sel):
            continue
        pos = np.ascontiguousarray(mesh.positions[sel.reshape(-1)],
                                   np.float32)
        a = add(pos, "VEC3", 5126, min=pos.min(0).tolist(),
                max=pos.max(0).tolist())
        i = add(np.arange(len(pos), dtype=np.uint32), "SCALAR", 5125)
        meshes.append({"primitives": [{"attributes": {"POSITION": a},
                                       "indices": i,
                                       "material": len(gmats)}]})
        gm = {"name": desc.name, "pbrMetallicRoughness": {
            "baseColorFactor": [*map(float, desc.albedo), 1.0],
            "metallicFactor": float(desc.metallic),
            "roughnessFactor": float(desc.roughness_g)}}
        strength = max(desc.emission)
        if strength > 0:
            gm["emissiveFactor"] = [e / strength for e in desc.emission]
            gm["extensions"] = {"KHR_materials_emissive_strength":
                                {"emissiveStrength": strength}}
        if desc.name == "banner":
            gm["extensions"] = {
                "KHR_materials_transmission": {"transmissionFactor": 1.0},
                "KHR_materials_ior": {"ior": 1.5}}
        gmats.append(gm)
    doc = {"asset": {"version": "2.0"}, "scene": 0,
           "scenes": [{"nodes": list(range(len(meshes)))}],
           "nodes": [{"mesh": k} for k in range(len(meshes))],
           "meshes": meshes, "materials": gmats,
           "buffers": [{"byteLength": len(blob)}],
           "bufferViews": views, "accessors": accessors}
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(blob)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    return path, int(len(mesh.triangles))


def render_gltf_path(tmp: str, smi: str) -> None:
    """Phase 17b: proc:sponza's mesh as a .glb through the CLI (1920x1080,
    64 bounces, 1 spp; the banners transmissive), and the demo glTF
    (write_demo_gltf) at 1280x720, 4 spp."""
    from gpupathtracer_tpu_torch.scene.samplegen import write_demo_gltf

    glb, tris = write_sponza_glb(os.path.join(tmp, "sponza.glb"))
    demo = write_demo_gltf(os.path.join(tmp, "demo.gltf"))
    stats = render_main_path(tmp, {
        "sponza_glb": ([glb, *SPONZA_1080, *_camera_args("sponza")], 1),
        "demo_gltf": ([demo, "--width", "1280", "--height", "720",
                       "--position", "0,2,-7", "--rotation",
                       f"{math.pi},-0.2", "--fov", "60"], 4)})
    s = stats["sponza_glb"]
    print(f"[sponza_glb] {os.path.getsize(glb)} bytes, {s['triangles']} "
          f"triangles (proc:sponza {tris}), has_delta {s['has_delta']}")
    if s["triangles"] != tris or not s["has_delta"]:
        raise AssertionError("[sponza_glb] the glTF is not sponza's mesh "
                             "with its glass banners")
    _spp_line(stats, smi)


def write_skies(folder: str, size: int = 512):
    """A 2048x1024 PNG equirect (a horizon gradient with a bright band) and
    a .txt cubemap of six size x size PNG faces, each its own colour with a
    gradient; returns (equirect path, cubemap list path)."""
    import numpy as np

    from gpupathtracer_tpu_torch.utils.io import save_png

    v = np.linspace(0.0, 1.0, 1024, dtype=np.float32)[:, None, None]
    u = np.linspace(0.0, 1.0, 2048, dtype=np.float32)[None, :, None]
    sky = np.concatenate([0.3 + 0.6 * v + 0 * u, 0.4 + 0.5 * v + 0 * u,
                          0.6 + 0.4 * v + 0.2 * np.sin(8 * np.pi * u) ** 2],
                         axis=-1)
    equirect = save_png(os.path.join(folder, "sky_equirect.png"),
                        np.clip(sky, 0, 1))
    ramp = np.linspace(0.3, 1.0, size, dtype=np.float32)[:, None, None]
    names = []
    for i, c in enumerate([(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0),
                           (1, 0, 1), (0, 1, 1)]):
        face = np.broadcast_to(np.asarray(c, np.float32) * ramp,
                               (size, size, 3))
        names.append(f"face{i}.png")
        save_png(os.path.join(folder, names[-1]), face)
    cubemap = os.path.join(folder, "sky_cube.txt")
    with open(cubemap, "w") as f:
        f.write("\n".join(names) + "\n")
    return equirect, cubemap


def render_sky_path(tmp: str, skies, smi: str) -> None:
    """Phase 17c: proc:bunny at 1280x720, 4 spp, under the PNG equirect and
    under the cubemap, through the CLI."""
    equirect, cubemap = skies
    stats = render_main_path(tmp, {
        f"bunny_{name}": (["proc:bunny", "--width", "1280", "--height", "720",
                           "--skybox", path], 4)
        for name, path in (("equirect", equirect), ("cubemap", cubemap))})
    _spp_line(stats, smi)


def render_a21_path(tmp: str, device, smi: str) -> None:
    """Phase 17d: proc:sponza 1920x1080, 64 bounces, 1 spp, one scene load:
    the default film, the sort_rays film (bitwise the default, the same
    rays) and the shadow_rev film (channel means within REV_MEAN_BOUND)."""
    import numpy as np

    from gpupathtracer_tpu_torch.render import Renderer
    from gpupathtracer_tpu_torch.scene import load_scene

    cfg = _scene_cfg("sponza", 1920, 1080, max_bounces=64)
    scene, meta = load_scene(cfg, device)
    films, rays = {}, {}
    for name, kw in (("default", {}), ("sort_rays", dict(sort_rays=True)),
                     ("shadow_rev", dict(shadow_rev=True))):
        r = Renderer(_scene_cfg("sponza", 1920, 1080, max_bounces=64, **kw),
                     device, scene=scene, meta=meta)
        films[name] = _renderer_frames(f"sponza_{name}", r, 1, tmp, smi)
        rays[name] = r.stats.rays_traced
    ref = films["default"]
    differ = int((films["sort_rays"].view(np.int32)
                  != ref.view(np.int32)).any(-1).sum())
    print(f"[sponza_sort_rays] {differ} of {ref.shape[0] * ref.shape[1]} "
          f"pixels differ from the default film's; rays {rays['sort_rays']} "
          f"against {rays['default']}")
    if differ or rays["sort_rays"] != rays["default"]:
        raise AssertionError("[sponza sort_rays] the film is not the "
                             "default film")
    rev = films["shadow_rev"]
    outside = (np.abs(rev - ref) > 2e-3 + 2e-3 * np.abs(ref)).any(-1)
    mr, md = rev.mean(axis=(0, 1)), ref.mean(axis=(0, 1))
    rel = float((np.abs(mr - md) / (np.abs(md) + 1e-6)).max())
    print(f"[sponza_shadow_rev] channel means {mr} against {md}: {rel:.3%} "
          f"apart (bound {REV_MEAN_BOUND:.0%}); {outside.mean():.3%} of "
          f"pixels outside rtol = atol = 2e-3; rays {rays['shadow_rev']} "
          f"against {rays['default']}")
    if rel > REV_MEAN_BOUND:
        raise AssertionError("[sponza shadow_rev] the channel means leave "
                             "the bound")


def render_ld_path(tmp: str, smi: str) -> None:
    """Phase 17e: proc:sponza 1920x1080 with --sampler ld, 2 spp."""
    stats = render_main_path(tmp, {"sponza_ld": (
        ["proc:sponza", *SPONZA_1080, "--sampler", "ld"], 2)})
    if stats["sponza_ld"]["config"]["sampler"] != "ld":
        raise AssertionError("[sponza_ld] --sampler ld did not reach the "
                             "config")
    _spp_line(stats, smi)


def ld_sequences_on_card(device, width: int = 1920, height: int = 1080):
    """Phase 17e: r2_sequence, pixel_rotation and the wavefront's jitter on
    the card, bitwise the CPU's, over every pixel id of a 1080p film at
    LD_INDICES."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.math.sampling import (pixel_rotation,
                                                       r2_sequence)
    from gpupathtracer_tpu_torch.models.wavefront import ld_jitter

    ids = torch.arange(width * height, dtype=torch.int64)
    px, py = (ids % width).float(), (ids // width).float()
    checks = [("pixel_rotation", pixel_rotation(ids.to(device)),
               pixel_rotation(ids))]
    for idx in LD_INDICES:
        checks.append((f"r2_sequence({idx})", r2_sequence(idx, device),
                       r2_sequence(idx)))
        checks.append((f"jitter({idx})",
                       ld_jitter(px.to(device), py.to(device), width, idx),
                       ld_jitter(px, py, width, idx)))
    for label, card, cpu in checks:
        if not np.array_equal(card.cpu().numpy(), cpu.numpy()):
            raise AssertionError(f"[ld] {label} on the card is not the "
                                 f"CPU's")
    print(f"[ld] r2_sequence, pixel_rotation and the jitter at sample "
          f"indices {LD_INDICES} over {width * height} pixel ids: bitwise "
          f"the CPU's on the card")


def write_mirror_obj(folder: str, glass: bool = False) -> str:
    """tests/test_integrator.py::test_mirror_material's scene (an illum 5
    mirror floor under a light); with ``glass``, also an illum 7 pane
    (Ni 1.5) standing on the floor."""
    with open(os.path.join(folder, "m.mtl"), "w") as f:
        f.write("newmtl mirror\nKd 0.9 0.9 0.9\nNs 1000\nillum 5\n"
                "newmtl light\nKd 0 0 0\nKe 10 10 10\nNs 1\n"
                "newmtl glass\nKd 1 1 1\nNi 1.5\nillum 7\n")
    obj = ("mtllib m.mtl\n"
           "v -5 0 -5\nv 5 0 -5\nv 5 0 5\nv -5 0 5\n"
           "v -1 4 -1\nv 1 4 -1\nv 1 4 1\nv -1 4 1\n"
           "vn 0 1 0\nvn 0 -1 0\n"
           "usemtl mirror\nf 1//1 4//1 3//1 2//1\n"
           "usemtl light\nf 5//2 6//2 7//2 8//2\n")
    if glass:
        obj += ("v -0.5 0 -2\nv -0.5 0 2\nv -0.5 2.5 2\nv -0.5 2.5 -2\n"
                "vn 1 0 0\nusemtl glass\nf 9//3 10//3 11//3 12//3\n")
    path = os.path.join(folder, "mirror_glass.obj" if glass else "mirror.obj")
    with open(path, "w") as f:
        f.write(obj)
    return path


def _mirror_cfg(path: str, size: int, max_bounces: int):
    """The mirror recipe's configuration and camera (above the floor, looking
    down at the mirror beside the light)."""
    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig

    cfg = RenderConfig(scene_path=path, skybox="GENERATE COLOR BLACK",
                       width=size, height=size, ray_chunk=size * size,
                       max_bounces=max_bounces, bvh_builder="cpp")
    cfg.camera = CameraConfig(position=(3.0, 2.5, 0.0), yaw=-math.pi / 2,
                              pitch=-0.8, fov=math.radians(60), aspect=1.0)
    return cfg


def _ld_cfg(sampler: str, **kw):
    """tests/test_ld_sampler.py's cornell configuration."""
    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig

    cfg = RenderConfig(scene_path="proc:cornell",
                       skybox="GENERATE COLOR BLACK", width=24, height=24,
                       ray_chunk=576, max_bounces=3, sampler=sampler,
                       bvh_builder="cpp", **kw)
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    return cfg


def delta_ld_sky_recipes(device, folder: str) -> None:
    """Phase 15: the JAX package's own recipes and bounds on the card:
    tests/test_integrator.py's mirror material (max > 3, 20th percentile <
    0.5) and glass furnace (0.80 < mean < 1.1), tests/test_ld_sampler.py's
    deterministic ld render, tests/test_edge_cases.py's cubemap face
    colours."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.render import Renderer
    from gpupathtracer_tpu_torch.scene import pack_scene
    from gpupathtracer_tpu_torch.scene.envmap import (EnvMap,
                                                      environment_image,
                                                      sample_env)
    from gpupathtracer_tpu_torch.scene.materials import MATERIAL_REFRACTIVE
    from gpupathtracer_tpu_torch.scene.mesh import build_triangle_soup
    from gpupathtracer_tpu_torch.scene.procedural import SceneBuilder
    from gpupathtracer_tpu_torch.utils.io import save_png

    r = Renderer(_mirror_cfg(write_mirror_obj(folder), 32, 4), device)
    if not r.meta.has_delta:
        raise AssertionError("[mirror] has_delta is false")
    img = _means(r.cfg, device, 16, "wavefront")
    p20 = float(np.percentile(img, 20))
    print(f"[recipes] mirror 32x32, 16 spp: max {float(img.max()):.3f} "
          f"(> 3), 20th percentile {p20:.4f} (< 0.5)")
    if not (img.max() > 3.0 and p20 < 0.5):
        raise AssertionError("[recipes] the mirror recipe fails its bounds")

    sb = SceneBuilder()
    glass = sb.add_material(name="glass", albedo=(1.0, 1.0, 1.0),
                            material_type=MATERIAL_REFRACTIVE, ior=1.5)
    sb.add_icosphere([0, 0, 0], 1.0, glass, subdiv=3)
    mesh, mats = sb.build()
    cfg = RenderConfig(width=24, height=24, ray_chunk=576, max_bounces=24,
                       bvh_builder="cpp")
    cfg.camera = CameraConfig(position=(0, 0, -4), yaw=math.pi,
                              fov=math.radians(40), aspect=1.0)
    scene, meta = pack_scene(build_triangle_soup(mesh), mats,
                             np.ones((2, 4, 3), np.float32), cfg, device)
    r = Renderer(cfg, device, scene=scene, meta=meta)
    for _ in range(16):
        r.render_frame()
    mean = float(r.film_hdr().mean())
    print(f"[recipes] glass furnace 24x24, 24 bounces, 16 spp: mean "
          f"{mean:.4f} (0.80 .. 1.1)")
    if not (meta.has_delta and 0.80 < mean < 1.1):
        raise AssertionError("[recipes] the glass furnace fails its bounds")

    accum = {}
    for name, sampler, source in (("a", "ld", None), ("b", "ld", "a"),
                                  ("c", "random", "a")):
        kw = {} if source is None else dict(scene=accum[source][1].scene,
                                            meta=accum[source][1].meta)
        rr = Renderer(_ld_cfg(sampler), device, **kw)
        rr.render_frame("wavefront")
        rr.render_frame("wavefront")
        accum[name] = (rr.accum.cpu().numpy(), rr)
    a = accum["a"][0]
    if not (np.isfinite(a).all() and a.max() > 0
            and np.array_equal(a, accum["b"][0])
            and not np.array_equal(a, accum["c"][0])):
        raise AssertionError("[recipes] the ld render is not deterministic "
                             "and finite, or equals the random sampler's")
    print("[recipes] ld: two renders bitwise equal, finite, not the random "
          "sampler's")

    colors = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
              (0, 1, 1)]
    faces = os.path.join(folder, "faces8")
    os.makedirs(faces, exist_ok=True)
    for i, c in enumerate(colors):
        save_png(os.path.join(faces, f"face{i}.png"),
                 np.broadcast_to(np.asarray(c, np.float32), (8, 8, 3)).copy())
    with open(os.path.join(faces, "sky.txt"), "w") as f:
        f.write("\n".join(f"face{i}.png" for i in range(6)) + "\n")
    env = EnvMap(image=torch.tensor(environment_image(
        os.path.join(faces, "sky.txt")), device=device))
    d = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], dtype=torch.float32,
                     device=device)
    out = sample_env(env, d).cpu().numpy()
    for i, c in enumerate(colors):
        if np.argmax(out[i]) != np.argmax(c):
            raise AssertionError(f"[recipes] cube face {i}: {out[i]}, not "
                                 f"{c}")
    print("[recipes] cubemap face list: every axis sees its face's colour")


# Phase 18: checkpoints, the scene disk cache, the viewer, the packet and
# per-ray traversals and the debug trails (plain torch and host code: no
# kernel of their own; their renders run B1).
CHECKPOINT_RUN = ["proc:sponza", "--width", "1920", "--height", "1080",
                  "--max-bounces", "64", "--device", "cuda", "--bvh-builder",
                  "cpp"]
VIEWER_FRAMES = 60
# Phase 18e's films: bathroom at this size, one sample.
WALK_FILM = (256, 144)


def render_checkpoint_path(tmp: str, smi: str) -> None:
    """Phase 18a: sponza 1920x1080 through the CLI, 1 sample and
    --checkpoint, then --resume and 1 more, against --spp 2: the films
    bitwise (0 pixels); the file's bytes and the seconds of a save and of
    a load (the file alone, and load_checkpoint). Every run reads the scene
    from the disk cache phase 18b wrote in ``tmp``."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch import cli
    from gpupathtracer_tpu_torch.render.checkpoint import (load_checkpoint,
                                                           save_checkpoint)

    ckpt = os.path.join(tmp, "sponza.ckpt")
    run = CHECKPOINT_RUN + ["--cache-dir", os.path.join(tmp, "scene_cache")]
    for args in (["--spp", "1", "--checkpoint", ckpt],
                 ["--spp", "1", "--resume", ckpt, "--hdr-out",
                  os.path.join(tmp, "resumed.npy")],
                 ["--spp", "2", "--hdr-out", os.path.join(tmp, "full.npy")]):
        rc = cli.main(run + args + ["--out", os.path.join(tmp, "ck.png")])
        if rc != 0:
            raise AssertionError(f"[checkpoint] CLI returned {rc}")
    resumed, full = (np.load(os.path.join(tmp, f"{k}.npy")).view(np.int32)
                     for k in ("resumed", "full"))
    differ = int((resumed != full).any(-1).sum())
    if differ or not (full.view(np.float32) > 0).any():
        raise AssertionError(f"[checkpoint] the resumed film differs from "
                             f"the uninterrupted one in {differ} pixels")
    t0 = time.perf_counter()
    with np.load(ckpt) as z:
        accum = z["accum"]
    t1 = time.perf_counter()
    r = load_checkpoint(ckpt, torch.device("cuda", 0))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    save_checkpoint(r, os.path.join(tmp, "again.ckpt"))
    t3 = time.perf_counter()
    print(f"[checkpoint] sponza 1920x1080, 1 + 1 samples through "
          f"--checkpoint / --resume: bitwise the --spp 2 film (0 of "
          f"{full.shape[0] * full.shape[1]} pixels differ); the file "
          f"{os.path.getsize(ckpt)} bytes ({accum.nbytes} of accumulator); "
          f"save {t3 - t2:.3f} s, load {t1 - t0:.3f} s (the file) and "
          f"{t2 - t1:.3f} s (load_checkpoint, its scene from the disk "
          f"cache); {smi}")


def cache_check(tmp: str, device, smi: str) -> None:
    """Phase 18b: a cold and a warm load_scene of sponza with the disk
    cache in a fresh folder of ``tmp`` (phase 18a's CLI runs read it):
    every SceneData tensor bitwise; both times and the file's bytes."""
    import torch

    from gpupathtracer_tpu_torch.scene import cache, load_scene

    cfg = _scene_cfg("sponza", 1920, 1080, cache_enabled=True,
                     cache_dir=os.path.join(tmp, "scene_cache"))
    t0 = time.perf_counter()
    cold, cmeta = load_scene(cfg, device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    warm, wmeta = load_scene(cfg, device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for f in cold._fields:
        a, b = getattr(cold, f), getattr(warm, f)
        if f == "env":
            a, b = a.image, b.image
        if isinstance(a, torch.Tensor) and not (
                a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.view(torch.uint8) if a.dim() else a,
                                b.view(torch.uint8) if b.dim() else b)):
            raise AssertionError(f"[cache] {f} differs between the cold and "
                                 f"the warm ingest")
    if (cmeta.stack_depth, cmeta.num_triangles) != (wmeta.stack_depth,
                                                    wmeta.num_triangles):
        raise AssertionError("[cache] the warm scene's meta differs")
    print(f"[cache] sponza ({cmeta.num_triangles} triangles): cold ingest "
          f"{t1 - t0:.3f} s (SBVH and the file's write), warm {t2 - t1:.3f} "
          f"s, every tensor bitwise; the file "
          f"{os.path.getsize(cache.cache_path(cfg))} bytes; {smi}")


def render_viewer_path(smi: str) -> None:
    """Phase 18c: --viewer-bench 60 on proc:table 640x360, the direct
    integrator and the wavefront: fps and the ANSI encode's ms."""
    import contextlib
    import io

    from gpupathtracer_tpu_torch import cli

    for integrator in ("direct", "wavefront"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["proc:table", "--width", "640", "--height", "360",
                           "--device", "cuda", "--integrator", integrator,
                           "--viewer-bench", str(VIEWER_FRAMES),
                           "--no-cache", "--bvh-builder", "cpp"])
        line = out.getvalue().strip().splitlines()[-1]
        if rc != 0 or not line.startswith("viewer loop:"):
            raise AssertionError(f"[viewer] {integrator}: {out.getvalue()!r}")
        print(f"[viewer] {line}; {smi}")


def compare_walks(scene, meta, cscene, cmeta, rays, b1, device,
                  smi: str) -> None:
    """Phase 18d on phase 3's sponza rays: the packet (128 rays a packet)
    and per-ray walks, closest and any-hit, and closest_hit_trail's t and
    prim, each against B1's (t and occlusion bitwise, prim but at a true
    tie, printed); the packet walk on sponza's cluster table (tc 128), which
    walks per ray, bitwise the per-ray walk of the MT table and its prims
    B4's (but where B4's triangle hits at t within 1e-6 relative, printed).
    The queries launch no kernel. Each timed (host clock around a
    synchronized run) beside B1's."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops.debug import closest_hit_trail
    from gpupathtracer_tpu_torch.ops.intersect import mt_intersect
    from gpupathtracer_tpu_torch.ops.traverse import (trace_closest,
                                                      trace_occluded)

    o, d, t_occ, on = rays
    n = o.shape[0]
    far = torch.full((n,), 1e20, device=device)
    every = torch.ones(n, dtype=torch.bool, device=device)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              packet_size=128)
    out, ms = {}, {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[key] = fn()
        torch.cuda.synchronize()
        ms[key] = 1e3 * (time.perf_counter() - t0)

    def queries():
        for mode in ("packet", "perray"):
            timed(mode, lambda: trace_closest(scene, o, d, far, on,
                                              traversal=mode, **kw))
            timed(mode + "_occ", lambda: trace_occluded(
                scene, o, d, t_occ, on, traversal=mode, **kw))
        timed("trail", lambda: closest_hit_trail(
            scene, o, d, far, stack_depth=meta.stack_depth,
            leaf_size=meta.leaf_size))
        timed("cluster", lambda: trace_closest(cscene, o, d, far, on,
                                               traversal="packet", **kw))
        timed("cluster_occ", lambda: trace_occluded(
            cscene, o, d, t_occ, on, traversal="packet", **kw))

    _drive("packet and per-ray queries", (), queries)
    ties = {}
    for mode in ("packet", "perray"):
        ties[mode] = _order_diff(f"[sponza {mode}] closest against B1's",
                                 out[mode], b1["closest"], scene.tri_geom, o,
                                 d)
        same = out[mode].prim == b1["closest"][1]
        for k in (2, 3):
            if not torch.equal(_bits(out[mode][k])[same],
                               _bits(b1["closest"][k])[same]):
                raise AssertionError(f"[sponza {mode}] u or v differs from "
                                     f"B1's")
        _same_occluded(f"[sponza {mode}] occluded against B1's",
                       out[mode + "_occ"], b1["occ"])
    b1_all = kt.closest(scene.node_rows, o, d, far, every,
                        stack_depth=meta.stack_depth,
                        leaf_size=meta.leaf_size)
    trail = out["trail"]
    ties["trail"] = _order_diff("[sponza trail] t and prim against B1's",
                                (trail.t, trail.prim), b1_all,
                                scene.tri_geom, o, d)
    for k in range(4):
        if not torch.equal(_bits(out["cluster"][k]),
                           _bits(out["perray"][k])):
            raise AssertionError("[sponza cluster] the per-ray fallback is "
                                 "not the MT table's per-ray walk")
    _same_occluded("[sponza cluster] occluded against the per-ray walk's",
                   out["cluster_occ"], out["perray_occ"])
    b4 = kc.closest_cluster(cscene.node_rows, cscene.cluster_rows,
                            cscene.cluster_refs, o, d, far, on,
                            stack_depth=cmeta.stack_depth, arity=cscene.arity)
    torch.cuda.synchronize()
    lanes = (out["cluster"].prim != b4[1]).nonzero().squeeze(1)
    if lanes.numel():
        got = out["cluster"]
        tt, _, _, ok = mt_intersect(scene.tri_geom[b4[1][lanes].long()],
                                    o[lanes], d[lanes])
        near = (tt - got.t[lanes]).abs() <= 1e-6 * got.t[lanes].abs()
        for i in lanes[:8].tolist():
            print(f"[sponza cluster] lane {i}: per-ray prim "
                  f"{int(got.prim[i])} at t {float(got.t[i])!r}, B4's prim "
                  f"{int(b4[1][i])} at t {float(b4[0][i])!r}")
        if not bool((ok & near).all()):
            raise AssertionError("[sponza cluster] a prim differs from B4's "
                                 "where B4's triangle is not at the same t")
    b1_ms = {"closest": _events_ms(lambda: kt.closest(
        scene.node_rows, o, d, far, on, stack_depth=meta.stack_depth,
        leaf_size=meta.leaf_size), 10), "occ": _events_ms(
        lambda: kt.anyhit(scene.node_rows, o, d, t_occ, on,
                          stack_depth=meta.stack_depth,
                          leaf_size=meta.leaf_size), 10)}
    print(f"[sponza walks] {n} rays: packet and per-ray closest t and "
          f"occluded bitwise B1's (another triangle at bitwise the same t in "
          f"{ties['packet']} and {ties['perray']} lanes), the trail's t "
          f"bitwise B1's ({ties['trail']} such lanes), the cluster table's "
          f"per-ray fallback bitwise the MT table's, its prims B4's but in "
          f"{lanes.numel()} lanes; ms (host clock): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
          + f"; B1 closest {b1_ms['closest']:.4f} and any-hit "
          f"{b1_ms['occ']:.4f} ms (CUDA events); {smi}")


def render_walk_films(device, smi: str) -> None:
    """Phase 18e: a proc:bathroom one-sample film at WALK_FILM with
    cfg.traversal "packet" and "perray" (plain torch: no kernel launch),
    each bitwise the default film of the same seed; s/sample of each."""
    import torch

    from gpupathtracer_tpu_torch.render import Renderer
    from gpupathtracer_tpu_torch.scene import load_scene

    cfg = _scene_cfg("bathroom", *WALK_FILM)
    scene, meta = load_scene(cfg, device)
    films, spf = {}, {}

    def film(traversal):
        cfg.traversal = traversal
        r = Renderer(cfg, device, scene=scene, meta=meta)
        t0 = time.perf_counter()
        r.render_frame(sync=True)
        spf[traversal] = time.perf_counter() - t0
        films[traversal] = torch.as_tensor(r.film_hdr()).view(torch.int32)

    film("auto")
    _drive("packet and per-ray films", (),
           lambda: [film(t) for t in ("packet", "perray")])
    for k in ("packet", "perray"):
        differ = int((films[k] != films["auto"]).any(-1).sum())
        if differ:
            raise AssertionError(f"[bathroom {k} film] {differ} pixels differ "
                                 f"from the default film")
    print(f"[bathroom films] {WALK_FILM[0]}x{WALK_FILM[1]}, 1 spp: packet "
          f"and perray bitwise the default film; s/sample: "
          + ", ".join(f"{k} {v:.3f}" for k, v in spf.items()) + f"; {smi}")


# --- phase 19: multi-device rendering on one card ----------------------------

P19_RANKS = 4
# Each run of ranks ends by this deadline (s) or fails the smoke.
P19_DEADLINE = 420
# Phase 19c's compaction-free frame runs every bounce at full width: its
# bounce cap (the Renderer frames keep the config's 64).
P19_FREE_BOUNCES = 8
P19_MEGA_SPP = 4


def _rank_sync(device) -> None:
    """Every rank has finished its enqueued work."""
    import torch
    import torch.distributed as dist

    torch.cuda.synchronize(device)
    dist.barrier()


def _rank_timed(call, device, reps: int) -> list:
    """Host-clock milliseconds of call(), from a barrier to a barrier, reps
    times after a warm-up."""
    call()
    times = []
    for _ in range(reps):
        _rank_sync(device)
        t0 = time.perf_counter()
        call()
        _rank_sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def rank19a(device):
    """Phase 19a, one NCCL rank on the card: every collective of
    parallel/comm.py on CUDA tensors, no host staging; then
    render_sample_sharded over a one-rank mesh, bitwise render_sample_impl
    with fold_in(key, 1311) on bathroom 256x144."""
    import torch

    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.models.wavefront import render_sample_impl
    from gpupathtracer_tpu_torch.parallel import comm
    from gpupathtracer_tpu_torch.parallel.mesh import (make_device_mesh,
                                                       render_sample_sharded)
    from gpupathtracer_tpu_torch.render import Renderer

    if comm.backend() != "nccl" or device.type != "cuda":
        raise AssertionError(f"19a runs NCCL on the card, got "
                             f"{comm.backend()} on {device}")
    x = torch.arange(6, dtype=torch.float32, device=device)
    flags = torch.tensor([True, False], device=device)
    checks = {"psum": (comm.psum(x), x), "pmax": (comm.pmax(x), x),
              "all_gather": (comm.all_gather(x), x[None]),
              "all_to_all": (comm.all_to_all(x.reshape(1, 6)),
                             x.reshape(1, 6)),
              "ring_shift": (comm.ring_shift(x), x),
              "ring_shift bool": (comm.ring_shift((x, flags))[1], flags)}
    for name, (got, want) in checks.items():
        if got.device != device or not torch.equal(got, want):
            raise AssertionError(f"[19a] {name} on one NCCL rank")
    if comm.STAGED["calls"]:
        raise AssertionError("[19a] NCCL staged tensors through the host")
    r = Renderer(_scene_cfg("bathroom", *WALK_FILM, microfacet="beckmann"),
                 device)
    mesh = make_device_mesh((1,))
    key = random.PRNGKey(19, device)
    static = dict(width=r.pad_w, height=r.pad_h,
                  stack_depth=r.meta.stack_depth,
                  leaf_size=r.meta.leaf_size, max_bounces=64,
                  model="beckmann")
    _reset_launches()
    got, rays = render_sample_sharded(mesh, r.scene, r.camera, r.pixel_x,
                                      r.pixel_y, key, **static)
    torch.cuda.synchronize(device)
    counts = {k: v for k, v in _launches().items() if v}
    want, want_rays = render_sample_impl(r.scene, r.camera, r.pixel_x,
                                         r.pixel_y, random.fold_in(key, 1311),
                                         **static)
    if not torch.equal(_bits(got), _bits(want)) or int(rays) != int(
            want_rays) or not float(want.sum()) > 0:
        raise AssertionError("[19a] render_sample_sharded on one NCCL rank "
                             "is not render_sample_impl with the folded key")
    return dict(launches=counts, rays=int(rays), describe=comm.describe(),
                torch=torch.__version__,
                nccl=".".join(map(str, torch.cuda.nccl.version())))


def phase19a(smi: str) -> dict:
    from gpupathtracer_tpu_torch.parallel.launch import run_ranks
    import chip_smoke

    t0 = time.perf_counter()
    out = run_ranks(chip_smoke.rank19a, 1, "nccl", "cuda:0",
                    timeout_s=P19_DEADLINE)[0]
    print(f"[19a] one NCCL rank (torch {out['torch']}, NCCL {out['nccl']}): "
          f"psum, pmax, all_gather, all_to_all, ring_shift on CUDA tensors "
          f"exact, {out['describe']}; render_sample_sharded over a one-rank "
          f"mesh (bathroom {WALK_FILM[0]}x{WALK_FILM[1]}, {out['rays']} "
          f"rays) bitwise render_sample_impl with fold_in(key, 1311); "
          f"{time.perf_counter() - t0:.1f} s with the rank's start; {smi}")
    return out["launches"]


def rank19b(device, part, rays, kw, reps):
    """Phase 19b in each of 4 gloo ranks on cuda:0: phase 3's sponza rays
    through the ring and the routed trace, closest and any-hit, with their
    counters (the launches, the host staging and the host-clock times of
    the runs without counters), and one hop's local B1 launch (the steady
    root, closest and any-hit) against its plain version."""
    import torch
    import torch.distributed as dist

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.parallel import comm
    from gpupathtracer_tpu_torch.parallel.partition import (
        shard_partition, trace_closest_partitioned)

    me, D = dist.get_rank(), dist.get_world_size()
    table, route = shard_partition(part, None, device)
    o, d, t_occ, on = (torch.as_tensor(a, device=device) for a in rays)
    far = torch.full_like(t_occ, 1e20)
    out = {}
    for routing in ("ring", "routed"):
        for any_hit in (False, True):
            def call(stats):
                return trace_closest_partitioned(
                    table, route, o, d, t_occ if any_hit else far, on,
                    any_hit=any_hit, with_stats=stats, routing=routing, **kw)
            _reset_launches()
            comm.reset_staged()
            res, st = call(True)
            torch.cuda.synchronize(device)
            entry = dict(stats=st.cpu().numpy(), staged=dict(comm.STAGED),
                         launches={k: v for k, v in _launches().items()
                                   if v},
                         ms=_rank_timed(lambda: call(False), device, reps))
            if me == 0:
                entry["result"] = (res.cpu() if any_hit
                                   else [x.cpu() for x in res])
            out[f"{routing} {'any-hit' if any_hit else 'closest'}"] = entry
    # One hop's local launch: this rank's shard from its steady root, one
    # start entry a packet, as hops >= 1 run it.
    n = o.shape[0] // D
    sl = slice(me * n, (me + 1) * n)
    K = kw["packet_size"]
    roots = torch.full((-(-n // K),), int(route.steady_root[me]),
                       dtype=torch.int32, device=device)
    depth = dict(stack_depth=kw["stack_depth"], leaf_size=kw["leaf_size"],
                 roots=roots, packet=K)
    args = (o[sl].contiguous(), d[sl].contiguous())
    got = kt.closest(table, *args, far[sl], on[sl], **depth)
    want = kt.closest_plain(table, *args, far[sl], on[sl], **depth)
    occ = kt.anyhit(table, *args, t_occ[sl], on[sl], **depth)
    occ_want = kt.anyhit_plain(table, *args, t_occ[sl], on[sl], **depth)
    _hold_hits(f"[19b] rank {me} hop from the steady root trace_closest",
               got, want)
    _hold_occluded(f"[19b] rank {me} hop from the steady root trace_anyhit",
                   occ, occ_want)
    out["hop"] = dict(rays=n, root=int(route.steady_root[me]),
                      rows=int(table.shape[0]),
                      hits=int((want[1] >= 0).sum()))
    return out


def report19b(res, scene, meta, rays, b1, part, smi: str) -> None:
    """Phase 19b's results (rank19b in each rank): the partitioned trace
    of phase 3's 131,072 sponza rays at D = 4 held to B1 on the whole
    table (t bitwise, prims but at true ties, occlusion equal), the routed
    trace bitwise the ring; V, pops a hop, bytes staged a hop, host-clock
    ms beside B1's whole-table time."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    D = P19_RANKS
    o, d, t_occ, on = rays
    far = torch.full_like(t_occ, 1e20)
    depth = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    whole = {"closest": _events_ms(lambda: kt.closest(
        scene.node_rows, o, d, far, on, **depth), 10),
        "any-hit": _events_ms(lambda: kt.anyhit(
            scene.node_rows, o, d, t_occ, on, **depth), 10)}
    N = o.shape[0]
    print(f"[19b] sponza {scene.node_rows.shape[0]} rows over {D} ranks "
          f"(gloo, every rank on cuda:0): live rows a rank "
          f"{part.num_rows.tolist()}, steady roots "
          f"{part.steady_root.tolist()}")
    for key in ("ring closest", "ring any-hit", "routed closest",
                "routed any-hit"):
        r0 = res[0][key]
        query = key.split()[1]
        if query == "closest":
            got = [x.to(o.device) for x in r0["result"]]
            ties = _hold_to_b1(f"[19b] {key}", got, b1["closest"])
            held = (f"t bitwise B1's whole-table hits, {ties} lanes with "
                    f"another triangle at bitwise the same t")
        else:
            got = r0["result"].to(o.device)
            if not torch.equal(got, b1["occ"]):
                raise AssertionError(f"[19b] {key}: occlusion differs from "
                                     f"B1's in {int((got != b1['occ']).sum())}"
                                     f" lanes")
            held = "occlusion equal to B1's"
        launches = {}
        for r in res:
            _add(launches, r[key]["launches"])
        st = r0["stats"]
        ms = [float(np.median(r[key]["ms"])) for r in res]
        staged = r0["staged"]
        if key.startswith("ring"):
            routed, pops = st[:, 0], st[:, 2]
            counters = (f"V {routed.sum() / N:.3f} of {D} hops a ray, "
                        f"improved {st[:, 1].sum() / N:.3f} a ray, pops a hop "
                        f"{pops.sum() / D:.0f} (max rank a hop "
                        f"{pops.max(0).tolist()}), per-rank routed "
                        f"{routed.sum(1).tolist()}")
            hops = D
        else:
            used = int(max(np.nonzero(st[:, 0].sum(0) + st[:, 1].sum(0))[0],
                           default=0))
            if st[:, 3, -1].sum():
                raise AssertionError(f"[19b] {key}: {int(st[:, 3, -1].sum())}"
                                     f" rays undelivered")
            counters = (f"pops a ray {st[:, 0].sum() / N:.3f}, rounds used "
                        f"{used} of {st.shape[2] - 1}, transported a ray "
                        f"{st[:, 1].sum() / N:.3f}, per-round pops "
                        f"{st[:, 0].sum(0).tolist()}")
            hops = max(used, 1)
        print(f"[19b] {key}: {held}; {counters}; {ms[0]:.2f} ms host clock "
              f"(median of 3, rank 0; ranks {[round(m, 2) for m in ms]}) "
              f"against B1 whole-table {whole[query]:.3f} ms; staged "
              f"through the host {staged['bytes']} bytes in "
              f"{staged['calls']} copies a rank ({staged['bytes'] / hops:.0f}"
              f" a hop or round); launches {launches}")
    for query in ("closest", "any-hit"):
        a, b = res[0][f"ring {query}"]["result"], \
            res[0][f"routed {query}"]["result"]
        for x, y in zip(a if query == "closest" else [a],
                        b if query == "closest" else [b]):
            if not torch.equal(_bits(x), _bits(y)):
                raise AssertionError(f"[19b] routed {query} is not the "
                                     f"ring's bitwise")
    hops = [r["hop"] for r in res]
    print(f"[19b] the routed trace bitwise the ring, closest and any-hit; "
          f"one hop's local B1 launch from each rank's steady root "
          f"(trace_closest_roots, trace_anyhit_roots; {hops[0]['rays']} rays "
          f"a rank, roots {[h['root'] for h in hops]}, rows "
          f"{[h['rows'] for h in hops]}) bitwise its plain version; {smi}")


def rank19c(device, cache_dir):
    """Phase 19c in each of 4 gloo ranks on cuda:0: sponza 1920x1080, one
    frame of a (2, 2) mesh Renderer and of the 4-rank partition (ring and
    routed), each timed host clock between barriers with its launches; the
    ring's frame against this rank's whole-table render with the same key
    and loop conditions; then a compaction-free partitioned frame against
    this rank's whole-table render with the same folded key."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.bvh.partition import build_partition
    from gpupathtracer_tpu_torch.models.wavefront import render_sample_impl
    from gpupathtracer_tpu_torch.parallel import comm
    from gpupathtracer_tpu_torch.parallel.mesh import (make_device_mesh,
                                                       pixel_shard)
    from gpupathtracer_tpu_torch.parallel.partition import (
        render_sample_partitioned, shard_partition, strip_scene_bvh)
    from gpupathtracer_tpu_torch.render import Renderer
    from gpupathtracer_tpu_torch.scene import load_scene

    me = dist.get_rank()
    out, films = {}, {}

    def frame(label, **kw):
        cfg = _scene_cfg("sponza", 1920, 1080, cache_enabled=True,
                         cache_dir=cache_dir, **kw)
        r = Renderer(cfg, device)
        _rank_sync(device)
        _reset_launches()
        comm.reset_staged()
        t0 = time.perf_counter()
        r.render_frame(sync=True)
        _rank_sync(device)
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in _launches().items() if v}
        staged = dict(comm.STAGED)
        film = r.film_hdr()
        r.stats.finalize()
        films[label] = film
        out[label] = dict(s=secs, launches=counts, staged=staged,
                          spf=r.samples_per_frame, rays=r.stats.rays_traced,
                          finite=bool(np.isfinite(film).all()),
                          mean=float(film.mean()),
                          bounces=cfg.max_bounces)
        return r

    frame("mesh (2, 2)", mesh_shape=(2, 2))
    r = frame("partition ring", partition_chips=P19_RANKS)
    frame("partition routed", partition_chips=P19_RANKS,
          partition_routing="routed")
    out["ring = routed"] = int((films["partition ring"]
                                != films["partition routed"]).any(-1).sum())

    cfg = _scene_cfg("sponza", 1920, 1080, cache_enabled=True,
                     cache_dir=cache_dir)
    scene, meta = load_scene(cfg, device)
    # The ring's frame: the whole table, the Renderer's frame key folded by
    # this rank's chips index, the same collective loop conditions.
    sl = r.shard
    phases = []
    _rank_sync(device)
    t0 = time.perf_counter()
    want, _ = render_sample_impl(
        scene, r.camera, r.pixel_x[sl], r.pixel_y[sl],
        random.fold_in(random.fold_in(r.base_key, 0), me + 7177),
        partition_group=r.mesh.groups["chips"], phases=phases,
        packet_size=r.packet_size, **r.sharded_statics())
    _rank_sync(device)
    out["compacted"] = dict(
        differ=int((r.accum != want).any(-1).sum()),
        lanes=int(want.shape[0]), s=time.perf_counter() - t0,
        phases=phases, nonzero=bool(float(want.sum()) > 0))

    mesh = make_device_mesh((P19_RANKS,), ("chips",))
    part = build_partition(scene.node_rows.cpu().numpy(),
                           scene.child_bounds.shape[0], P19_RANKS)
    table, route = shard_partition(part, mesh.groups["chips"], device)
    key = random.PRNGKey(1919, device)
    static = dict(width=r.pad_w, height=r.pad_h,
                  max_bounces=P19_FREE_BOUNCES,
                  stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
                  compaction=False)
    _rank_sync(device)
    _reset_launches()
    t0 = time.perf_counter()
    got, rays = render_sample_partitioned(
        mesh, table, route, strip_scene_bvh(scene), r.camera, r.pixel_x,
        r.pixel_y, key, packet_size=r.packet_size, **static)
    _rank_sync(device)
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in _launches().items() if v}
    sl = pixel_shard(mesh, r.n_rays, "chips")
    t0 = time.perf_counter()
    want, _ = render_sample_impl(scene, r.camera, r.pixel_x[sl],
                                 r.pixel_y[sl],
                                 random.fold_in(key, me + 7177), **static)
    torch.cuda.synchronize(device)
    out["whole"] = dict(
        differ=int((_bits(got) != _bits(want)).any(-1).sum()),
        lanes=int(got.shape[0]), s=secs,
        whole_s=time.perf_counter() - t0, launches=counts, rays=int(rays),
        nonzero=bool(float(want.sum()) > 0))
    return out


def report19c(res, one_s: float, smi: str) -> dict:
    """Phase 19c's results (rank19c in each rank): the films and launches
    held, the frames' seconds beside ``one_s``, one process's frame;
    returns the partition path's B1 launches, summed over the ranks."""
    path = {}
    for label in ("mesh (2, 2)", "partition ring", "partition routed"):
        r0 = res[0][label]
        launches = {}
        for r in res:
            _add(launches, r[label]["launches"])
        want = ({"trace_closest", "trace_anyhit"} if label.startswith("mesh")
                else {"trace_closest", "trace_anyhit", "trace_closest_roots",
                      "trace_anyhit_roots"})
        if set(launches) != want or not r0["finite"] or not r0["mean"] > 0:
            raise AssertionError(f"[19c] {label}: launches {launches}, film "
                                 f"finite {r0['finite']}, mean {r0['mean']}")
        if label.startswith("partition"):
            _add(path, launches)
        print(f"[19c] sponza 1920x1080 {label}: {r0['spf']} sample(s) a "
              f"frame of {r0['bounces']} bounces, {r0['s']:.3f} s host "
              f"clock (one process: {one_s:.3f} s a sample), {r0['rays']} "
              f"rays, film mean "
              f"{r0['mean']:.5f}; staged {r0['staged']['bytes']} bytes in "
              f"{r0['staged']['calls']} copies (rank 0); launches "
              f"{launches}; {smi}")
    if res[0]["ring = routed"]:
        raise AssertionError(f"[19c] the routed film differs from the "
                             f"ring's in {res[0]['ring = routed']} pixels")
    for key, what in (("compacted", "the ring's frame (compaction on)"),
                      ("whole", f"a compaction-free partitioned frame "
                                f"({P19_FREE_BOUNCES} bounces)")):
        differ = sum(r[key]["differ"] for r in res)
        lanes = sum(r[key]["lanes"] for r in res)
        if differ or not all(r[key]["nonzero"] for r in res):
            raise AssertionError(f"[19c] {what}: {differ} of {lanes} lanes "
                                 f"differ from each rank's whole-table "
                                 f"render with the same key (or it is "
                                 f"black)")
    phases = [r["compacted"]["phases"] for r in res]
    if any(p != phases[0] for p in phases) or len(phases[0]) < 2:
        raise AssertionError(f"[19c] the ranks' compaction phases {phases}")
    c, w = res[0]["compacted"], res[0]["whole"]
    print(f"[19c] the partition ring's and routed films bitwise; the ring's "
          f"frame bitwise each rank's whole-table render with the same key "
          f"and loop conditions ({c['s']:.3f} s on rank 0), every rank "
          f"through the phases (width, first bounce) {phases[0]}; a "
          f"compaction-free partitioned frame ({P19_FREE_BOUNCES} bounces, "
          f"{w['s']:.3f} s host clock, launches {w['launches']} on rank 0) "
          f"bitwise each rank's whole-table render with the same folded "
          f"key ({w['whole_s']:.3f} s on rank 0); "
          f"{sum(r['whole']['lanes'] for r in res)} lanes each; {smi}")
    return path


def rank19d(device, spp):
    """Phase 19d in each of 4 gloo ranks on cuda:0: bathroom 256x144
    through render_sample_mega_sharded on a (2, 2) mesh: 2 samples ranks
    x spp samples, every pixel on every rank."""
    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.parallel.mesh import (
        make_device_mesh, render_sample_mega_sharded)
    from gpupathtracer_tpu_torch.render import Renderer

    r = Renderer(_scene_cfg("bathroom", *WALK_FILM, microfacet="beckmann",
                            megakernel="on"), device)
    mesh = make_device_mesh((2, 2))
    _reset_launches()
    c, rays = render_sample_mega_sharded(
        mesh, r.scene, r.mega_tables, r.camera, r.pixel_x, r.pixel_y,
        random.PRNGKey(1923, device), spp_per_chip=spp,
        **r.mega_statics("wavefront"))
    return dict(c=c.cpu(), rays=int(rays),
                launches={k: v for k, v in _launches().items() if v})


def check19d(res, device, smi: str) -> dict:
    """Phase 19d's results (rank19d in each rank): the megakernel's sample
    axis, 2 samples ranks x P19_MEGA_SPP samples, bitwise the sum of this
    process's megakernel calls with the keys folded by the samples index
    and sample indices 0 and spp; returns its launches."""
    import torch

    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.ops.megakernel import render_sample_mega
    from gpupathtracer_tpu_torch.render import Renderer

    r = Renderer(_scene_cfg("bathroom", *WALK_FILM, microfacet="beckmann",
                            megakernel="on"), device)
    want, rays = None, 0
    for s in range(2):
        c, n = render_sample_mega(
            r.scene, r.mega_tables, r.camera, r.pixel_x, r.pixel_y,
            random.fold_in(random.PRNGKey(1923, device), s),
            sample_idx=s * P19_MEGA_SPP, spp=P19_MEGA_SPP,
            **r.mega_statics("wavefront"))
        want = c if want is None else want + c
        rays += int(n)
    for i, out in enumerate(res):
        if (not torch.equal(_bits(out["c"].to(device)), _bits(want))
                or out["rays"] != rays
                or set(out["launches"]) != {"trace_mega"}):
            raise AssertionError(f"[19d] rank {i}: the sharded megakernel is "
                                 f"not the sum of the single-rank calls "
                                 f"(rays {out['rays']} against {rays}, "
                                 f"launches {out['launches']})")
    launches = {}
    for out in res:
        _add(launches, out["launches"])
    print(f"[19d] bathroom {WALK_FILM[0]}x{WALK_FILM[1]} through "
          f"render_sample_mega_sharded on a (2, 2) mesh of gloo ranks, 2 "
          f"samples ranks x {P19_MEGA_SPP} samples: bitwise the sum of the single-rank calls, {rays} rays, "
          f"launches {launches}; {smi}")
    return launches


def rank19(device, part, rays, kw, reps, cache_dir, spp):
    """Phases 19b, 19c and 19d in each of 4 gloo ranks on cuda:0, one
    start of the ranks for the three; the seconds of each."""
    out = {}
    for name, fn, args in (("b", rank19b, (part, rays, kw, reps)),
                           ("c", rank19c, (cache_dir,)),
                           ("d", rank19d, (spp,))):
        _rank_sync(device)
        t0 = time.perf_counter()
        out[name] = fn(device, *args)
        _rank_sync(device)
        out[name + " s"] = time.perf_counter() - t0
    return out


def run_phase19(p19, tmp: str, device, smi: str, stamp) -> list:
    """Phases 19a-d; the B1 and megakernel launches of their paths (the
    one-rank mesh, the partition frames, the megakernel's sample axis),
    summed over the ranks. The ranks read sponza from the disk cache in
    ``tmp`` (phase 18b's)."""
    from gpupathtracer_tpu_torch.bvh.partition import build_partition
    from gpupathtracer_tpu_torch.parallel.launch import run_ranks
    from gpupathtracer_tpu_torch.render import Renderer
    import chip_smoke

    paths = [phase19a(smi)]
    stamp("phase 19a")
    scene, meta, rays, b1 = p19
    cache_dir = os.path.join(tmp, "scene_cache")
    one = Renderer(_scene_cfg("sponza", 1920, 1080, cache_enabled=True,
                              cache_dir=cache_dir),
                   device)
    t0 = time.perf_counter()
    one.render_frame(sync=True)
    one_s = time.perf_counter() - t0
    del one
    t0 = time.perf_counter()
    part = build_partition(scene.node_rows.cpu().numpy(),
                           scene.child_bounds.shape[0], P19_RANKS)
    print(f"[19b] build_partition of sponza at D = {P19_RANKS}: "
          f"{time.perf_counter() - t0:.2f} s")
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              packet_size=2048)
    res = run_ranks(chip_smoke.rank19, P19_RANKS, "gloo", "cuda:0", args=(
        part, tuple(x.cpu().numpy() for x in rays), kw, 3, cache_dir,
        P19_MEGA_SPP), timeout_s=P19_DEADLINE)
    report19b([r["b"] for r in res], scene, meta, rays, b1, part, smi)
    paths.append(report19c([r["c"] for r in res], one_s, smi))
    paths.append(check19d([r["d"] for r in res], device, smi))
    print(f"[19] the ranks' seconds (rank 0, barrier to barrier): 19b "
          f"{res[0]['b s']:.1f}, 19c {res[0]['c s']:.1f}, 19d "
          f"{res[0]['d s']:.1f}")
    stamp("phases 19b-d")
    return paths


def phase19_alone(device, smi: str, stamp) -> int:
    """``python3 chip_smoke.py --phase19``: the kernels phase 19 runs
    (csrc/traverse.cu, csrc/megakernel.cu), phase 3's sponza rays and B1's
    whole-table hits on them, then phases 19a-d alone; no kernels line and
    no result line (a check of phase 19, not the smoke)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from gpupathtracer_tpu_torch.ops import cuda_build
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.scene import load_scene

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(cuda_build.build, ("traverse", "megakernel")))
    stamp("build (phase 19's kernels)")
    cfg = _scene_cfg("sponza", 1920, 1080)
    scene, meta = load_scene(cfg, device)
    rays = _test_rays(scene, meta, cfg, device)
    o, d, t_occ, on = rays
    far = torch.full_like(t_occ, 1e20)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    b1 = {"closest": kt.closest(scene.node_rows, o, d, far, on, **kw),
          "occ": kt.anyhit(scene.node_rows, o, d, t_occ, on, **kw)}
    with tempfile.TemporaryDirectory() as tmp:
        paths = run_phase19((scene, meta, rays, b1), tmp, device, smi, stamp)
    print(f"[smoke] phase 19 alone: launches of its paths {paths}")
    return 0


# --- phase 20: the image decoders (C6) -------------------------------------------

FIXTURES = os.path.join(ROOT, "tests", "golden", "images")
TOWN_MAPS = ("checker", "bricks", "roof", "foliage")
# Phase 20a's fixtures (the JPEGs of slice 18); phase 21a decodes the rest.
PHASE20_FIXTURES = ("bricks", "checker", "foliage", "grey", "map1024", "roof",
                    "sky")


def _host_cpu() -> str:
    """lscpu's model name and the machine's architecture."""
    import platform

    out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    for line in out.splitlines():
        if line.startswith("Model name:"):
            return f"{line.split(':', 1)[1].strip()} ({platform.machine()})"
    return f"CPU model not reported ({platform.machine()})"


def decode_fixtures(smi: str) -> None:
    """Phase 20a: the JPEG decoder's build, then every fixture decoded
    bitwise its PNG twin and the manifest's pixel sha256, with host times
    (median of 5 decodes after one warm-up)."""
    import hashlib
    import statistics

    from gpupathtracer_tpu_torch.utils import io, jpeg

    t0 = time.perf_counter()
    jpeg._load()
    print(f"[20a] the JPEG decoder's library loaded in "
          f"{time.perf_counter() - t0:.2f} s (g++ at first use; the smoke "
          f"builds it in phase 2)")
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    cpu = _host_cpu()
    for name in PHASE20_FIXTURES:
        entry = manifest[name]
        with open(os.path.join(FIXTURES, entry["file"]), "rb") as f:
            jpg = f.read()
        with open(os.path.join(FIXTURES, entry["png"]), "rb") as f:
            png = f.read()
        times = {}
        for label, fn in (("jpeg", lambda: jpeg.decode_jpeg(jpg, name)),
                          ("png", lambda: io.decode_png(png, name))):
            out = fn()
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            times[label] = (out, statistics.median(ts) * 1e3)
        got, twin = times["jpeg"][0], times["png"][0]
        if (got.shape != (entry["height"], entry["width"], 3)
                or got.tobytes() != twin.tobytes()
                or hashlib.sha256(got.tobytes()).hexdigest()
                != entry["pixels_sha256"]):
            raise AssertionError(f"[20a] {name}: the JPEG decode is not its "
                                 f"PNG twin")
        ms = times["jpeg"][1]
        mpix = entry["height"] * entry["width"] / 1e6
        print(f"[20a] {name} {entry['width']}x{entry['height']} "
              f"{entry['encoding']}: bitwise its PNG twin; JPEG decode "
              f"{ms:.3f} ms ({mpix / (ms / 1e3):.1f} MPix/s), PNG twin "
              f"{times['png'][1]:.3f} ms; host {cpu}; {smi}")


def _twin_folders(tmp: str, town: str):
    """Two copies of the town's folder, the .mtl on the JPEG fixtures in
    one and on their PNG twins in the other; their OBJ paths."""
    import shutil

    paths = []
    for ext in ("jpg", "png"):
        folder = os.path.join(tmp, f"town_{ext}")
        os.makedirs(folder, exist_ok=True)
        shutil.copy(town, folder)
        for name in TOWN_MAPS:
            shutil.copy(os.path.join(FIXTURES, f"{name}.{ext}"), folder)
        with open(os.path.join(os.path.dirname(town), "town.mtl")) as f:
            mtl = f.read()
        with open(os.path.join(folder, "town.mtl"), "w") as f:
            f.write(mtl.replace(".png", f".{ext}"))
        paths.append(os.path.join(folder, os.path.basename(town)))
    return paths


def render_decoder_path(tmp: str, town: str, smi: str) -> None:
    """Phases 20b and 20c: the town on its JPEG maps and on their PNG
    twins, bunny under the JPEG sky and under its PNG twin, each pair of
    films bitwise equal."""
    import numpy as np

    jpg_town, png_town = _twin_folders(tmp, town)
    runs = {}
    for ext, path in (("jpg", jpg_town), ("png", png_town)):
        runs[f"town_{ext}"] = ([path, "--width", "1280", "--height", "720",
                                "--mip-levels", "4", *TOWN_CAMERA], 1)
        runs[f"bunny_sky_{ext}"] = (["proc:bunny", "--width", "1280",
                                     "--height", "720", "--skybox",
                                     os.path.join(FIXTURES, f"sky.{ext}")], 1)
    t0 = time.perf_counter()
    stats = render_main_path(tmp, runs)
    for pair in ("town", "bunny_sky"):
        a = np.load(os.path.join(tmp, f"{pair}_jpg.npy"))
        b = np.load(os.path.join(tmp, f"{pair}_png.npy"))
        if a.tobytes() != b.tobytes():
            raise AssertionError(f"[20] the {pair} film on JPEG images is "
                                 f"not bitwise its film on the PNG twins")
        print(f"[20] {pair}: the film on the JPEG images bitwise the film on "
              f"their PNG twins ({stats[pair + '_jpg']['triangles']} "
              f"triangles)")
    print(f"[20b-c] four CLI renders: {time.perf_counter() - t0:.1f} s")
    _spp_line(stats, smi)


def phase20_alone(device, smi: str, stamp) -> int:
    """``python3 chip_smoke.py --phase20``: csrc/traverse.cu, then phase
    20 alone; no kernels line and no result line (a check of phase 20, not
    the smoke)."""
    from gpupathtracer_tpu_torch.ops import cuda_build
    from gpupathtracer_tpu_torch.scene.samplegen import \
        generate_textured_town

    cuda_build.build("traverse")
    stamp("build (phase 20's kernel)")
    decode_fixtures(smi)
    with tempfile.TemporaryDirectory() as tmp:
        town = generate_textured_town(os.path.join(tmp, "town"))
        paths = _drive("image decoder path", ("trace_closest",
                                              "trace_anyhit"),
                       lambda: render_decoder_path(tmp, town, smi))
    stamp("phase 20")
    print(f"[smoke] phase 20 alone: launches of its path {paths}")
    return 0


# --- phase 21: the image formats beside JPEG (C6) ----------------------------

# The town's maps as lossless re-encodings of phase 20's PNG twins.
TOWN_FORMATS = {"checker": "tif", "bricks": "psd", "roof": "dds",
                "foliage": "bmp"}


def hold_fixtures(tag: str, names, smi: str, repeats: int = 5) -> None:
    """Each named fixture of tests/golden/images decoded (the format as
    PIL's Image.open picks it) bitwise its PNG twin and the manifest's
    pixel sha256, with host times (median of ``repeats`` decodes after
    one warm-up)."""
    import hashlib
    import statistics

    from gpupathtracer_tpu_torch.utils import io

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    cpu = _host_cpu()
    if not names:
        raise AssertionError(f"[{tag}] no fixtures")
    for name in names:
        entry = manifest[name]
        with open(os.path.join(FIXTURES, entry["file"]), "rb") as f:
            data = f.read()
        with open(os.path.join(FIXTURES, entry["png"]), "rb") as f:
            png = f.read()
        times = {}
        for label, fn in (("file", lambda: io.decode_image(data, name)),
                          ("png", lambda: io.decode_png(png, name))):
            out = fn()
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            times[label] = (out, statistics.median(ts) * 1e3)
        got, twin = times["file"][0], times["png"][0]
        if (got.shape != (entry["height"], entry["width"], 3)
                or got.tobytes() != twin.tobytes()
                or hashlib.sha256(got.tobytes()).hexdigest()
                != entry["pixels_sha256"]):
            raise AssertionError(f"[{tag}] {name}: the {entry['format']} "
                                 f"decode is not its PNG twin")
        ms = times["file"][1]
        mpix = entry["height"] * entry["width"] / 1e6
        print(f"[{tag}] {name} {entry['format']} {entry['width']}x"
              f"{entry['height']} ({entry['encoding']}): bitwise its PNG "
              f"twin; decode {ms:.3f} ms ({mpix / (ms / 1e3):.1f} MPix/s), "
              f"PNG twin {times['png'][1]:.3f} ms; host {cpu}; {smi}")


def _fixtures_of(formats) -> list:
    """The manifest's fixtures beside phase 20's and phase 23's JPEGs,
    phase 25's TIFFs and phase 27's JPEG 2000 files whose format is in
    ``formats`` (None: every format but WebP, phase 24's simple formats and
    phase 26's JPEG 2000 and ICNS)."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    return sorted(n for n, e in manifest.items()
                  if n not in PHASE20_FIXTURES + PHASE23_FIXTURES
                  + PHASE25_FIXTURES and not _phase27_fixture(n)
                  and (e["format"] in formats if formats
                       else e["format"] not in ("WEBP",) + PHASE24_FORMATS
                       + PHASE26_FORMATS))


def decode_formats(smi: str) -> None:
    """Phase 21a: the codecs library's load, then every fixture phases
    20a, 22a (WebP), 23a and 24a (the simple formats) do not decode,
    bitwise its PNG twin."""
    from gpupathtracer_tpu_torch.utils import codecs

    t0 = time.perf_counter()
    codecs._load()
    print(f"[21a] the codecs library loaded in {time.perf_counter() - t0:.2f}"
          f" s (g++ at first use; the smoke builds it in phase 2)")
    hold_fixtures("21a", _fixtures_of(None), smi)


def render_town_maps(tmp: str, town: str, smi: str, tag: str,
                     exts: dict, label: str = None) -> None:
    """The town with each map ``name`` replaced by the fixture
    ``name.ext`` (or by the fixture file an ``exts`` value names; each
    decodes to its map's PNG twin), bitwise phase 20b's film on the PNG
    twins (that film rendered here when phase 20 did not run in this
    process)."""
    import shutil

    import numpy as np

    folder = os.path.join(tmp, f"town_{tag}")
    os.makedirs(folder, exist_ok=True)
    shutil.copy(town, folder)
    with open(os.path.join(os.path.dirname(town), "town.mtl")) as f:
        mtl = f.read()
    for name, ext in exts.items():
        fname = ext if "." in ext else f"{name}.{ext}"
        shutil.copy(os.path.join(FIXTURES, fname), folder)
        mtl = mtl.replace(f"{name}.png", fname)
    with open(os.path.join(folder, "town.mtl"), "w") as f:
        f.write(mtl)
    args = ["--width", "1280", "--height", "720", "--mip-levels", "4",
            *TOWN_CAMERA]
    runs = {f"town_{tag}": ([os.path.join(folder, os.path.basename(town)),
                             *args], 1)}
    twin = os.path.join(tmp, "town_png.npy")
    if not os.path.exists(twin):
        _, png_town = _twin_folders(tmp, town)
        runs["town_png"] = ([png_town, *args], 1)
    t0 = time.perf_counter()
    stats = render_main_path(tmp, runs)
    a = np.load(os.path.join(tmp, f"town_{tag}.npy"))
    b = np.load(twin)
    maps = " / ".join(sorted(set(exts.values())))
    if any("." in v for v in exts.values()):
        maps = "JPEG " + " / ".join(sorted(set(
            v.split(".")[0].split("_")[-1] for v in exts.values())))
    maps = label or maps
    if a.tobytes() != b.tobytes():
        raise AssertionError(f"[{tag}] the town film on {maps} maps is not "
                             f"bitwise its film on the PNG twins")
    print(f"[{tag}] town: the film on {maps} maps bitwise the film on their "
          f"PNG twins ({stats[f'town_{tag}']['triangles']} triangles); "
          f"{len(runs)} CLI render(s): {time.perf_counter() - t0:.1f} s")
    _spp_line(stats, smi)


def render_formats_path(tmp: str, town: str, smi: str) -> None:
    """Phase 21b: the town on lossless TIFF / PSD / DDS / BMP re-encodings
    of its PNG-twin maps, bitwise phase 20b's film on the PNG twins."""
    render_town_maps(tmp, town, smi, "21b", TOWN_FORMATS)


def _phase_alone(number: int, label: str, decode, render, smi: str,
                 stamp) -> int:
    """``python3 chip_smoke.py --phase<number>``: csrc/traverse.cu, then
    the phase alone (its town also on the PNG twins); no kernels line and
    no result line."""
    from gpupathtracer_tpu_torch.ops import cuda_build
    from gpupathtracer_tpu_torch.scene.samplegen import \
        generate_textured_town

    cuda_build.build("traverse")
    stamp(f"build (phase {number}'s kernel)")
    decode(smi)
    stamp(f"phase {number}a")
    with tempfile.TemporaryDirectory() as tmp:
        town = generate_textured_town(os.path.join(tmp, "town"))
        paths = _drive(label, ("trace_closest", "trace_anyhit"),
                       lambda: render(tmp, town, smi))
    stamp(f"phase {number}")
    print(f"[smoke] phase {number} alone: launches of its path {paths}")
    return 0


def phase21_alone(device, smi: str, stamp) -> int:
    return _phase_alone(21, "image formats path", decode_formats,
                        render_formats_path, smi, stamp)


# --- phase 22: WebP (C6) -----------------------------------------------------

def decode_webp(smi: str) -> None:
    """Phase 22a: the WebP library's load, then every WebP fixture
    (lossless, lossy, lossy RGBA, animated, the simple loop filter, eight
    token partitions) bitwise its PNG twin and the manifest's sha256."""
    from gpupathtracer_tpu_torch.utils import webp

    t0 = time.perf_counter()
    webp._load()
    print(f"[22a] the WebP library loaded in {time.perf_counter() - t0:.2f} "
          f"s (g++ at first use; the smoke builds it in phase 2)")
    hold_fixtures("22a", _fixtures_of(("WEBP",)), smi)


def render_webp_path(tmp: str, town: str, smi: str) -> None:
    """Phase 22b: the town on lossless WebP re-encodings of its PNG-twin
    maps, bitwise phase 20b's film on the PNG twins."""
    render_town_maps(tmp, town, smi, "22b", {k: "webp" for k in TOWN_MAPS})


def phase22_alone(device, smi: str, stamp) -> int:
    return _phase_alone(22, "WebP path", decode_webp, render_webp_path, smi,
                        stamp)


# --- phase 23: the rest of JPEG (C6) -----------------------------------------

# Phase 23a's fixtures (tools/torch_image_fixtures.py jpeg_rest_fixtures).
PHASE23_FIXTURES = (
    "arith_420", "arith_444_dac", "arith_grey", "arith_prog",
    "arith_prog_cut", "bricks_lossless", "checker_arith", "foliage_lossless",
    *(f"lossless_p{p}" for p in range(1, 8)), "nodht", "prog_cut1",
    "prog_cut3", "prog_cut7", "roof_arith", "rst_dropped", "scan_cut")
# The town's maps as the JPEG processes beside Huffman DCT: arithmetic
# transcodes of phase 20's checker and roof JPEGs (their coefficients, so
# their pixels) and lossless encodings of the bricks and foliage twins.
TOWN_JPEG_REST = {"checker": "checker_arith.jpg", "roof": "roof_arith.jpg",
                  "bricks": "bricks_lossless.jpg",
                  "foliage": "foliage_lossless.jpg"}


def decode_jpeg_rest(smi: str) -> None:
    """Phase 23a: the JPEG decoder's load, then every fixture of the fourth
    image slice bitwise its PNG twin and the manifest's sha256."""
    from gpupathtracer_tpu_torch.utils import jpeg

    t0 = time.perf_counter()
    jpeg._load()
    print(f"[23a] the JPEG decoder's library loaded in "
          f"{time.perf_counter() - t0:.2f} s (g++ at first use; the smoke "
          f"builds it in phase 2)")
    hold_fixtures("23a", PHASE23_FIXTURES, smi)


def render_jpeg_rest_path(tmp: str, town: str, smi: str) -> None:
    """Phase 23b: the town on arithmetic-coded and lossless JPEG maps,
    bitwise phase 20b's film on the PNG twins."""
    render_town_maps(tmp, town, smi, "23b", TOWN_JPEG_REST)


def phase23_alone(device, smi: str, stamp) -> int:
    return _phase_alone(23, "JPEG processes path", decode_jpeg_rest,
                        render_jpeg_rest_path, smi, stamp)


# --- phase 24: the simple formats (C6) ---------------------------------------

# PIL's format names of phase 24a's fixtures (tools/torch_image_fixtures.py
# simple_fixtures; PFM files are PIL's PPM).
PHASE24_FORMATS = ("PPM", "QOI", "ICO", "CUR", "SGI", "PCX", "DIB")
# The town's maps as lossless re-encodings of phase 20's PNG twins.
TOWN_SIMPLE = {"checker": "ppm", "bricks": "qoi", "roof": "sgi",
               "foliage": "pcx"}


def decode_simple(smi: str) -> None:
    """Phase 24a: the codecs library's load (QOI, SGI and PCX run-length
    decoders), then every fixture of the simple formats bitwise its PNG
    twin and the manifest's sha256."""
    from gpupathtracer_tpu_torch.utils import codecs

    t0 = time.perf_counter()
    codecs._load()
    print(f"[24a] the codecs library loaded in {time.perf_counter() - t0:.2f}"
          f" s (g++ at first use; the smoke builds it in phase 2)")
    names = _fixtures_of(PHASE24_FORMATS)
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    formats = {manifest[n]["format"] for n in names}
    if formats != set(PHASE24_FORMATS):
        raise AssertionError(f"[24a] fixtures of {sorted(formats)} only")
    hold_fixtures("24a", names, smi)


def render_simple_path(tmp: str, town: str, smi: str) -> None:
    """Phase 24b: the town on PPM / QOI / SGI / PCX re-encodings of its
    PNG-twin maps, bitwise phase 20b's film on the PNG twins."""
    render_town_maps(tmp, town, smi, "24b", TOWN_SIMPLE)


def phase24_alone(device, smi: str, stamp) -> int:
    return _phase_alone(24, "simple formats path", decode_simple,
                        render_simple_path, smi, stamp)


def _counters():
    from gpupathtracer_tpu_torch.ops import dense_intersect as pd
    from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.ops import roofline as rl
    from gpupathtracer_tpu_torch.ops import subpacket_traverse as sp
    return (kt.LAUNCHES, kc.LAUNCHES, mk.LAUNCHES, pd.LAUNCHES, sp.LAUNCHES,
            rl.LAUNCHES)


def _launches() -> dict:
    """Every kernel entry point's launch count since the last reset."""
    out = {}
    for counts in _counters():
        out.update(counts)
    return out


def _reset_launches() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _drive(label: str, want, fn):
    """Sets every launch count to 0, runs fn (one path), reads the counts:
    each entry point in ``want`` must have launched and no other."""
    _reset_launches()
    fn()
    counts = _launches()
    print(f"[{label}] kernel launches: {counts}")
    for k in want:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"the {label} never launched {k}")
    others = {k: v for k, v in counts.items() if k not in want and v}
    if others:
        raise AssertionError(f"the {label} launched {others}")
    return {k: counts[k] for k in want}


def _base_key(key: str):
    """(entry point, arity or None, roots) of a launch key
    (kernel_traverse.launch_key)."""
    import re

    m = re.fullmatch(r"(.*?)(?:_a(\d+))?(_roots)?", key)
    return m.group(1), m.group(2) and int(m.group(2)), bool(m.group(3))


def source_of(key: str) -> str:
    return SOURCES[_base_key(key)[0]]


# --- phase 25: the rest of TIFF (C6) -----------------------------------------

# Phase 25a's fixtures (tools/torch_image_fixtures.py tiff_rest_fixtures).
PHASE25_FIXTURES = (
    "checker_zstd", "bricks_zstd", "roof_zstd", "foliage_zstd", "fax_g3",
    "fax_g4", "fax_mh", "fax_raw16", "fax_t4_2d", "fax_t6_fo2",
    "fax_t6_tiles", "thunderscan", "thunderscan_fo2", "lzw_old",
    "zstd_blocks", "zstd_fo2", "fo2_rgb", "fo2_grey2", "fo2_i16",
    "fo2_palette", *(f"orient{o}" for o in range(2, 9)), "grey12", "int16s",
    "int32s", "uint32", "planar16", "ycbcr22", "ycbcr41", "lab", "lab_psd")
# The town's maps as ZSTD TIFFs of phase 20's PNG twins (predictor 2; roof
# stored transposed under Orientation 6).
TOWN_ZSTD = {"checker": "checker_zstd.tif", "bricks": "bricks_zstd.tif",
             "roof": "roof_zstd.tif", "foliage": "foliage_zstd.tif"}


def decode_tiff_rest(smi: str) -> None:
    """Phase 25a: the CCITT / ThunderScan and ZSTD libraries' loads, then
    every fixture of the sixth image slice bitwise its PNG twin and the
    manifest's sha256."""
    from gpupathtracer_tpu_torch.utils import codecs, zstd

    t0 = time.perf_counter()
    codecs._load_fax()
    zstd._load()
    print(f"[25a] the CCITT / ThunderScan and ZSTD libraries loaded in "
          f"{time.perf_counter() - t0:.2f} s (g++ at first use; the smoke "
          f"builds them in phase 2)")
    hold_fixtures("25a", PHASE25_FIXTURES, smi)


def render_tiff_rest_path(tmp: str, town: str, smi: str) -> None:
    """Phase 25b: the town on ZSTD TIFF maps with predictor 2, one stored
    transposed under an Orientation tag, bitwise phase 20b's film on the
    PNG twins."""
    render_town_maps(tmp, town, smi, "25b", TOWN_ZSTD,
                     label="ZSTD TIFF (predictor 2, one under Orientation 6)")


def phase25_alone(device, smi: str, stamp) -> int:
    return _phase_alone(25, "TIFF rest path", decode_tiff_rest,
                        render_tiff_rest_path, smi, stamp)


# --- phase 26: JPEG 2000 and ICNS (C6) ---------------------------------------

PHASE26_FORMATS = ("JPEG2000", "ICNS")
# The town's maps as lossless 5/3 re-encodings of phase 20's PNG twins; the
# roof through an icon whose JPEG 2000 element PIL picks.
TOWN_JPEG2000 = {"checker": "checker.jp2", "bricks": "bricks.j2k",
                 "roof": "roof.icns", "foliage": "foliage.jp2"}


def decode_jpeg2000(smi: str) -> None:
    """Phase 26a: the JPEG 2000 library's load, then every JPEG 2000 and
    ICNS fixture bitwise its PNG twin and the manifest's sha256."""
    from gpupathtracer_tpu_torch.utils import jpeg2000

    t0 = time.perf_counter()
    jpeg2000._load()
    print(f"[26a] the JPEG 2000 library loaded in "
          f"{time.perf_counter() - t0:.2f} s (g++ at first use; the smoke "
          f"builds it in phase 2)")
    names = _fixtures_of(PHASE26_FORMATS)
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    formats = {manifest[n]["format"] for n in names}
    if formats != set(PHASE26_FORMATS):
        raise AssertionError(f"[26a] fixtures of {sorted(formats)} only")
    hold_fixtures("26a", names, smi, repeats=3)


def render_jpeg2000_path(tmp: str, town: str, smi: str) -> None:
    """Phase 26b: the town on lossless JP2 / J2K maps and an ICNS, bitwise
    phase 20b's film on the PNG twins."""
    render_town_maps(tmp, town, smi, "26b", TOWN_JPEG2000,
                     label="JP2 / J2K / ICNS")


def phase26_alone(device, smi: str, stamp) -> int:
    return _phase_alone(26, "JPEG 2000 path", decode_jpeg2000,
                        render_jpeg2000_path, smi, stamp)


# --- phase 27: HTJ2K, Part 2 transforms, AVIF at open (C6, C9) --------------

# Phase 27a's fixtures (tools/torch_image_fixtures.py jpeg2000_rest_fixtures).
PHASE27_PREFIXES = ("ht_", "mct", "cbd")
# The town's maps as lossless re-encodings of phase 20's PNG twins.
TOWN_HT_MCT = {"checker": "checker_ht.j2k", "bricks": "bricks_mct.j2k",
               "roof": "roof_ht.j2k", "foliage": "foliage_mct.j2k"}
AVIF_SET = os.path.join(ROOT, "tests", "golden", "avif")


def _phase27_fixture(name: str) -> bool:
    return name.startswith(PHASE27_PREFIXES)


def decode_jpeg2000_rest(smi: str) -> None:
    """Phase 27a: every HTJ2K and Part 2 fixture bitwise its PNG twin and
    the manifest's sha256."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        names = sorted(n for n in json.load(f) if _phase27_fixture(n))
    if not any(n.startswith("ht_") for n in names) or not any(
            n.startswith("mct") for n in names):
        raise AssertionError(f"[27a] HTJ2K and Part 2 fixtures expected, "
                             f"got {names}")
    hold_fixtures("27a", names, smi, repeats=3)


def render_jpeg2000_rest_path(tmp: str, town: str, smi: str) -> None:
    """Phase 27b: the town on HTJ2K and Part 2 re-encodings of its
    PNG-twin maps, bitwise phase 20b's film on the PNG twins."""
    render_town_maps(tmp, town, smi, "27b", TOWN_HT_MCT,
                     label="HTJ2K / Part 2 J2K")


def check_avif_set(smi: str) -> None:
    """Phase 27c: each committed AVIF file (PIL-written still, alpha and
    animated files and their cuts and junk) named, refused or passed on
    as the recorded verdicts of PIL's Image.open say, with host ms of the
    parse; the AVIF ones raise NotImplementedError naming the file."""
    import hashlib

    from gpupathtracer_tpu_torch.utils import io
    from gpupathtracer_tpu_torch.utils.identify import identify

    with open(os.path.join(AVIF_SET, "verdicts.json")) as f:
        verdicts = json.load(f)
    cpu = _host_cpu()
    for name, e in sorted(verdicts.items()):
        with open(os.path.join(AVIF_SET, e["file"]), "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != e["sha256"]:
            raise AssertionError(f"[27c] {name}: not the committed file")
        t0 = time.perf_counter()
        try:
            got = identify(data, name)
        except ValueError:
            got = None
        ms = (time.perf_counter() - t0) * 1e3
        if got != e["pil"]:
            raise AssertionError(f"[27c] {name}: the port says {got}, PIL "
                                 f"{e['pil']}")
        if got == "AVIF":
            try:
                io.decode_image(data, e["file"])
            except NotImplementedError as err:
                if e["file"] not in str(err):
                    raise AssertionError(f"[27c] {name}: {err}") from err
            else:
                raise AssertionError(f"[27c] {name}: decoded")
        print(f"[27c] {name} ({len(data)} B): {got or 'refused'} as PIL; "
              f"open {ms:.3f} ms; host {cpu}; {smi}")


def phase27_alone(device, smi: str, stamp) -> int:
    def decode(smi):
        decode_jpeg2000_rest(smi)
        check_avif_set(smi)
    return _phase_alone(27, "JPEG 2000 rest path", decode,
                        render_jpeg2000_rest_path, smi, stamp)


def replaces_of(key: str) -> str:
    base, arity, roots = _base_key(key)
    return REPLACES[base] + (f" (arity={arity})" if arity else "") + (
        " (root_ref: per-packet start entries)" if roots else "")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "gpupathtracer_tpu_torch")):
        print("chip_smoke.py: gpupathtracer_tpu_torch/ is missing; run this "
              "from the root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def stamp(phase):
        print(f"[smoke] {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    if sys.argv[1:] == ["--phase19"]:
        return phase19_alone(device, smi, stamp)
    if sys.argv[1:] == ["--phase20"]:
        return phase20_alone(device, smi, stamp)
    if sys.argv[1:] == ["--phase21"]:
        return phase21_alone(device, smi, stamp)
    if sys.argv[1:] == ["--phase22"]:
        return phase22_alone(device, smi, stamp)
    if sys.argv[1:] == ["--phase23"]:
        return phase23_alone(device, smi, stamp)
    if sys.argv[1:] == ["--phase24"]:
        return phase24_alone(device, smi, stamp)
    if sys.argv[1:] == ["--phase25"]:
        return phase25_alone(device, smi, stamp)
    if sys.argv[1:] == ["--phase26"]:
        return phase26_alone(device, smi, stamp)
    if sys.argv[1:] == ["--phase27"]:
        return phase27_alone(device, smi, stamp)
    build_kernels()
    stamp("build")

    results = {"mega": {}, "roofline": {}}
    results["rates"] = roofline_phase(device, results)
    stamp("phase R")
    scenes, launches = {}, {}
    for name, w, h in (("sponza", 1920, 1080), ("bathroom", 1280, 720)):
        rays, scene, meta, b1 = compare_kernels(name, w, h, device, results)
        scenes[name] = (scene, meta)
        compare_schedules(name, scene, meta, rays, b1, device, results)
        compare_stats(name, scene, meta, rays, b1, device, results)
        compare_dense(name, scene, rays, b1, device, results,
                      n_rays=DENSE_SPONZA_RAYS if name == "sponza" else None)
        if name == "sponza":
            compare_tsort(name, scene, meta, device)
        cluster = compare_cluster(name, w, h, rays, device, results)
        for entry, key, floor in (
                ("trace_cluster_closest", "_cluster_pops",
                 "cluster_pop_ray_ps_tc128"),
                ("trace_cluster_anyhit", "_cluster_pops_anyhit",
                 "cluster_anyhit_pop_ray_ps_tc128")):
            node, cl = results[name + key]
            pop_account(f"B4 {name} {entry} (cluster pops at the tc = 128 "
                        f"body)", results[name + "_cluster"][entry][1], node,
                        cl, results["rates"], floor)
        stamp(f"phases 3-4 on {name}")
        if name == "sponza":
            compare_arity(name, w, h, rays, b1, scene, meta, cluster, device,
                          results)
            stamp(f"phase A on {name}")
            # A check, not a path: its counts are held, not reported.
            _drive("roots check", ROOTS_KEYS, lambda: compare_roots(
                scene, meta, *cluster, rays, device, results))
            treelet_launches = compare_treelet(scene, meta, rays, b1, device)
            stamp("phase T: roots and treelet queries")
            compare_walks(scene, meta, *cluster, rays, b1, device, smi)
            stamp("phase 18d")
            p19 = (scene, meta, rays, b1)
        del rays, b1, cluster
    compare_b1_ties(device)
    compare_cluster_ties(device)
    golden_check(device)

    with tempfile.TemporaryDirectory() as tmp:
        _add(launches, _drive(
            "main path", ("trace_closest", "trace_anyhit"),
            lambda: render_wavefront_path(tmp)))
        stamp("phase 6")
        _add(launches, _drive(
            "16-wide and treelet paths", ("trace_closest", "trace_anyhit",
                                          "trace_closest_a16",
                                          "trace_anyhit_a16",
                                          "trace_closest_roots"),
            lambda: render_treelet_path(tmp, smi)))
        stamp("phase T: renders")
        bench_launches = run_kernel_bench(scenes)
        _add(bench_launches, run_arity_bench())
        del scenes
        profile = _tool_module("torch_mega_profile")
        _drive("mega profile", ("trace_mega", "trace_mega_stats"),
               lambda: profile.main(["--time"]))
        stamp("phase 6b")
        _add(launches, _drive(
            "cluster path", ("trace_cluster_closest", "trace_cluster_anyhit"),
            lambda: render_main_path(tmp, CLUSTER_RUNS)))
        stamp("phase 7")
    bench_quick()
    stamp("phase 7b")

    compare_mega(device, results)
    compare_mega(device, results, cluster_tris=128)
    compare_mega_soups(device, results)
    stamp("phase 8")
    compare_mega_rows(device, results, MEGA_RUNS + MEGACLUSTER_RUNS)
    stamp("phase 9")
    with tempfile.TemporaryDirectory() as tmp:
        _add(launches, _drive(
            "megakernel path", ("trace_mega",),
            lambda: render_mega_path(tmp, MEGA_RUNS, "trace_mega")))
        _add(launches, _drive(
            "megacluster path", ("trace_mega_cluster",),
            lambda: render_mega_path(tmp, MEGACLUSTER_RUNS,
                                     "trace_mega_cluster")))
    stamp("phases 10-11")
    mega_vs_wavefront(device)
    cluster_vs_mt(device)
    stamp("phases 12-13")

    from gpupathtracer_tpu_torch.scene.samplegen import \
        generate_textured_town
    new_paths = []
    with tempfile.TemporaryDirectory() as tmp:
        town = generate_textured_town(os.path.join(tmp, "town"))
        new_paths.append(_drive(
            "reference path", ("trace_closest",),
            lambda: _spp_line(render_main_path(tmp, REFERENCE_RUNS), smi)))
        new_paths.append(_drive(
            "AO path", ("trace_closest", "trace_anyhit"),
            lambda: render_ao_path(tmp, smi)))
        new_paths.append(_drive(
            "textured path", ("trace_closest", "trace_anyhit"),
            lambda: render_town_path(tmp, town, smi)))
        new_paths.append(_drive(
            "sun path", ("trace_closest", "trace_anyhit"),
            lambda: render_sun_path(tmp, device, smi)))
        stamp("phase 14")
        skies = write_skies(tmp)
        new_paths.append(_drive(
            "delta path", ("trace_closest", "trace_anyhit"),
            lambda: render_delta_path(tmp, device, smi)))
        new_paths.append(_drive(
            "glTF path", ("trace_closest", "trace_anyhit"),
            lambda: render_gltf_path(tmp, smi)))
        new_paths.append(_drive(
            "image sky path", ("trace_closest", "trace_anyhit"),
            lambda: render_sky_path(tmp, skies, smi)))
        new_paths.append(_drive(
            "sort_rays and shadow_rev paths", ("trace_closest",
                                               "trace_anyhit"),
            lambda: render_a21_path(tmp, device, smi)))
        new_paths.append(_drive(
            "ld path", ("trace_closest", "trace_anyhit"),
            lambda: render_ld_path(tmp, smi)))
        ld_sequences_on_card(device)
        stamp("phase 17")
        integrator_agreement(device)
        delta_ld_sky_recipes(device, tmp)
        stamp("phase 15")
        card_vs_cpu(device, town, write_mirror_obj(tmp, glass=True),
                    skies[1])
        stamp("phase 16")
        cache_check(tmp, device, smi)
        new_paths.append(_drive(
            "checkpoint path", ("trace_closest", "trace_anyhit"),
            lambda: render_checkpoint_path(tmp, smi)))
        new_paths.append(_drive(
            "viewer path", ("trace_closest", "trace_anyhit"),
            lambda: render_viewer_path(smi)))
        render_walk_films(device, smi)
        stamp("phase 18")
        new_paths += run_phase19(p19, tmp, device, smi, stamp)
        del p19
        decode_fixtures(smi)
        new_paths.append(_drive(
            "image decoder path", ("trace_closest", "trace_anyhit"),
            lambda: render_decoder_path(tmp, town, smi)))
        stamp("phase 20")
        decode_formats(smi)
        new_paths.append(_drive(
            "image formats path", ("trace_closest", "trace_anyhit"),
            lambda: render_formats_path(tmp, town, smi)))
        stamp("phase 21")
        decode_webp(smi)
        new_paths.append(_drive(
            "WebP path", ("trace_closest", "trace_anyhit"),
            lambda: render_webp_path(tmp, town, smi)))
        stamp("phase 22")
        decode_jpeg_rest(smi)
        new_paths.append(_drive(
            "JPEG processes path", ("trace_closest", "trace_anyhit"),
            lambda: render_jpeg_rest_path(tmp, town, smi)))
        stamp("phase 23")
        decode_simple(smi)
        new_paths.append(_drive(
            "simple formats path", ("trace_closest", "trace_anyhit"),
            lambda: render_simple_path(tmp, town, smi)))
        stamp("phase 24")
        decode_tiff_rest(smi)
        new_paths.append(_drive(
            "TIFF rest path", ("trace_closest", "trace_anyhit"),
            lambda: render_tiff_rest_path(tmp, town, smi)))
        stamp("phase 25")
        decode_jpeg2000(smi)
        new_paths.append(_drive(
            "JPEG 2000 path", ("trace_closest", "trace_anyhit"),
            lambda: render_jpeg2000_path(tmp, town, smi)))
        stamp("phase 26")
        decode_jpeg2000_rest(smi)
        new_paths.append(_drive(
            "JPEG 2000 rest path", ("trace_closest", "trace_anyhit"),
            lambda: render_jpeg2000_rest_path(tmp, town, smi)))
        check_avif_set(smi)
        stamp("phase 27")
    # The kernels line counts B1's launches on every path that drives it.
    for counts in new_paths:
        _add(launches, counts)

    kernels = []
    for case, k in (("sponza", "trace_closest"), ("sponza", "trace_anyhit"),
                    ("mega", "trace_mega"),
                    ("sponza_cluster", "trace_cluster_closest"),
                    ("sponza_cluster", "trace_cluster_anyhit"),
                    ("mega", "trace_mega_cluster"),
                    ("bathroom_dense", "dense_closest"),
                    ("bathroom_dense", "dense_anyhit"),
                    ("sponza", "subpacket_closest"),
                    ("sponza", "subpacket_anyhit"),
                    ("sponza", "trace_closest_ilv"),
                    ("sponza", "trace_anyhit_ilv"),
                    ("sponza", "trace_closest_multi"),
                    ("sponza", "trace_anyhit_multi"),
                    *(("roofline", k) for k in results["roofline"]),
                    *((f"sponza_a{a}", k) for a in CARD_ARITIES
                      for k in results[f"sponza_a{a}"]),
                    *(("sponza_roots", k) for k in ROOTS_KEYS[:2])):
        # Launches: of the paths that drive the entry point (the renders
        # for the first six: for B1 the wavefront, reference, AO, textured
        # and sun paths, the delta, glTF, image sky, sort_rays /
        # shadow_rev and ld paths, phase 19's mesh and partition frames,
        # summed over their ranks, phase 20's JPEG-map and JPEG-sky
        # films and their PNG twins, phase 21's town on TIFF / PSD / DDS /
        # BMP maps, phase 22's on WebP maps, phase 23's on arithmetic
        # and lossless JPEG maps, phase 24's on PPM / QOI / SGI / PCX
        # maps, phase 25's on ZSTD TIFF maps, phase 26's on JP2 / J2K /
        # ICNS maps and phase 27's on HTJ2K / Part 2 J2K maps; at arity 16
        # the 16-wide film;
        # with roots the treelet film and the partition frames (any-hit
        # with roots: the partition frames alone); the kernel A/B entry
        # point for the schedules and the arities' B4, run_compact for the
        # probes).
        launches.setdefault(k, bench_launches.get(k, treelet_launches.get(
            k, results["roofline_launches"].get(k, 0))))
        err, ms, plain_ms, bound_ms, bound_by, *lib = results[case][k]
        kernels.append({"name": k, "route": "cuda", "source": source_of(k),
                        "replaces": replaces_of(k), "launches": launches[k],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib[0] if lib else None})
        if launches[k] <= 0:
            raise AssertionError(f"no path launched {k}")
    print(f"[smoke] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
