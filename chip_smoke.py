#!/usr/bin/env python3
"""Chip smoke test of the gsrt_torch port on one NVIDIA GPU.

    python3 chip_smoke.py            # the headline workload, one card

Phases, in order; any failure exits non-zero and prints no result line:

1. device  — needs CUDA; takes one card (the first the caller lets it
             see); prints the card's name and power limit (nvidia-smi)
             and torch's view of it;
2. build   — compiles every kernel of the path from gsrt_torch/csrc with
             nvcc (one process per source, in parallel);
3. capture — renders the main path once with recording wrappers around the
             kernel entry points, to take each kernel's real inputs;
4. expand  — the pair-expansion kernel against its plain PyTorch version on
             those inputs, bit for bit, in both modes (level-1 units and
             level-2 payload emit);
5. blend   — the group stream's partition kernel against its plain
             version on the captured payload, bit for bit (order and
             seg), timed beside a stable torch.sort of the tile ids; the
             group blend kernel against its plain version, every tile,
             atol 2e-3 on color and trans, hits at most 1 apart on at
             most 0.1% of pixels; the share of (warp, pair) steps the
             row cull removes; the kernel's build (registers, spills,
             shared memory, resident blocks, the SASS instructions of its
             per-(pixel, pair) loop where cuobjdump exists) and its
             instruction floor;
6. main    — GaussianRayTracer(cfg, "tiled"): calibrate, then one frame,
             with every launch count set to 0 just before and read just
             after; each kernel of the path must have launched; then
             per-stage and whole-frame times from CUDA events;
7. check   — a small scene through render_tiled (kernels) and render_fast
             (plain PyTorch, the port's oracle), atol 2e-2; then
             projection: 2.96M splats (the 3DGS paper's Mip-NeRF 360
             size), SH 3, the first view of a 1080p orbit round (0, 0, 6):
             the projection kernel against its plain version bit for bit
             on all twelve columns, its ms beside its byte bound and the
             plain version's, its registers and spills (ptxas and the
             runtime), and a tiled frame of that cell launching it once;
8. tiles128x8 — a 1080p frame of the render cell at 128x8 tiles, counts
             read; blend_tiles against its plain version on its binning,
             atol 1e-4; the share of (warp, pair) steps its warp cull
             removes, the build of the instance it runs (registers,
             spills, shared memory, resident blocks), the SASS
             instructions of its per-(pixel, pair) loop where cuobjdump
             exists, and its instruction floor;
9. serve-blend — the serving orbit's first frame: the packed tile-stream
             kernel against its plain version on the compact payload with
             track_consumed, then on the f32 payload, with track_hits, and
             with the exp LUT: atol 2e-3 on color and trans, consumed
             equal, hits equal on f32; per mode the row cull's share, the
             build and the instruction floor; then one frame per mode
             (f32, hits, LUT) through GaussianRayTracer with its launches
             counted;
10. serving — the 48-frame orbit of tools/serving_bench.py: cold
             (GaussianRayTracer, defer_overflow=4) and served
             (ServingRenderer after a warm frame, finish() and reset(),
             counts read): ms/frame on the card's and the host's clocks,
             the speedup, violation frames, re-renders, pairs, one tile
             kernel per served frame and no partition or group kernel;
             the split of a served frame; a 3-frame static camera that
             must cull pairs without violations and stay within 3e-3 of
             the cold render;
11. train-capture — the training workload; one forward and backward of
             render_tiled_diff with the kernel entry points recorded;
12. gather / subtile / backward / lut-train — the f32 stream's kernels
             against their plain versions on the captured inputs:
             expand_pairs (one launch that finds its sources itself, no
             torch.searchsorted; timed also as the kernel alone) and the
             copy-mode expand at the f32 table's rows bit for bit,
             blend_subtiles atol 1e-4 over every tile,
             blend_backward per gradient row, divided by the row's largest
             magnitude, atol 1e-3 over every tile, and bit for bit against
             a second run of itself; both again with the exp LUT; for each
             of the four, as for blend_tiles: the warp cull's share, the
             build, the SASS instructions of one (pixel, pair) step and the
             instruction floor;
13. train  — launch counts to 0, then 1 warm-up and 10 timed
             train_step_tiled steps and one more with
             expand_impl="pallas"; every kernel of the path must have
             launched, the loss must be finite at every step and lower at
             the end, no gradient may be NaN; then where a step's time
             goes, from CUDA events at the stage boundaries; then 2 steps
             with the LUT and 2 at 128x8 tiles, counts read, finite losses;
14. train-check — a small scene where the tiled gradients (kernels) are
             held against render_fast under autograd on the card, each
             divided by its largest magnitude, atol 2e-3;
15. fit    — tools/fit_bench.py's workload through
             gsrt_torch.models.multiview.fit_views: a 40K-splat ground
             truth (random_cloud(40_000, seed=0, extent=2.5,
             scale_range=(0.04, 0.18))), 28 views at 800x600, 50 degrees,
             on two elevation rings, targets from render_fast; 5,000 noisy
             SfM points (default_rng(1)) written as a COLMAP text model
             with the port's writer and read back; holdout 7, a densify
             event every 300 steps up to 75%, max_splats 120,000, an
             opacity reset every 900 steps, SH degree 0, max_pairs 2^20,
             2,000 tiled steps (the targets rendered in chunks of 2,048
             splats, checked on views 0 and 1 against the default 256 to
             1e-5), launch counts to 0 just before the fit and
             read just after; ms/step at the initial and the final N (CUDA
             events over 10 steps), each densify event's card and host ms
             and N before and after, the largest live pair count of a step
             (the buffer of 2^20 may not grow, in the fit or the probes),
             train and holdout PSNR; then one tiled step on the final
             cloud (padding rows included) with its kernels held against
             their plain versions (the copy expand bit for bit, the forward
             atol 1e-4, backward rows 1e-3 of their largest); fails on a
             non-finite loss, a mean loss of the last 100 steps not below
             the first 100's, a first event whose live count does not grow
             or that neither clones nor splits, N above
             round_up_to(max_splats), a holdout PSNR not finite and above
             the initial cloud's, or a kernel that differs from its plain
             version;
16. kbuffer — the paper's k-buffer path: GaussianRayTracer(cfg,
             "reference") on REFERENCE_DEMO's demo scene and on
             random_cloud(20_000, seed=1) at 512x512 (standard conic,
             max_passes 1024, checked above every pixel's passes), each
             held against render_fast on the card (trans rtol 1e-4 / atol
             1e-5, colour rtol 1e-3 / atol 1e-4); launch counts to 0
             around the scale run (plain PyTorch: none may launch);
             ms/frame (CUDA events), passes max and mean, hits, (pixel,
             splat) evaluations a second;
17. splat-trace — the scale run's 262,144 camera rays through
             trace_gaussian_rays and trace_gaussian_rays_clustered
             (clusters of 128, super-clusters of 8, s_max all of them):
             hits equal, trans rtol 1e-5 / atol 1e-6, colour rtol 1e-4 /
             atol 1e-5, no overflow; both times, the passes, the first
             pass's visited share of blocks x super-clusters;
18. mixed  — mirror_in_gaussians(512, 512) path traced (1 sample, 8
             bounces) brute force and clustered (clusters of 8, 4
             super-clusters, blocks of 256 rays), same seed: rtol 5e-3 /
             atol 1e-3 between them, no flag set, the binned cast and
             its binning's copy expand launched once in each (counts to 0
             just before, read just after); the clustered render again
             with unsorted bounce waves, equal to the sorted one bit for
             bit; the cast (Q2.7) and the quad binning's expand (Q2.1) on
             the inputs they took there, against their plain versions bit
             for bit (rows of the kernels line); then
             render_path_traced_calibrated from gauss_s_max 1 must
             report the overflow, grow and end without it; ms/render;
             then the kbuffer phase's 20,000-splat cloud moved round the
             mirror at 128x128, brute force against clustered (clusters
             of 128, super-clusters of 8), same bounds, ms/render;
19. ellipse — the render cell with span_mode="ellipse" (the compact
             tile stream) through GaussianRayTracer: calibrate, one frame
             with counts to 0 just before and read just after (two copy
             expands, one tile blend), no overflow; against the rect tile
             stream (every tile's pairs at most its rect count; colour and
             trans within 2e-3 on the f32 payload, within 1e-2 on the
             compact one, whose rounded conic and opacity let a dropped
             pair clear the alpha threshold: at most 16 entries above
             2e-3, and past 2e-3 the worst pixel must hold such a pair,
             logged with its alpha in f32 and on the payload), both frame
             times and pair totals; the
             two expands (splats -> tile rows, rows -> pairs) bit for bit
             against their plain versions and the tile blend on the
             ellipse payload against its plain version (atol 2e-3), each a
             row of the kernels line;
20. tri-cast — the binned primary cast's kernel against its plain version
             bit for bit (t and triangle ids) on the inputs captured from
             an SH render of soup359k (rect spans, 32x16 tiles), on
             soup359k's exact spans and on bigtris (rect and exact, 16x8
             tiles), each with the share of (warp, pair) steps its warp
             cull removes, its build (registers, spills, shared memory,
             resident blocks), the SASS instructions of a (warp, pair)
             step where cuobjdump exists and the instruction floor; the
             copy-mode expand at the triangle binning's 15-row tables
             (soup359k: rect, and the two of exact spans) against its
             plain version bit for bit; bigtris' binned primary (binning
             + cast) timed as tools/tri_bench.py times it, its launches
             counted;
21. tri-traverse — the packed-cluster traversal kernel's build
             (registers, spills, shared memory, resident blocks, the SASS
             instructions of its per-triangle loop where cuobjdump exists),
             then the kernel against its plain version on soup359k:
             closest hit (t, slots and executed visits equal) on the PT
             render's first bounce wave, as the path hands it over (to the
             per-ray kernel), and on
             the 1080p primary bundle; any hit on the SH render's first
             shadow bundle (hit mask equal, every t a hit of its
             triangle); visits a block executed and planned; the cull
             passes per (warp, cluster) and (block, cluster); the plain
             version again with the TPU kernel's block cull, the rays whose
             result differs counted (closest hit: each a tie at rtol 1e-5;
             any hit: the hit masks equal); bounds by the warp cull's
             tests and the block cull's, and the instruction floor;
22. tri-render — SH, AO and PT on soup359k through
             gsrt_torch.models.path_tracer (primary_impl "auto"), SH with
             exact spans and SH with primary_impl "block": counts set to 0
             just before each and read just after (one cast a render but
             none in "block", the any-hit traversal in SH and AO, the
             closest-hit one in PT and in "block", one expand a rect
             binning and two an exact one; PT's later waves the per-ray
             kernel's), no overflow flag, ms
             per render on the card's and the host's clocks, the mean
             colour; then for SH, AO and PT the split by stage, every
             traversal launch's card ms and visits a block, and the
             profiler's device-busy share;
22b. tri-bvh — bathroom-pt's scene (benchmark/tri_scene.py at its
             configuration's 359,309 triangles, 1920x1080, 16 bounces):
             the table and the per-ray tree built and timed, one frame
             with the per-ray kernel launched once a wave after bounce 0
             and no flag; on the waves of bounces 1 and 8 as the path
             hands them over, the kernel's build (registers, local bytes,
             spills, resident blocks), its ms, nodes and tests a ray (its
             counters), its ms on the wave shuffled, the block walk's ms
             on the same wave (no hit of the tree's farther than its), and
             the plain version (brute force) bit-equal on every 64th ray
             and timed on those rays;
22c. pt-shade — bathroom-pt's scene as in tri-bvh: one frame with the
             shading kernel launched once a wave and no flag; on the waves
             of bounces 1 and 8 as the path hands them to the shading,
             the kernel (csrc/pt_shade.cu) bit-equal to its plain version
             (path_tracer._shade_plain, the same draws) on every ray, its
             ms beside its byte bound, with the draws, and the plain
             version's; its build (registers, spills, resident blocks);
22d. splat-bvh — m360-rt's cloud (benchmark/configs/mipnerf360-rt-1080p
             .json: 2.96M splats, SH 3) and its per-ray tree, built and
             timed; orbit views 0 and 16 of its traffic mix, each a
             1920x1080 frame through GaussianRayTracer(cfg, "traced")
             with launches counted from 0 just before it (one
             csrc/splat_bvh.cu launch a frame); the kernel's ms on that
             frame's rays beside the ms of one walk a pass, registers,
             shared and local (stack) bytes and blocks an SM, walks,
             replayed passes, nodes and tests from its counters, its
             least time
             (benchmark/rt_roofline.py, from the frame's hits); and the
             plain version (trace_gaussian_rays_bvh_plain, brute force)
             on every 1024th ray, timed: hits and passes equal, colour
             and transmittance within 1e-4;
23. scenes — after ellipse: the path tracer's catalog at its factories'
             sizes (RTIOW, planets, the 30-grid cube and cylinder fields
             and the Mandelbulb at 640x480, cube and spheres at 256x256,
             simple at 512x512), PT at 1 spp and 16 bounces with each
             factory's aperture, focus, sky and gamma, each twice with one
             seed and bit-equal, ms, peak memory and launches (only
             simple's binned cast and its expand); render_foveated on
             RTIOW, its outer ring bit-equal to the 1-spp render; the
             1080p foliage field (an OBJ grass card with a procedural
             texture and a blade cutout, 90,000 instances on a 300x300
             grid, RTIOW's ground sphere, the traversal table): PT with
             cutouts, launches counted, sorted bounce waves equal to
             unsorted, every traversal launch (the re-traces with a
             per-ray t_min too) equal to its plain version on every
             4th block (each launch from its own offset), bounce 0's
             first re-trace a row of the kernels line, the rays each trace
             cut, the card split; the field opaque with mips: the binned
             cast and its copy expand against their plain versions (rows),
             the LOD histogram; tri-clusters on 480x270 primary rays
             against the brute-force sweep (t bit-equal, ids equal but at
             ties); the render cell's 1M splats through save_gaussian_ply
             and the native decode (means, SH bit-equal; opacity, Σ 1e-6)
             and one render_tiled frame of them within 2e-2;
24. front-ends — after the triangle phases, each step one in-process
             gsrt_torch.cli.main(argv) with launch counts set to 0 just
             before and read just after: render of random1000000 at
             1080p at the CLI's defaults (f32 payload, --expand-impl
             pallas, the tile stream; its default scale_range) with
             --out, --heatmap, --dump-binary and --stats: Q2.2 and the
             f32 tile blend once a render, the PNG (the port's codec)
             equal to to_uint8 of a direct GaussianRayTracer frame,
             image.binary W·H·7 bytes, ms, Mrays/s, pairs, peak memory;
             compare of that PNG with itself and with a save_png of the
             direct frame (999 dB, SSIM 1.0); orbit at its defaults (24
             frames, 90 degrees, serving) with --stats-out: one tile
             blend a served frame and no group blend, then 2 frames with
             --out-dir, decoded; pt on RTIOW at 640x480 equal to the
             scenes phase's render; bench --primary binned (9 records,
             the cast once a render of the Cornell box) and the lumibench
             suite on a synthetic Bathroom tree of 20,000 soup
             triangles (both traversal modes and the cast); fit on the
             fit phase's capture (its targets written as PNGs) with
             --iters 100 --densify-every 50 --save-ply: Q2.1, Q2.4 and
             Q2.5 every step, PSNRs finite, the PLY read back; train
             (render_fast, no kernel) with a falling loss; the viewer
             from `view`'s arguments (960x540, random100000, port 0):
             "tiled" with its first frame equal to a direct frame, w
             moving the camera, the heatmap, bad input 400, then
             "serving" under a key held 2 s, launches from the render
             thread, stop() raising nothing; last python -m
             gsrt_torch.bench as a subprocess, its one JSON line read,
             beside gsrt_torch.bench.run() in this process. Each step's
             own kernel inputs are held against the plain versions as
             rows of the kernels line (`<kernel>[cli-render]`,
             `[cli-orbit]`, `[cli-bench]`, `[lumibench]`, `[view]`,
             `[view-serving]`): the last call of each wrapper from a
             recorded rerun of the command (from the viewer's own run),
             the expands bit for bit, the blends on every tile, every
             traversal launch on every block; launches from the counted
             run;
25. multi-device — gsrt_torch.parallel on the one card (a mesh of
             repeated cuda:0), each step with launch counts set to 0 just
             before and read just after: the render cell (a) through
             calibrate_sharded and render_data_parallel with
             tiled_render_fn over 4 row slabs of 270 rows (each path
             kernel 4 times, every slab's count_pairs within the buffer),
             (b) through shard_cloud_by_depth and render_splat_sharded on
             a 2x4 mesh, gather and butterfly composites and the
             butterfly with a white background (each path kernel 8
             times), both on the compact payload and on the f32 one (the
             f32 tile stream); each frame against the single-card
             GaussianRayTracer frame: every entry within 2e-2 and at most
             0.1% of the pixels past 2e-3, the worst pixel past it logged
             with the splats taken there on one side only (a slab's own
             tile grid and principal point move pairs at the alpha
             threshold) and the JAX suite's bounds' counts logged beside;
             gather against butterfly rtol 1e-5 / atol 1e-6; ms a frame
             beside the single frame's (one card: the cost of slabbing)
             and peak memory; rows [dp], [sharded] and [dp-f32] hold the
             last shard's kernel inputs against their plain versions; a
             333-splat cloud padded to 336 over 2x4 through the kernels
             (the padding bins no pair); make_train_step_dp over 4 slabs
             against train_step (loss rtol 1e-5, means and SH rtol 1e-4 /
             atol 1e-6, no kernel launched); two ranks spawned on the card
             with backend="gloo" (they load the built kernels and never
             compile), each rendering its row slab through
             render_data_parallel on global_render_mesh(), gather_to_hosts
             and sync_hosts, the frame equal bit for bit to the in-process
             render over 2 slabs, and render_data_parallel_global at 64x32
             against render_fast.

The render workload is the JAX package's benchmark: random_cloud(1M, seed=0,
scale_range=(0.004, 0.03)) at 1920x1080, SH degree 3, RenderConfig defaults.
The serving workload is the same cloud (extent 4.0) seen from orbit_path((0, 0,
6), 10, 48, height=2, degrees=60, start_deg=200) with
RenderConfig(conic_mode="standard") defaults. The training workload is
random_cloud(100K, seed=0) at 800x600, SH degree 3,
RenderConfig(conic_mode="standard") defaults (32x16 tiles), the target its own
tiled render, the start init_params of it with the means moved by 0.02·N(0, 1).
The fit workload is tools/fit_bench.py's (phase 15). The k-buffer
workloads are random_cloud(20_000, seed=1) seen at 512x512 with
RenderConfig(conic_mode="standard") (phases 16-17) and
mirror_in_gaussians(512, 512) (phase 18); phase 19 is the render workload
with ellipse spans.
The triangle workloads are tools/tri_bench.py's generator (centres
U(-2, 2)^3, each vertex its centre + N(0, sd), NumPy default_rng(0)) seen
from look_at((0, 0, -7), (0, 0, 0)) at 55 degrees, 1920x1080: bigtris is
its scene uncut (20,000 triangles, sd 1); soup359k has the bathroom scene's
359,309 triangles (docs/lumibench_r3.json) at sd 0.05, one Lambertian
material (0.73) and the sky, RenderConfig defaults (32x16 tiles), SH with
the light at (0, 4, -4), radius 0.5, 2 shadow rays; AO with 4 rays of
radius 2; PT with 1 sample and 16 bounces.
Before the last line the script prints one JSON object with a row per kernel
(launches, error against the plain version, times, roofline bound) and the
run's wall time; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
EXPAND_SRC = "gsrt_torch/csrc/pair_expand.cu"
BLEND_SRC = "gsrt_torch/csrc/splat_packed.cu"
EXPAND_TPU = "gsrt/ops/pair_expand.py:243"
BLEND_TPU = "gsrt/ops/splat_packed.py:68"
DEVICE = "cuda"
SPLATS, WIDTH, HEIGHT, SEED = 1_000_000, 1920, 1080, 0
FRAMES = 10  # frames per timed run of the whole frame
BLEND_FLOPS_PER_PAIR_PIXEL = 20  # sub x2, response 5, alpha 2, blend 9,
#                                  compare 2; the exp counted as one more

# --- the projection layer at m360-view's size ---
PROJECT_SRC = "gsrt_torch/csrc/project.cu"
TILE_BIN_SRC = "gsrt_torch/csrc/tile_bin.cu"
TILE_BIN_REPS = 20     # binnings a profiled run of the tile-bin rows
# the group stream's launches in a tiled frame on the card, one each
TILE_BIN_KERNELS = ("bin_prep", "bin_gather", "bin_units",
                    "expand_pairs_fused", "expand_pairs_binned")
PROJECT_SPLATS = 2_960_000   # the 3DGS paper's Mip-NeRF 360 scene (Table 1)

# --- the training workload and its kernels (the f32 tile stream) ---
SUBTILE_SRC = "gsrt_torch/csrc/splat_subtile.cu"
GRAD_SRC = "gsrt_torch/csrc/splat_grad.cu"
GATHER_TPU = "gsrt/ops/pair_expand.py:47"
SUBTILE_TPU = "gsrt/ops/splat_subtile.py:49"
GRAD_TPU = "gsrt/ops/splat_grad.py:60"
T_SPLATS, T_WIDTH, T_HEIGHT = 100_000, 800, 600
TRAIN_STEPS, SPLIT_STEPS = 10, 5
# f32 operations per (pixel, pair), counted from the kernels' sources.
# Every pixel of a tile, for every pair the tile blends: offsets 2,
# response 10, exp argument 1, exp 1, opacity 1, clamp 1, tests 2.
TEST_FLOPS = 18
# Forward, where the pixel takes the pair: weight 1, colour 6, trans 2.
FWD_ACCEPT_FLOPS = 9
# Backward, where it took it: alpha, weight 2; prefix colour 6; 1/(1-a) 2;
# d alpha 20; d g 2; mean 10, conic 8, opacity 1, colour 3; trans 2; the
# nine sums over pixels 9.
BWD_ACCEPT_FLOPS = 65
LUT_STEPS, TILES128_STEPS = 2, 2

# --- the fit workload (tools/fit_bench.py): a synthetic posed capture ---
FIT_GT, FIT_EXTENT, FIT_SCALES = 40_000, 2.5, (0.04, 0.18)
FIT_VIEWS, FIT_W, FIT_H, FIT_FOV = 28, 800, 600, 50.0
FIT_SFM, FIT_SFM_NOISE = 5_000, 0.01     # points; noise × extent
FIT_ITERS, FIT_HOLDOUT, FIT_DENSIFY_EVERY = 2_000, 7, 300
FIT_MAX_SPLATS, FIT_RESET_EVERY = 120_000, 900
FIT_MAX_PAIRS = 1 << 20
FIT_PROBE_STEPS = 10    # steps timed at the initial and the final N
FIT_WINDOW = 100        # steps averaged at the start and the end

# --- the serving workload (tools/serving_bench.py) and the tile stream ---
TILES_SRC = "gsrt_torch/csrc/splat_subtile.cu"
TILES_TPU = "gsrt/ops/splat_pallas.py:65"
ORBIT_FRAMES, ORBIT_DEGREES, SPLIT_FRAMES, STATIC_FRAMES = 48, 60.0, 5, 3
# The static-camera check culls at 2x2-tile supertiles, as
# tests/test_serving.py does: at the default 8x8 a supertile culls only
# when all 64 of its tiles hold a finite cutoff, which no supertile of
# this scene does (the orbit's cull drops a few thousand pairs at most).
STATIC_SUPER = 2

# --- the paper's k-buffer path: kbuffer, splat-trace and mixed ---
KB_SPLATS, KB_SEED, KB_W, KB_H = 20_000, 1, 512, 512
KB_MAX_PASSES = 1024    # above every pixel's passes (checked)
TRACE_K, TRACE_SUP, TRACE_RB = 128, 8, 256
# mirror_in_gaussians' 60 splats in clusters of 8 (4 super-clusters of 2):
# blocks of 256 rays enter more than one, so s_max 1 overflows
MIX_W, MIX_H, MIX_BOUNCES, MIX_K, MIX_SUP, MIX_RB = 512, 512, 8, 8, 2, 256
# the 20,000-splat cloud of kbuffer / splat-trace (centre (0, 0, 6))
# moved onto the mirror sphere's centre (0, 1, 0); its view cut to 128x128
MIX_BIG_W, MIX_BIG_H, MIX_BIG_SHIFT = 128, 128, (0.0, 1.0, -6.0)
# entries of the ellipse frame's compact payload more than 2e-3 off the
# rect one's (5 in every run before the bound was set)
ELLIPSE_OVER_MAX = 16
FIT_TARGET_CHUNK = 2048   # splats a chunk of the fit's target renders

# --- the triangle workload and its kernels (Q2.7 cast, Q2.8 traversal) ---
CAST_SRC = "gsrt_torch/csrc/tri_cast.cu"
TRAVERSE_SRC = "gsrt_torch/csrc/tri_kernel.cu"
CAST_TPU = "gsrt/ops/tri_binning.py:357"
TRAVERSE_TPU = "gsrt/ops/tri_kernel.py:266"
BIGTRIS = 20_000        # tools/tri_bench.py's bigtris scene, uncut
SOUP_TRIS = 359_309     # the bathroom scene's count, docs/lumibench_r3.json
SOUP_SD = 0.05          # vertex offsets of soup359k: centre + N(0, 0.05)
LIGHT_POS, LIGHT_RADIUS, AO_RADIUS = (0.0, 4.0, -4.0), 0.5, 2.0
PT_SAMPLES, PT_BOUNCES = 1, 16
RB = 512                # rays a traversal block, closest_hit_packed's default
SMS, LANES = 132, 128   # H100 SXM: SMs, FP32 lanes an SM (4 x 32 issue slots)
# f32 operations per (pixel, pair) of a chunk that is cast, counted from
# tri_cast.cu: pvec 9, det 5, |det| test 1, 1/det 1, u 6, v 6, t 1, the
# seven acceptance tests (u + v among them) 7, the running minimum 2; and
# per pair cast, shared by the tile's pixels: qvec 9, e2 . qvec 5.
CAST_FLOPS, CAST_PAIR_FLOPS = 38, 14
# Per (ray, triangle) of a cluster past the cull, tri_kernel.cu: pvec 9,
# det 5, |det| test 1, 1/det 1, tvec 3, u 6, qvec 9, v 6, t 6, the six
# acceptance tests 6, the running minimum 1.
MT_FLOPS = 53
# Per (ray, cluster) of an executed visit, the slab test: 6 sub, 6 mul,
# 12 min/max, 1 compare.
SLAB_FLOPS = 25
# --- the per-ray tree at bathroom-pt's size (the PT's later waves) ---
BVH_SRC = "gsrt_torch/csrc/tri_bvh.cu"
BVH_CONFIG = "benchmark/configs/bathroom-pt-1080p.json"
BVH_WAVES = (1, 8)        # the bounces whose waves the rows time
BVH_PLAIN_STRIDE = 64     # the plain version holds every 64th ray
# --- the path tracer's wave shading at bathroom-pt's size ---
PT_SHADE_SRC = "gsrt_torch/csrc/pt_shade.cu"
PT_SHADE_WAVES = (1, 8)   # the bounces whose waves the rows time
# a ray's bytes, each read or written once: t, mat, the uniform 4 each,
# hit and active 1 each, normal, origin, direction, throughput, colour
# and unit draw 12 each read; origin, direction, throughput, colour 12
# each and active 1 written
PT_SHADE_RAY_BYTES = 3 * 4 + 2 + 6 * 12 + 4 * 12 + 1
# --- the per-ray splat tree at m360-rt's size (the traced mode) ---
SPLAT_BVH_SRC = "gsrt_torch/csrc/splat_bvh.cu"
SPLAT_BVH_CONFIG = "benchmark/configs/mipnerf360-rt-1080p.json"
SPLAT_BVH_MIX = "benchmark/traffic/orbit-traced.json"
SPLAT_BVH_VIEWS = (0, 16)        # the orbit views whose frames the rows time
SPLAT_BVH_PLAIN_STRIDE = 1024    # the plain version holds every 1024th ray
SPLAT_BVH_PLAIN_PAIRS = 1 << 27  # (ray, splat) pairs a chunk of the plain
SPLAT_BVH_TOL = 1e-4             # colour and transmittance against the plain
# Mean colours of SH, AO and PT on soup359k as the traversal kernel with the
# block cull (commit 8f9a83f) renders them on this card, from
# tools/traverse_ab.py; the warp cull leaves every pixel as it was there.
BLOCK_CULL_MEANS = {"SH": 0.6437165141105652, "AO": 0.6900080442428589,
                    "PT": 0.7811987400054932}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over `reps` calls, between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def render_cell(device: str = DEVICE):
    """The render workload: (cfg, cloud, camera)."""
    from gsrt_torch import RenderConfig
    from gsrt_torch.scene import random_cloud
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, conic_mode="standard")
    cloud, camera = random_cloud(SPLATS, seed=SEED, width=WIDTH,
                                 height=HEIGHT, scale_range=(0.004, 0.03),
                                 device=device)
    return cfg, cloud, camera


def projection_cell(device: str = DEVICE):
    """The projection layer's workload at m360-view's size: (cfg, cloud,
    camera), 2.96M splats of random_cloud's draws at the render cell's
    scales, SH degree 3, RenderConfig defaults, seen from the first view
    of a 1080p orbit round (0, 0, 6) at radius 10, 2 above."""
    from gsrt_torch import RenderConfig
    from gsrt_torch.scene import orbit_path, random_cloud
    cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    cloud, _ = random_cloud(PROJECT_SPLATS, seed=SEED, width=WIDTH,
                            height=HEIGHT, scale_range=(0.004, 0.03),
                            device=device)
    camera = orbit_path((0, 0, 6.0), 10.0, 1, height=2.0, width=WIDTH,
                        height_px=HEIGHT, start_deg=200.0, device=device)[0]
    return cfg, cloud, camera


def serving_orbit(device: str = DEVICE) -> list:
    """The serving workload's cameras (tools/serving_bench.py's orbit)."""
    from gsrt_torch.scene import orbit_path
    return orbit_path((0, 0, 6.0), 10.0, ORBIT_FRAMES, height=2.0,
                      width=WIDTH, height_px=HEIGHT, degrees=ORBIT_DEGREES,
                      start_deg=200.0, device=device)


class Recorder:
    """Wraps a module function, keeping the arguments of every call (of
    the last only with last_only) and the kernel launches each call made
    (`launches`, a dict a call)."""

    def __init__(self, module, name: str, last_only: bool = False):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls, self.launches = [], []
        self.last_only = last_only

    def __enter__(self):
        from gsrt_torch import _kernels

        def wrapped(*args, **kw):
            if self.last_only:
                self.calls.clear()
                self.launches.clear()
            self.calls.append((args, kw))
            before = _kernels.launch_counts()
            out = self.orig(*args, **kw)
            self.launches.append({k: v - before[k] for k, v in
                                  _kernels.launch_counts().items()
                                  if v != before[k]})
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def launched(self, kernel: str) -> int:
        """The launches of `kernel` over the recorded calls."""
        return sum(c.get(kernel, 0) for c in self.launches)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class Replaced:
    """Replaces a module function for the duration of a with-block."""

    def __init__(self, module, name: str, fn):
        self.module, self.name, self.fn = module, name, fn
        self.orig = getattr(module, name)

    def __enter__(self):
        setattr(self.module, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def blend_floor(stats: dict, info: dict, clock_hz,
                pixels_per_lane: int = 1) -> dict:
    """A blend's instruction floor: the (pixel, pair) steps the kernel runs
    after its warp cull (the plain version's counts: warps of 32 lanes,
    `pixels_per_lane` pixels a lane) times the SASS instructions of one
    step, over 132 SMs x 128 lanes at the top SM clock; and the cull's
    share."""
    steps = 32 * pixels_per_lane * (stats["warp_steps"]
                                    - stats["culled_steps"])
    sass = info["sass"]
    floor = (steps * sass["per_test"] / (SMS * LANES * clock_hz) * 1e3
             if sass and clock_hz else None)
    return dict(instruction_floor_ms=floor,
                culled_share=stats["culled_steps"] / stats["warp_steps"],
                pixel_pair_steps=steps)


def phase_device():
    # the run uses one card: the first the caller lets it see
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        "0" if visible is None else visible.split(",")[0]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("phase device: no CUDA device")
    if torch.cuda.device_count() != 1:
        raise SystemExit(f"phase device: {torch.cuda.device_count()} devices "
                         f"visible, the run takes one")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    card = smi.splitlines()[0] if smi else "nvidia-smi unavailable"
    log(card)
    log(f"phase device: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card


def phase_build():
    from gsrt_torch import _kernels
    t0 = time.perf_counter()
    secs = _kernels.build(verbose=True)
    for line in _kernels.build.last_log.splitlines():
        if "registers" in line or "error" in line.lower() or "==" in line:
            log(f"  {line.strip()}")
    log(f"phase build: {time.perf_counter() - t0:.2f} s wall "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})")


def expand_row(name, tpu, kernel_fn, plain_fn, library_fn, launches,
               bytes_moved, phase="expand"):
    import torch
    out_k = kernel_fn()
    out_p = plain_fn()
    torch.cuda.synchronize()
    if out_k.shape != out_p.shape or not torch.equal(out_k, out_p):
        bad = (out_k != out_p).sum().item() if out_k.shape == out_p.shape \
            else "shape"
        raise SystemExit(f"phase {phase}: {name} differs from its plain "
                         f"version ({bad} words)")
    row = dict(name=name, route="cuda", source=EXPAND_SRC, replaces=tpu,
               launches=launches, max_abs_err=0.0,
               ms=time_cuda(kernel_fn, 20), plain_ms=time_cuda(plain_fn, 5),
               bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes",
               library_ms=None if library_fn is None
               else time_cuda(library_fn, 5))
    log(f"phase {phase}: {name} bitwise equal, shape "
        f"{tuple(out_k.shape)}, {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms)")
    return row


class Stamps:
    """CUDA events at the stage boundaries of a training step. `wrap`
    patches a module function so that an event is recorded before and
    after each call; `mark` records one directly. All events go to the
    current stream, so consecutive ones bracket what ran between them."""

    def __init__(self, torch):
        self.torch, self.marks, self.patched = torch, [], []

    def mark(self, label: str) -> None:
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((label, ev))

    def wrap(self, module, name: str, label: str) -> None:
        orig = getattr(module, name)

        def wrapped(*args, **kw):
            self.mark(label + ":start")
            out = orig(*args, **kw)
            self.mark(label + ":end")
            return out
        setattr(module, name, wrapped)
        self.patched.append((module, name, orig))

    def restore(self) -> None:
        for module, name, orig in self.patched:
            setattr(module, name, orig)

    def intervals(self):
        """[(label of the closing mark, ms since the mark before it)]."""
        self.torch.cuda.synchronize()
        return [(b[0], a[1].elapsed_time(b[1]))
                for a, b in zip(self.marks, self.marks[1:])]


# the interval that ends at each mark of an instrumented training step
STEP_STAGES = {
    "binning:start": "project_sh_forward", "binning:end": "binning",
    "blend_forward:start": "binning",          # the overflow check
    "blend_forward:end": "blend_forward", "loss:end": "loss_forward",
    "blend_backward:start": "loss_backward", "blend_backward:end":
    "blend_backward", "routing:start": "routing", "routing:end": "routing",
    "backward:end": "autograd_projection", "step:end": "optimizer"}


def max_abs_err(*diffs) -> float:
    """Largest |entry| over the tensors; NaN if any holds one."""
    errs = [d.abs().max().item() for d in diffs]
    return float("nan") if any(e != e for e in errs) else max(errs)


def normalised_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return ((got - want).abs().max() / want.abs().max()).item()


def train_cell(device: str = DEVICE):
    """The training workload: (cfg, cloud, camera, params, target, pairs
    needed, max_pairs, the generator of the start's noise)."""
    import torch
    from gsrt_torch import RenderConfig
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.models import tiled_diff, trainer
    from gsrt_torch.scene import random_cloud
    cfg = RenderConfig(width=T_WIDTH, height=T_HEIGHT,
                       conic_mode="standard")
    cloud, camera = random_cloud(T_SPLATS, seed=SEED, width=T_WIDTH,
                                 height=T_HEIGHT, device=device)
    params = trainer.init_params(cloud)
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.no_grad():
        params.means += 0.02 * torch.randn(params.means.shape, generator=gen,
                                           device=device)
    # the buffer holds the target's view and the start's, with 10% slack
    need = max(grt.count_pairs_numpy(c, camera, cfg)
               for c in (cloud, params.to_cloud()))
    max_pairs = grt.pair_bucket(int(need * 1.1))
    with torch.no_grad():
        target, _ = tiled_diff.render_tiled_diff(cloud, camera, cfg,
                                                 max_pairs)
    return cfg, cloud, camera, params, target, need, max_pairs, gen


def train_phases(torch):
    """Phases 8-11. Returns (kernel rows, training figures)."""
    from gsrt_torch import RenderConfig, _kernels
    from gsrt_torch.core.types import GaussianCloud
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.models import tiled_diff, trainer
    from gsrt_torch.ops import (pair_expand, splat_grad, splat_subtile,
                                tile_binning)
    from gsrt_torch.scene import random_cloud

    W, H = T_WIDTH, T_HEIGHT
    cfg, cloud, camera, params, target, need, max_pairs, gen = train_cell()
    log(f"phase train-capture: {T_SPLATS} splats, {W}x{H}, SH degree "
        f"{cloud.sh_degree}, tiles {cfg.tile_w}x{cfg.tile_h}, {need} pairs "
        f"needed, max_pairs {max_pairs}")

    # --- capture: one forward + backward with the entry points recorded ---
    with Recorder(pair_expand, "expand_pairs_fused") as rec_fused, \
            Recorder(splat_subtile, "blend_subtiles") as rec_fwd, \
            Recorder(splat_grad, "blend_backward") as rec_bwd:
        trainer.render_loss_tiled(params, target, camera, cfg,
                                  max_pairs).backward()
        torch.cuda.synchronize()
    if not (len(rec_fused.calls) == len(rec_fwd.calls)
            == len(rec_bwd.calls) == 1):
        raise SystemExit("phase train-capture: expected one call per "
                         "kernel entry point")
    (tab, base, mp), _ = rec_fused.calls[0]
    (binning,), fwd_kw = rec_fwd.calls[0]
    (payload, tile_start, pixstate), bwd_kw = rec_bwd.calls[0]
    total = int(binning.total_pairs)
    n_src = tab.shape[1]
    ntx, nty = tile_binning.tile_extent(W, H, cfg.tile_w, cfg.tile_h)
    T, npx = ntx * nty, cfg.tile_w * cfg.tile_h
    log(f"phase train-capture: {total} pairs in {T} tiles of {npx} px, "
        f"table {tuple(tab.shape)}, payload {tuple(payload.shape)}, "
        f"pixstate {tuple(pixstate.shape)}")

    # --- gather: expand_pairs, and the copy mode at the f32 table's rows ---
    rows = []
    expand_bytes = 4 * (tab.shape[0] * (mp + n_src) + n_src)
    rows.append(expand_row(
        "expand_pairs", GATHER_TPU,
        lambda: pair_expand.expand_pairs(tab, base, mp),
        lambda: pair_expand.expand_pairs_plain(tab, base, mp),
        lambda: tab.index_select(1, pair_expand.source_index(base, mp)),
        0, expand_bytes, phase="gather"))
    # one launch, and no torch.searchsorted outside the kernel
    before = _kernels.launch_counts()

    def no_search(*a, **kw):
        raise SystemExit("phase gather: expand_pairs called "
                         "torch.searchsorted")
    with Replaced(torch, "searchsorted", no_search):
        pair_expand.expand_pairs(tab, base, mp)
    after = _kernels.launch_counts()
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    if launched != {"expand_pairs": 1}:
        raise SystemExit(f"phase gather: expand_pairs launched {launched}, "
                         f"not one expand_pairs kernel")
    out = torch.empty((tab.shape[0], mp), dtype=torch.int32, device=DEVICE)
    stream = _kernels.stream_ptr(tab)
    rows[-1]["kernel_ms"] = time_cuda(lambda: _kernels.EXPAND_PAIRS(
        tab.data_ptr(), tab.shape[0], n_src, base.data_ptr(), mp,
        out.data_ptr(), stream), 20)
    del out
    log(f"phase gather: expand_pairs is one launch, no searchsorted; "
        f"kernel alone {rows[-1]['kernel_ms']:.4f} ms")
    rows.append(expand_row(
        "expand_pairs_fused", EXPAND_TPU,
        lambda: pair_expand.expand_pairs_fused(tab, base, mp),
        lambda: pair_expand.expand_pairs_plain(tab, base, mp),
        lambda: tab.index_select(1, pair_expand.source_index(base, mp)),
        0, expand_bytes, phase="gather"))
    rows[-1]["at"] = "the f32 stream's table (training)"
    if not torch.equal(pair_expand.expand_pairs(tab, base, mp),
                       pair_expand.expand_pairs_fused(tab, base, mp)):
        raise SystemExit("phase gather: expand_pairs differs from "
                         "expand_pairs_fused")

    # --- subtile: the forward blend on the captured binning, every tile ---
    stats = {}
    plain_kw = {k: v for k, v in fwd_kw.items() if k != "use_exp_lut"}
    t0 = time.perf_counter()
    color_p, trans_p = splat_subtile.blend_subtiles_plain(
        binning, stats=stats, **plain_kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    color_k, trans_k = splat_subtile.blend_subtiles(binning, **fwd_kw)
    torch.cuda.synchronize()
    err = max_abs_err(color_k - color_p, trans_k - trans_p)
    blended, accepted = stats["pairs_blended"], stats["accepted"]
    log(f"phase subtile: all {T} tiles, max |kernel - plain| {err:.3e} "
        f"(atol 1e-4), {blended} pairs blended of {total}, {accepted} "
        f"(pixel, pair) products accepted of {blended * npx}")
    if not err <= 1e-4:
        raise SystemExit(f"phase subtile: kernel differs from plain by "
                         f"{err}")
    pair_bytes = 4 * (7 * total + tile_start.numel())

    clock_hz = max_sm_clock_hz()

    def blend_row(name, kind, kw, fn, plain_ms, err, accept_flops,
                  other_bytes, work):
        source, tpu = {"subtile": (SUBTILE_SRC, SUBTILE_TPU),
                       "grad": (GRAD_SRC, GRAD_TPU)}[kind]
        t_ops = (TEST_FLOPS * work["pairs_blended"] * npx
                 + accept_flops * work["accepted"]) / F32_FLOPS
        t_bytes = (pair_bytes + other_bytes) / HBM_BYTES_PER_S
        info = f32_kernel_info(kind, kw, cfg.tile_w, cfg.tile_h)
        row = dict(name=name, route="cuda", source=source, replaces=tpu,
                   launches=0, max_abs_err=err, ms=time_cuda(fn, 10),
                   plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library_ms=None,
                   **blend_floor(work, info, clock_hz,
                                 info["pixels_per_thread"]),
                   build=info)
        floor = row["instruction_floor_ms"]
        log(f"phase {name}: warp cull removes {work['culled_steps']} of "
            f"{work['warp_steps']} (warp, pair) steps "
            f"({row['culled_share']:.4f}); build: {describe_build(info)}")
        log(f"phase {name}: kernel {row['ms']:.4f} ms, plain "
            f"{plain_ms:.1f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), instruction floor "
            + (f"{floor:.4f} ms" if floor else "not measured"))
        return row

    rows.append(blend_row(
        "blend_subtiles", "subtile", fwd_kw,
        lambda: splat_subtile.blend_subtiles(binning, **fwd_kw),
        plain_s * 1e3, err, FWD_ACCEPT_FLOPS, 16 * W * H, stats))
    del color_p, trans_p, color_k, trans_k

    # --- backward: on the captured payload and pixel state, every tile ---
    plain_kw = {k: v for k, v in bwd_kw.items() if k != "use_exp_lut"}
    bwd_stats = {}
    t0 = time.perf_counter()
    grad_p = splat_grad.blend_backward_plain(payload, tile_start, pixstate,
                                             stats=bwd_stats, **plain_kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    grad_k = splat_grad.blend_backward(payload, tile_start, pixstate,
                                       **bwd_kw)
    torch.cuda.synchronize()
    errs = [normalised_err(grad_k[r], grad_p[r])
            for r in range(splat_grad.GRAD_ROWS)]
    log(f"phase backward: all {T} tiles, per row max |kernel - plain| / "
        f"max |plain| {', '.join(f'{e:.2e}' for e in errs)} (atol 1e-3)")
    if not all(e <= 1e-3 for e in errs):    # a NaN fails too
        raise SystemExit(f"phase backward: kernel differs from plain: "
                         f"{errs}")
    if not torch.equal(grad_k, splat_grad.blend_backward(
            payload, tile_start, pixstate, **bwd_kw)):
        raise SystemExit("phase backward: two runs of the kernel differ")
    rows.append(blend_row(
        "blend_backward", "grad", bwd_kw,
        lambda: splat_grad.blend_backward(payload, tile_start, pixstate,
                                          **bwd_kw),
        plain_s * 1e3, max(errs), BWD_ACCEPT_FLOPS,
        4 * (pixstate.numel() + splat_grad.GRAD_ROWS * total), bwd_stats))
    del grad_p, grad_k

    # --- lut-train: both kernels with the exp LUT, same inputs ---
    lut = dict(use_exp_lut=True, skip_range_check=False)
    lut_fwd_kw, lut_bwd_kw = {**fwd_kw, **lut}, {**bwd_kw, **lut}
    lut_stats = {}
    t0 = time.perf_counter()
    color_p, trans_p = splat_subtile.blend_subtiles_plain(
        binning, stats=lut_stats, **lut_fwd_kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    color_k, trans_k = splat_subtile.blend_subtiles(binning, **lut_fwd_kw)
    torch.cuda.synchronize()
    err = max_abs_err(color_k - color_p, trans_k - trans_p)
    log(f"phase lut-train: blend_subtiles with the LUT, all {T} tiles, max "
        f"|kernel - plain| {err:.3e} (atol 1e-4), "
        f"{lut_stats['pairs_blended']} pairs blended, "
        f"{lut_stats['accepted']} accepted")
    if not err <= 1e-4:
        raise SystemExit(f"phase lut-train: the LUT forward differs from "
                         f"plain by {err}")
    rows.append(blend_row(
        "blend_subtiles[lut]", "subtile", lut_fwd_kw,
        lambda: splat_subtile.blend_subtiles(binning, **lut_fwd_kw),
        plain_s * 1e3, err, FWD_ACCEPT_FLOPS, 16 * W * H, lut_stats))
    lut_bwd_stats = {}
    t0 = time.perf_counter()
    grad_p = splat_grad.blend_backward_plain(payload, tile_start, pixstate,
                                             stats=lut_bwd_stats,
                                             **lut_bwd_kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    grad_k = splat_grad.blend_backward(payload, tile_start, pixstate,
                                       **lut_bwd_kw)
    torch.cuda.synchronize()
    errs = [normalised_err(grad_k[r], grad_p[r])
            for r in range(splat_grad.GRAD_ROWS)]
    log(f"phase lut-train: blend_backward with the LUT, per row max "
        f"|kernel - plain| / max |plain| "
        f"{', '.join(f'{e:.2e}' for e in errs)} (atol 1e-3)")
    if not all(e <= 1e-3 for e in errs):
        raise SystemExit(f"phase lut-train: the LUT backward differs from "
                         f"plain: {errs}")
    rows.append(blend_row(
        "blend_backward[lut]", "grad", lut_bwd_kw,
        lambda: splat_grad.blend_backward(payload, tile_start, pixstate,
                                          **lut_bwd_kw),
        plain_s * 1e3, max(errs), BWD_ACCEPT_FLOPS,
        4 * (pixstate.numel() + splat_grad.GRAD_ROWS * total),
        lut_bwd_stats))
    del grad_p, grad_k, rec_fused, rec_fwd, rec_bwd, binning, payload
    del pixstate, tab, color_p, trans_p, color_k, trans_k

    # --- train: counts to 0, warm-up + timed steps, counts read ---
    optimizer = trainer.make_optimizer(params)
    step = lambda c: trainer.train_step_tiled(params, optimizer, target,
                                              camera, c, max_pairs, 0.2)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    losses = [step(cfg)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    losses += [step(cfg) for _ in range(TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    losses.append(step(cfg.replace(expand_impl="pallas")))
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    losses = [x.item() for x in losses]
    log(f"phase train: launches {counts}")
    log(f"phase train: losses {', '.join(f'{x:.5f}' for x in losses)}")
    for k in ("expand_pairs_fused", "expand_pairs", "blend_subtiles",
              "blend_backward"):
        if counts[k] <= 0:
            raise SystemExit(f"phase train: kernel {k} never launched")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise SystemExit("phase train: non-finite loss")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"phase train: the loss did not fall: {losses}")
    for name, p in params.named_parameters():
        if not (torch.isfinite(p.grad).all() and torch.isfinite(p).all()):
            raise SystemExit(f"phase train: non-finite {name} or gradient")
    for row in rows:
        row["launches"] = counts.get(row["name"], 0)
    log(f"phase train: {step_ms:.4f} ms/step on the card's clock, "
        f"{host_ms:.4f} ms/step on the host's, over {TRAIN_STEPS} steps")

    # where a step's time goes: events at the stage boundaries
    stamps = Stamps(torch)
    stamps.wrap(tile_binning, "build_tile_binning", "binning")
    stamps.wrap(splat_subtile, "blend_subtiles", "blend_forward")
    stamps.wrap(splat_grad, "blend_backward", "blend_backward")
    stamps.wrap(tiled_diff, "route_pair_grads", "routing")
    try:
        for _ in range(SPLIT_STEPS):
            optimizer.zero_grad(set_to_none=True)
            stamps.mark("step:start")
            loss = trainer.render_loss_tiled(params, target, camera, cfg,
                                             max_pairs, 0.2)
            stamps.mark("loss:end")
            loss.backward()
            stamps.mark("backward:end")
            optimizer.step()
            stamps.mark("step:end")
    finally:
        stamps.restore()
    stages = {}
    for label, ms in stamps.intervals():
        if label != "step:start":
            name = STEP_STAGES[label]
            stages[name] = stages.get(name, 0.0) + ms / SPLIT_STEPS
    for k, v in stages.items():
        log(f"phase train: stage {k} {v:.4f} ms")
    log(f"phase train: stages sum to {sum(stages.values()):.4f} ms/step "
        f"over {SPLIT_STEPS} instrumented steps")
    final_pairs = grt.count_pairs_numpy(params.to_cloud(), camera, cfg)
    log(f"phase train: {final_pairs} pairs after the steps, max_pairs "
        f"{max_pairs}")

    # --- lut-train path: counts to 0, LUT_STEPS steps with the LUT ---
    def steps(c, n):
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        out = [step(c).item() for _ in range(n)]
        torch.cuda.synchronize()
        return out, _kernels.launch_counts()
    lut_losses, counts = steps(cfg.replace(use_exp_lut=True), LUT_STEPS)
    log(f"phase lut-train: {LUT_STEPS} train_step_tiled steps with the LUT, "
        f"losses {', '.join(f'{x:.5f}' for x in lut_losses)}, launches "
        f"{counts}")
    for row in rows:
        if row["name"].endswith("[lut]"):
            row["launches"] = counts[row["name"][:-len("[lut]")]]
            if row["launches"] <= 0:
                raise SystemExit(f"phase lut-train: {row['name']} never "
                                 f"launched")
    if not all(x == x and abs(x) != float("inf") for x in lut_losses):
        raise SystemExit("phase lut-train: non-finite loss")

    # --- tiles128x8 training: the same steps at (128, 8) tiles ---
    cfg128 = cfg.replace(tile_w=128, tile_h=8)
    need128 = max(grt.count_pairs_numpy(c, camera, cfg128)
                  for c in (cloud, params.to_cloud()))
    step = lambda c: trainer.train_step_tiled(
        params, optimizer, target, camera, c,
        grt.pair_bucket(int(need128 * 1.2)), 0.2)
    losses128, counts = steps(cfg128, TILES128_STEPS)
    log(f"phase tiles128x8: {TILES128_STEPS} train_step_tiled steps at "
        f"128x8 tiles, losses {', '.join(f'{x:.5f}' for x in losses128)}, "
        f"launches {counts}")
    if not all(x == x and abs(x) != float("inf") for x in losses128):
        raise SystemExit("phase tiles128x8: non-finite loss")
    if counts["blend_tiles"] != TILES128_STEPS or \
            counts["blend_backward"] != TILES128_STEPS:
        raise SystemExit("phase tiles128x8: blend_tiles and its backward "
                         "must launch once a step")

    # --- train-check: tiled gradients against render_fast autograd ---
    sw, sh = 128, 96
    small = RenderConfig(width=sw, height=sh, conic_mode="standard")
    sc, scam = random_cloud(2_000, seed=1, width=sw, height=sh,
                            device=DEVICE)
    wc = torch.randn((sh, sw, 3), generator=gen, device=DEVICE)
    wt = torch.randn((sh, sw), generator=gen, device=DEVICE)

    def grads(render):
        leaf = GaussianCloud(*(t.clone().requires_grad_() for t in sc))
        color, trans = render(leaf)
        ((color * wc).sum() + (trans * wt).sum()).backward()
        return [t.grad for t in leaf]

    def fast(c):
        out = grt.render_fast(c, scam, small)
        return out.color, out.trans
    g_tiled = grads(lambda c: tiled_diff.render_tiled_diff(c, scam, small,
                                                           1 << 16))
    g_fast = grads(fast)
    torch.cuda.synchronize()
    errs = {n: normalised_err(a, b)
            for n, a, b in zip(sc._fields, g_tiled, g_fast)}
    log(f"phase train-check: 2000 splats {sw}x{sh}, tiled gradients vs "
        f"render_fast autograd, normalised: "
        f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (atol 2e-3)")
    if not all(e <= 2e-3 for e in errs.values()):
        raise SystemExit(f"phase train-check: gradients differ: {errs}")
    return rows, dict(
        step_ms=step_ms, step_host_ms=host_ms, stages_ms=stages,
        losses=losses, splats=T_SPLATS, width=W, height=H, pairs=total,
        pairs_blended=blended, accepted=accepted, max_pairs=max_pairs,
        lut_losses=lut_losses, losses_128x8=losses128)


def serve_phases(torch, cloud, rows):
    """serve-blend, serving and the tile stream's modes (see the module
    docstring). Appends the K1 rows to `rows`; returns the serving
    figures."""
    from gsrt_torch import RenderConfig, _kernels
    from gsrt_torch import serving as srv_mod
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.ops import splat_packed, tile_binning

    W, H = WIDTH, HEIGHT
    cfg = RenderConfig(width=W, height=H, conic_mode="standard")
    path = serving_orbit()
    cam0 = path[0]
    ntx, nty = tile_binning.tile_extent(W, H, cfg.tile_w, cfg.tile_h)
    T, npx = ntx * nty, cfg.tile_w * cfg.tile_h
    max_pairs = grt.pair_bucket(int(grt.count_pairs_numpy(
        cloud, cam0, cfg) * 1.1))

    # --- serve-blend: K1 on the serving frame's two payloads ---
    def capture(c):
        with Recorder(splat_packed, "blend_packed") as rec:
            grt.render_tiled(cloud, cam0, c, max_pairs=max_pairs,
                             serving=True)
            torch.cuda.synchronize()
        (binning,), kw = rec.calls[0]
        return binning, kw
    compact_b, serve_kw = capture(cfg)
    f32_b, _ = capture(cfg.replace(payload="f32"))
    total = int(compact_b.total_pairs)
    shown = {k: serve_kw[k] for k in ("bs", "chunk", "skip_range_check")}
    log(f"phase serve-blend: frame 0 of the orbit, {total} pairs in {T} "
        f"tiles, max_pairs {max_pairs}, blend {shown}")
    plain_keys = ("width", "height", "sub_w", "sub_h", "bs", "chunk",
                  "g_cutoff", "alpha_threshold", "alpha_clamp", "term_eps",
                  "skip_range_check", "use_exp_lut")
    base_kw = {k: serve_kw[k] for k in plain_keys if k in serve_kw}
    modes = [("blend_packed_tile", compact_b, {}),
             ("blend_packed_tile[f32]", f32_b, {}),
             ("blend_packed_tile[hits]", f32_b, dict(track_hits=True)),
             ("blend_packed_tile[lut]", compact_b,
              dict(use_exp_lut=True, skip_range_check=False))]
    k1_rows = {}
    clock_hz = max_sm_clock_hz()
    for name, b, extra in modes:
        kw = {**base_kw, **extra}
        hits = kw.pop("track_hits", False)
        stats = {}
        t0 = time.perf_counter()
        cp, tp, consp, hp = splat_packed.blend_packed_tile_plain(
            b, stats=stats, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        run = lambda: splat_packed.blend_packed(
            b, group_stream=False, track_consumed=True, track_hits=hits,
            **kw)
        out = run()
        torch.cuda.synchronize()
        ck, tk, consk = out[:3]
        err = max_abs_err(ck - cp, tk - tp)
        cons_ok = torch.equal(consk, consp)
        compact = b.payload.shape[0] == tile_binning.COMPACT_WIDTH
        msg = ""
        if hits:
            d = (out[3] - hp).abs()
            hits_ok = d.max().item() == 0 if not compact else \
                d.max().item() <= 1 and (d != 0).float().mean().item() <= 1e-3
            msg = f", hits differ at {(d != 0).sum().item()} px"
        else:
            hits_ok = True
        blended = stats["pairs_blended"]
        sat = consp.reshape(-1)[:T]
        log(f"phase serve-blend: {name}: max |kernel - plain| {err:.3e} "
            f"(atol 2e-3), consumed equal {cons_ok}{msg}, {blended} pairs "
            f"blended of {int(b.total_pairs)}, saturated tiles "
            f"{int((sat < sat.max()).sum())}")
        if not (err <= 2e-3 and cons_ok and hits_ok):
            raise SystemExit(f"phase serve-blend: {name} differs from its "
                             f"plain version")
        t_ops = BLEND_FLOPS_PER_PAIR_PIXEL * npx * blended / F32_FLOPS
        t_bytes = (4 * (b.payload.shape[0] * blended + T + 1 + consp.numel())
                   + (20 if hits else 16) * W * H) / HBM_BYTES_PER_S
        info = blend_kernel_info("tile" if compact else "tile_f32", kw, npx)
        k1_rows[name] = dict(
            name=name, route="cuda", source=BLEND_SRC, replaces=BLEND_TPU,
            launches=0, max_abs_err=err, ms=time_cuda(run, 10),
            plain_ms=plain_s * 1e3, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, **blend_floor(stats, info, clock_hz),
            build=info)
        floor = k1_rows[name]["instruction_floor_ms"]
        log(f"phase serve-blend: {name}: row cull removes "
            f"{stats['culled_steps']} of {stats['warp_steps']} (warp, pair) "
            f"steps ({k1_rows[name]['culled_share']:.4f}); build: "
            f"{describe_build(info)}")
        log(f"phase serve-blend: {name}: kernel {k1_rows[name]['ms']:.4f} "
            f"ms, plain {plain_s * 1e3:.1f} ms, bound "
            f"{k1_rows[name]['bound_ms']:.4f} ms "
            f"({k1_rows[name]['bound_by']}), instruction floor "
            + (f"{floor:.4f} ms" if floor else "not measured"))
        del cp, tp, consp, hp, out, ck, tk, consk
    del compact_b, f32_b

    # --- serving: the cold orbit, then the served one (counts read) ---
    cold = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE,
                                 defer_overflow=4)
    cold_first = cold(cloud, cam0)              # calibrate + warm
    torch.cuda.synchronize()

    def run_path(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        outs = [fn(cam) for cam in path]
        ev[1].record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / len(path)
        return outs, ev[0].elapsed_time(ev[1]) / len(path), host
    _, cold_ms, cold_host = run_path(lambda cam: cold(cloud, cam))
    srv = srv_mod.ServingRenderer(cfg, device=DEVICE)
    srv(cloud, cam0)                            # calibrate + warm cutoffs
    srv.finish()
    srv.reset()
    _kernels.reset_launch_counts()
    _, served_ms, served_host = run_path(lambda cam: srv(cloud, cam))
    srv.finish()
    counts = _kernels.launch_counts()
    st = srv.stats[-len(path):]
    viol = sum(x["violations"] > 0 for x in st)
    rerender = sum(x["full_renders"] for x in st)
    log(f"phase serving: {ORBIT_FRAMES}-frame orbit over {ORBIT_DEGREES} "
        f"degrees; cold {cold_ms:.4f} ms/frame (card) {cold_host:.4f} "
        f"(host), served {served_ms:.4f} ms/frame (card) {served_host:.4f} "
        f"(host), speedup {cold_ms / served_ms:.3f}; violation frames "
        f"{viol}, full re-renders {rerender}; pairs first {st[0]['pairs']} "
        f"last {st[-1]['pairs']}; cull on {sum(x['cull'] for x in st)} "
        f"frames")
    log(f"phase serving: launches {counts} "
        f"({counts['blend_packed_tile'] / len(path):.3f} K1 per frame)")
    if counts["blend_packed_tile"] != len(path) + rerender or \
            counts["blend_packed_group"] != 0 or \
            counts["partition_group_stream"] != 0:
        raise SystemExit("phase serving: expected one tile-stream blend "
                         "per served frame (and per re-render) and no "
                         "group-stream partition or blend")
    for k in ("expand_pairs_fused",):
        if counts[k] <= 0:
            raise SystemExit(f"phase serving: kernel {k} never launched")
    k1_rows["blend_packed_tile"]["launches"] = counts["blend_packed_tile"]

    # where a served frame's time goes (depth 1: the host read is in it)
    split = srv_mod.ServingRenderer(cfg, device=DEVICE, pipeline_depth=1)
    for cam in path[:2]:
        split(cloud, cam)                       # calibrate, warm the cull
    split.finish()
    stamps = Stamps(torch)
    stamps.wrap(grt, "_precompute", "project")
    stamps.wrap(tile_binning, "build_tile_binning", "binning")
    stamps.wrap(tile_binning, "cutoff_cull", "cull")
    stamps.wrap(splat_packed, "blend_packed", "blend")
    stamps.wrap(srv_mod, "update_cutoff_map", "cutoff")
    read_ms = []
    drain = split._drain_one

    def timed_drain():
        t0 = time.perf_counter()
        out = drain()
        read_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    split._drain_one = timed_drain
    try:
        for cam in path[2:2 + SPLIT_FRAMES]:
            stamps.mark("frame:start")
            split(cloud, cam)
            stamps.mark("frame:end")
    finally:
        stamps.restore()
        split._drain_one = drain
    serve_split = {}
    names = {"project:end": "project_sh", "binning:start": "extents",
             "cull:start": "binning", "cull:end": "cull",
             "binning:end": "binning", "blend:end": "blend",
             "cutoff:end": "cutoff_update"}
    for label, ms in stamps.intervals():
        if label != "frame:start":
            name = names.get(label, "other")
            serve_split[name] = serve_split.get(name, 0.0) + \
                ms / SPLIT_FRAMES
    serve_split["host_read_host_ms"] = sum(read_ms) / SPLIT_FRAMES
    log("phase serving: split of a served frame (card ms, mean of "
        f"{SPLIT_FRAMES}; the host read on the host's clock): " +
        ", ".join(f"{k} {v:.4f}" for k, v in serve_split.items()))

    # --- static camera: converges with culled pairs, no violations ---
    static = srv_mod.ServingRenderer(cfg.replace(serving_super=STATIC_SUPER),
                                     device=DEVICE, pipeline_depth=1)
    outs = [static(cloud, cam0) for _ in range(STATIC_FRAMES)]
    static.finish()
    ss = static.stats
    diffs = [max_abs_err(o.color - cold_first.color,
                         o.trans - cold_first.trans) for o in outs]
    log(f"phase serving: static camera ({STATIC_SUPER}x{STATIC_SUPER}-tile "
        f"supertiles), pairs "
        f"{[x['pairs'] for x in ss]}, violations "
        f"{[x['violations'] for x in ss]}, max |frame - cold| "
        f"{', '.join(f'{d:.3e}' for d in diffs)} (atol 3e-3)")
    if any(x["violations"] for x in ss) or not ss[-1]["pairs"] < \
            ss[0]["pairs"] or not all(d <= 3e-3 for d in diffs):
        raise SystemExit("phase serving: the static camera did not "
                         "converge")

    # --- the tile stream's modes on the main path: counts per mode ---
    for name, c in (("blend_packed_tile[f32]",
                     cfg.replace(payload="f32", stream="tile")),
                    ("blend_packed_tile[hits]",
                     cfg.replace(stream="tile", payload="f32",
                                 exact_hits=True)),
                    ("blend_packed_tile[lut]",
                     cfg.replace(stream="tile", use_exp_lut=True))):
        tr = grt.GaussianRayTracer(c, "tiled", device=DEVICE)
        tr.calibrate(cloud, cam0)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        out = tr(cloud, cam0)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        if counts["blend_packed_tile"] <= 0 or not \
                torch.isfinite(out.color).all():
            raise SystemExit(f"phase serve-blend: {name} path did not run "
                             f"the tile kernel")
        k1_rows[name]["launches"] = counts["blend_packed_tile"]
        log(f"phase serve-blend: {name} path, launches {counts}")
    rows += list(k1_rows.values())
    return dict(cold_ms=cold_ms, cold_host_ms=cold_host, served_ms=served_ms,
                served_host_ms=served_host, speedup=cold_ms / served_ms,
                violation_frames=viol, full_rerenders=rerender,
                pairs_first=st[0]["pairs"], pairs_last=st[-1]["pairs"],
                split_ms=serve_split,
                static_pairs=[x["pairs"] for x in ss])


def ptxas_report(log: str, lib: str, entry: str) -> dict:
    """Registers and spilled bytes (stores + loads) that `nvcc -Xptxas -v`
    printed for the entry functions of `lib` whose mangled names hold
    `entry` (`_kernels.build.last_log`): {mangled name: {...}}."""
    import re
    out, section, name = {}, None, None
    for line in log.splitlines():
        if line.startswith("== ") and line.endswith(" =="):
            section, name = line.strip("= "), None
        elif section != lib:
            continue
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and entry in name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out.setdefault(name, {})["spill_bytes"] = int(m[1]) + int(m[2])
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(name, {})["registers"] = int(m[1])
    return out


def projection_phase(torch, rows) -> dict:
    """The projection kernel at m360-view's size: its twelve columns
    against the plain version bit for bit, its ms beside its byte bound
    and the plain version's, its build (ptxas and the runtime's view),
    and one tiled frame of the cell that must launch it once."""
    from gsrt_torch import _kernels
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.ops import project
    t0 = time.perf_counter()
    cfg, cloud, camera = projection_cell()
    torch.cuda.synchronize()
    n, k = cloud.n, cloud.sh.shape[1]
    log(f"phase projection: {n} splats, SH degree {cloud.sh_degree} ({k} "
        f"rows), {WIDTH}x{HEIGHT}, made in {time.perf_counter() - t0:.1f} s")
    kernel = lambda: project.project_splats(cloud, camera, cfg)  # noqa: E731
    plain = lambda: project.project_splats_plain(cloud, camera, cfg)  # noqa
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t  # noqa
    differ = {f: int((bits(g) != bits(w)).sum())
              for f, g, w in zip(project.SplatColumns._fields, got, want)}
    if any(differ.values()):
        raise SystemExit(f"phase projection: the kernel differs from its "
                         f"plain version: {differ}")
    alive = int(got.alive.sum())
    del got, want
    # each input byte read once, each output byte written once
    bytes_moved = n * (4 * (3 + 6 + 1 + 3 * k) + 4 * 11 + 1)
    ms = time_cuda(kernel, 20)
    plain_ms = time_cuda(plain, 3)
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    deg = min(cfg.sh_degree, cloud.sh_degree)
    std = int(cfg.conic_mode == "standard")
    info = build_info("project", "gsrt_project_info", deg, std, k)
    info.update(threads=128)
    staged = int(deg == 3 and k == 16)
    ptxas = ptxas_report(_kernels.build.last_log, "project",
                         f"project_kernelILi{deg}ELb{std}ELi{staged}EE")
    tracer = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)
    tracer.calibrate(cloud, camera)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    out = tracer(cloud, camera)
    torch.cuda.synchronize()
    counts = {c: v for c, v in _kernels.launch_counts().items() if v}
    if counts.get("project_splats") != 1 or bool(out.overflow):
        raise SystemExit(f"phase projection: a tiled frame launched "
                         f"{counts} (want project_splats once), overflow "
                         f"{bool(out.overflow)}")
    frame_ms = time_cuda(lambda: tracer(cloud, camera), FRAMES)
    rows.append(dict(
        name="project_splats", route="cuda", source=PROJECT_SRC,
        replaces=None, launches=counts["project_splats"], max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
        library_ms=None, bytes=bytes_moved, splats=n, alive=alive,
        build=info, ptxas=ptxas))
    log(f"phase projection: twelve columns bitwise equal to the plain "
        f"version ({alive} alive); kernel {ms:.4f} ms, bound {bound_ms:.4f}"
        f" ms ({bytes_moved / n:.0f} B a splat, {bound_ms / ms:.1%} of "
        f"it), plain {plain_ms:.3f} ms; build {info['registers']} registers, "
        f"{info['spill_bytes']} B local a thread, "
        f"{info['static_smem_bytes']} B shared, {info['blocks_per_sm']} "
        f"blocks of 128 an SM; "
        f"ptxas {ptxas or 'not in the build log'}; a tiled frame launches "
        f"{counts}, {frame_ms:.3f} ms")
    return dict(ms=ms, bound_ms=bound_ms, plain_ms=plain_ms,
                frame_ms=frame_ms, launches=counts, ptxas=ptxas)


def device_ops(torch, fn, reps: int) -> dict:
    """The device's own events (kernels, copies, fills) of one call of fn,
    averaged over `reps` calls under torch.profiler: {name: (count, ms)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / reps, e.self_device_time_total / 1e3 / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


def tile_bin_phase(torch, rows) -> dict:
    """The group stream's binning kernels (csrc/tile_bin.cu) at m360-view's
    size, on the inputs of a recorded tiled frame: the kernel route against
    the plain route bit for bit on every TileBinning field, each kernel's
    launches in that frame (counted from 0; each of TILE_BIN_KERNELS
    exactly once, else it exits), its device ms beside its byte bound, the
    route's and the plain route's ms, and the device operations one
    binning of each launches."""
    from gsrt_torch import _kernels
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.ops import tile_binning
    t0 = time.perf_counter()
    cfg, cloud, camera = projection_cell()
    tracer = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)
    tracer.calibrate(cloud, camera)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with Recorder(tile_binning, "build_tile_binning") as rec:
        out = tracer(cloud, camera)
        torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    binning = {k: counts[k] for k in TILE_BIN_KERNELS}
    if len(rec.calls) != 1 or bool(out.overflow) or \
            any(v != 1 for v in binning.values()):
        raise SystemExit(f"phase tile-bin: the frame binned {len(rec.calls)} "
                         f"times, launched {binning}, overflow "
                         f"{bool(out.overflow)}")
    log(f"phase tile-bin: the recorded frame launched {binning}")
    args, kw = rec.calls[0]
    del out
    plain_kw = dict(
        width=kw["width"], height=kw["height"], tile_w=kw["tile_w"],
        tile_h=kw["tile_h"], max_pairs=kw["max_pairs"],
        max_units=kw["max_rows"], cutoff_map=kw.get("cutoff_map"),
        carry_depth=kw.get("carry_depth", False))
    route = lambda: tile_binning.build_tile_binning(*args, **kw)  # noqa
    plain = lambda: tile_binning.group_stream_plain(*args, **plain_kw)  # noqa
    got, want = route(), plain()
    torch.cuda.synchronize()
    differ = {}
    for f in tile_binning.TileBinning._fields:
        a, b = getattr(got, f), getattr(want, f)
        if (a is None) != (b is None):
            differ[f] = "None"
        elif a is not None:
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.shape != b.shape or a.dtype != b.dtype:
                differ[f] = f"{tuple(a.shape)} vs {tuple(b.shape)}"
            elif int((a != b).sum()):
                differ[f] = int((a != b).sum())
    if differ:
        raise SystemExit(f"phase tile-bin: the kernel route differs from the "
                         f"plain route: {differ}")
    n, mu = args[0].shape[0], plain_kw["max_units"]
    total = int(want.total_pairs)
    del got, want
    route_ops = device_ops(torch, route, TILE_BIN_REPS)
    plain_ops = device_ops(torch, plain, 3)
    route_ms = time_cuda(route, TILE_BIN_REPS)
    plain_ms = time_cuda(plain, 3)
    ntx, nty = tile_binning.tile_extent(kw["width"], kw["height"],
                                        kw["tile_w"], kw["tile_h"])
    # each input byte read once, each output byte written once
    kernel_bytes = {
        "bin_prep": n * (12 * 4 + 1 + 4 + 32)
        + 4 * ((ntx + 1) * (nty + 1) + 2 * ntx * nty),
        "bin_gather": n * (8 + 32 + 32),
        "bin_units": mu * (8 + 7) * 4}
    for name, nbytes in kernel_bytes.items():
        mine = [v for k, v in route_ops.items() if f"{name}_kernel" in k]
        ms = sum(v[1] for v in mine)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source=TILE_BIN_SRC, replaces=None,
            launches=binning[name], max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
            library_ms=None, bytes=nbytes, splats=n, units=mu))
        log(f"phase tile-bin: {name} {ms:.4f} ms a binning, bound "
            f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {bound_ms / ms:.1%} "
            f"of it)" if ms else f"phase tile-bin: {name} not in the trace")
    count = lambda o: sum(v[0] for v in o.values())  # noqa: E731
    busy = lambda o: sum(v[1] for v in o.values())  # noqa: E731
    top = sorted(route_ops.items(), key=lambda kv: -kv[1][1])
    log(f"phase tile-bin: {n} splats, {total} pairs, {mu} unit slots, made "
        f"and recorded in {time.perf_counter() - t0:.1f} s; every field "
        f"bitwise equal to the plain route; the route {route_ms:.4f} ms a "
        f"binning ({count(route_ops):.0f} device ops, {busy(route_ops):.4f} "
        f"ms of them), the plain route {plain_ms:.4f} ms "
        f"({count(plain_ops):.0f} device ops, {busy(plain_ops):.4f} ms); "
        f"the route's ops: " + ", ".join(
            f"{k[:48]} x{v[0]:.0f} {v[1]:.4f}" for k, v in top))
    return dict(route_ms=route_ms, plain_ms=plain_ms, launches=binning,
                route_ops=count(route_ops), plain_ops=count(plain_ops),
                route_busy_ms=busy(route_ops), plain_busy_ms=busy(plain_ops),
                ops={k[:64]: v for k, v in route_ops.items()},
                splats=n, pairs=total, units=mu)


def tiles128_render(torch, cloud, camera, rows):
    """tiles128x8: a 1080p frame of the render cell at 128x8 tiles (counts
    read), then blend_tiles against its plain version on its binning."""
    from gsrt_torch import RenderConfig, _kernels
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.ops import splat_pallas, splat_subtile

    W, H = WIDTH, HEIGHT
    cfg = RenderConfig(width=W, height=H, conic_mode="standard", tile_w=128,
                       tile_h=8)
    tracer = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)
    tracer.calibrate(cloud, camera)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with Recorder(splat_pallas, "blend_tiles") as rec:
        out = tracer(cloud, camera)
        torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    if counts["blend_tiles"] <= 0 or not torch.isfinite(out.color).all():
        raise SystemExit("phase tiles128x8: blend_tiles did not run")
    (binning,), kw = rec.calls[0]
    plain_kw = dict(kw, sub_w=128, sub_h=8)
    stats = {}
    t0 = time.perf_counter()
    cp, tp = splat_subtile.blend_subtiles_plain(binning, stats=stats,
                                                **plain_kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    run = lambda: splat_pallas.blend_tiles(binning, **kw)
    ck, tk = run()
    torch.cuda.synchronize()
    err = max_abs_err(ck - cp, tk - tp)
    total = int(binning.total_pairs)
    blended, accepted = stats["pairs_blended"], stats["accepted"]
    log(f"phase tiles128x8: {W}x{H} frame, launches {counts}; blend_tiles max "
        f"|kernel - plain| {err:.3e} (atol 1e-4), {blended} pairs blended "
        f"of {total}")
    if not err <= 1e-4:
        raise SystemExit(f"phase tiles128x8: blend_tiles differs from plain "
                         f"by {err}")
    t_ops = (TEST_FLOPS * blended * 1024
             + FWD_ACCEPT_FLOPS * accepted) / F32_FLOPS
    t_bytes = (4 * (7 * blended + binning.tile_start.numel())
               + 16 * W * H) / HBM_BYTES_PER_S
    info = f32_kernel_info("subtile", kw, 128, 8)
    rows.append(dict(
        name="blend_tiles", route="cuda", source=TILES_SRC,
        replaces=TILES_TPU, launches=counts["blend_tiles"], max_abs_err=err,
        ms=time_cuda(run, 10), plain_ms=plain_s * 1e3,
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None,
        **blend_floor(stats, info, max_sm_clock_hz(),
                      info["pixels_per_thread"]),
        build=info))
    row = rows[-1]
    log(f"phase tiles128x8: warp cull removes {stats['culled_steps']} of "
        f"{stats['warp_steps']} (warp, pair) steps "
        f"({row['culled_share']:.4f}); build: {describe_build(info)}")
    log(f"phase tiles128x8: kernel {row['ms']:.4f} ms, plain "
        f"{plain_s * 1e3:.1f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), instruction floor "
        + (f"{row['instruction_floor_ms']:.4f} ms"
           if row["instruction_floor_ms"] else "not measured"))


def fit_capture(tmpdir: str, device: str = DEVICE, sh_degree: int = 3):
    """tools/fit_bench.py's synthesize_capture on the port: the ground
    truth cloud, FIT_VIEWS targets from render_fast on two elevation rings,
    FIT_SFM noisy SfM points from default_rng(1); the COLMAP text model is
    written with the port's writer into tmpdir and read back. `sh_degree`
    below 3 zeroes the ground truth's higher SH bands before the targets
    are rendered (0: colour that does not depend on the view). Returns
    (cfg, ViewSet, initial params, scene extent, the model)."""
    import numpy as np
    import torch
    from gsrt_torch import RenderConfig, look_at, make_camera
    from gsrt_torch.interop import camera_from_numpy
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.models import multiview as mv
    from gsrt_torch.scene import colmap, random_cloud
    cloud, _ = random_cloud(FIT_GT, seed=SEED, extent=FIT_EXTENT,
                            scale_range=FIT_SCALES, width=FIT_W,
                            height=FIT_H, device=device)
    cloud.sh[:, (sh_degree + 1) ** 2:] = 0.0
    means = cloud.means.cpu().numpy()
    center = means.mean(0)
    radius = float(np.abs(means - center).max()) * 2.2
    cfg = RenderConfig(width=FIT_W, height=FIT_H, conic_mode="standard")
    # the targets alone in chunks of FIT_TARGET_CHUNK splats (an eighth of
    # the launches); the first two views against cfg's chunks must differ
    # by no more than rounding
    target_cfg = cfg.replace(splat_chunk=FIT_TARGET_CHUNK)
    images, targets, drift = [], [], []
    for i in range(FIT_VIEWS):
        ang = 2 * np.pi * i / FIT_VIEWS
        h = radius * (0.25 if i % 2 else -0.1)   # two elevation rings
        eye = center + np.array([radius * np.cos(ang), h,
                                 radius * np.sin(ang)])
        view = look_at(eye, center).astype(np.float32)
        cam = make_camera(view, FIT_FOV, FIT_W, FIT_H, device=device)
        with torch.no_grad():
            targets.append(grt.render_fast(cloud, cam, target_cfg).color)
            if i < 2:
                drift.append((grt.render_fast(cloud, cam, cfg).color
                              - targets[-1]).abs().max().item())
        images.append(colmap.ColmapImage(name=f"im_{i:03d}.png",
                                         camera_id=1, view=view))
    log(f"fit capture: targets in chunks of {FIT_TARGET_CHUNK} splats "
        f"against {cfg.splat_chunk} on views 0 and 1: max |diff| "
        f"{max(drift):.3e} (at most 1e-5)")
    if not max(drift) <= 1e-5:
        raise SystemExit("fit capture: the targets' chunking changed them "
                         "by more than rounding")
    rng = np.random.default_rng(SEED + 1)
    sh0 = cloud.sh[:, 0, :].cpu().numpy()
    pick = rng.choice(FIT_GT, size=min(FIT_SFM, FIT_GT), replace=False)
    pts = means[pick] + rng.normal(0, FIT_SFM_NOISE * FIT_EXTENT,
                                   (len(pick), 3))
    cols = np.clip(sh0[pick] * 0.2820948 + 0.5, 0, 1)
    c0 = make_camera(np.eye(4), FIT_FOV, FIT_W, FIT_H, device="cpu")
    colmap.write_text_model(os.path.join(tmpdir, "sparse", "0"),
                            colmap.ColmapModel(
        cameras={1: colmap.ColmapCamera("PINHOLE", FIT_W, FIT_H,
                                        float(c0.fx), float(c0.fy),
                                        FIT_W / 2.0, FIT_H / 2.0)},
        images=images, points=pts.astype(np.float32),
        colors=cols.astype(np.float32)))
    model = colmap.load_colmap_model(tmpdir)
    cam = model.cameras[1]
    cams = [camera_from_numpy(im.view, cam.fx, cam.fy, cam.cx, cam.cy,
                              cam.width, cam.height, device=device)
            for im in model.images]
    vs = mv.viewset_from_cameras(cams, targets, device=device)
    params = colmap.init_params_from_points(model.points, model.colors,
                                            device=device)
    return cfg, vs, params, colmap.scene_extent(model), model


def write_capture_images(capture_dir: str, model, vs) -> None:
    """The capture's targets as 8-bit PNGs under capture_dir/images, named
    as the model's images (the port's encoder)."""
    from gsrt_torch.utils.image import save_png
    os.makedirs(os.path.join(capture_dir, "images"), exist_ok=True)
    for im, target in zip(model.images, vs.images):
        save_png(os.path.join(capture_dir, "images", im.name), target)


def fit_kw(extent: float) -> dict:
    """fit_views's arguments in the fit workload."""
    return dict(iters=FIT_ITERS, holdout=FIT_HOLDOUT,
                densify_every=FIT_DENSIFY_EVERY, scene_scale=extent,
                opacity_reset_every=FIT_RESET_EVERY,
                max_splats=FIT_MAX_SPLATS, max_pairs=FIT_MAX_PAIRS, seed=SEED)


def fit_phase(torch, rows, card: str, capture_dir: str) -> dict:
    """The fit phase (see the module docstring). Adds the fit's launches
    to the rows of the kernels it runs; returns the fit figures. The
    capture (COLMAP model and the targets as PNGs) stays in capture_dir
    for the front-ends phase's `cli fit`."""
    from gsrt_torch import _kernels
    from gsrt_torch.models import densify as dn
    from gsrt_torch.models import multiview as mv
    from gsrt_torch.models import trainer
    from gsrt_torch.ops import tile_binning

    t_phase = time.perf_counter()
    cfg, vs, params, extent, model = fit_capture(capture_dir, DEVICE)
    torch.cuda.synchronize()
    train_idx, test_idx = mv.holdout_split(vs.n_views, FIT_HOLDOUT)
    n0 = params.means.shape[0]
    log(f"phase fit: {card}: capture of {vs.n_views} views at "
        f"{vs.width}x{vs.height} ({len(train_idx)} train, {len(test_idx)} "
        f"holdout) from {FIT_GT} splats, {len(model.points)} SfM points, "
        f"scene extent {extent:.4f}, made in "
        f"{time.perf_counter() - t_phase:.2f} s")
    t0 = time.perf_counter()
    write_capture_images(capture_dir, model, vs)
    log(f"phase fit: the targets written as PNGs for the front-ends phase "
        f"in {time.perf_counter() - t0:.2f} s")
    psnr0 = mv.eval_psnr(params, vs, test_idx[:8], cfg)
    growths = []
    step = mv.make_train_step_mv(cfg, 0.2, max_pairs=FIT_MAX_PAIRS,
                                 growths=growths)

    def probe(p) -> tuple[float, float]:
        """ms/step on the card's and the host's clocks over
        FIT_PROBE_STEPS steps of p (changed) after one warm-up."""
        opt = trainer.make_optimizer(p, lr_means=1.6e-4 * extent)
        stats = dn.init_stats(p.means.shape[0], p.means.device)
        views = [train_idx[k % len(train_idx)]
                 for k in range(FIT_PROBE_STEPS + 1)]
        stats, _ = step(p, opt, stats, vs, views[0])
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for v in views[1:]:
            stats, _ = step(p, opt, stats, vs, v)
        end.record()
        torch.cuda.synchronize()
        return (start.elapsed_time(end) / FIT_PROBE_STEPS,
                (time.perf_counter() - t0) * 1e3 / FIT_PROBE_STEPS)

    from gsrt_torch.scene import colmap
    ms0 = probe(colmap.init_params_from_points(model.points, model.colors,
                                               device=DEVICE))
    log(f"phase fit: {card}: {ms0[0]:.4f} ms/step on the card's clock, "
        f"{ms0[1]:.4f} on the host's, at the initial N {n0}")

    # the fit, with every densify event and every step's pairs recorded
    events, pairs = [], []
    densify, binning = mv.densify_and_prune, tile_binning.build_tile_binning

    def timed_densify(p, *a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = densify(p, *a, **kw)
        end.record()
        torch.cuda.synchronize()
        events.append(dict(rows_before=p.means.shape[0],
                           rows_after=out[0].means.shape[0],
                           card_ms=start.elapsed_time(end),
                           host_ms=(time.perf_counter() - t0) * 1e3,
                           **out[3]._asdict()))
        return out

    def counted_binning(*a, **kw):
        out = binning(*a, **kw)
        pairs.append(out.total_pairs.reshape(()))
        return out
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with Replaced(mv, "densify_and_prune", timed_densify), \
            Replaced(tile_binning, "build_tile_binning", counted_binning):
        params, rep = mv.fit_views(vs, params, cfg, **fit_kw(extent))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    max_pairs_seen = int(torch.stack(pairs).max())
    losses = rep.losses
    first = sum(losses[:FIT_WINDOW]) / FIT_WINDOW
    last = sum(losses[-FIT_WINDOW:]) / FIT_WINDOW
    for e in events:
        log(f"phase fit: {card}: densify event: N {e['rows_before']} -> "
            f"{e['rows_after']} ({e['n_after']} live: +{e['n_cloned']} "
            f"cloned, +{e['n_split']} split, -{e['n_pruned']} pruned), "
            f"{e['card_ms']:.3f} ms on the card's clock, "
            f"{e['host_ms']:.3f} on the host's")
    log(f"phase fit: {card}: {FIT_ITERS} steps in {fit_s:.2f} s (train and "
        f"holdout PSNR included); largest live pair count of a step "
        f"{max_pairs_seen} of max_pairs {FIT_MAX_PAIRS} (the buffer grew "
        f"{len(rep.pair_growths)} times); mean loss of the "
        f"first {FIT_WINDOW} steps {first:.5f}, of the last {last:.5f}")
    log(f"phase fit: {card}: train PSNR {rep.train_psnr:.4f} dB, holdout "
        f"PSNR {rep.test_psnr:.4f} dB (initial cloud {psnr0:.4f} dB), "
        f"N {rep.n_splats}")
    log(f"phase fit: {card}: launches {counts}")
    errs = fit_kernel_check(torch, params, vs, cfg, train_idx[0], card)
    ms1 = probe(params)
    log(f"phase fit: {card}: {ms1[0]:.4f} ms/step on the card's clock, "
        f"{ms1[1]:.4f} on the host's, at the final N {rep.n_splats}")

    if rep.pair_growths or growths:
        raise SystemExit(f"phase fit: the pair buffer of {FIT_MAX_PAIRS} "
                         f"grew: {rep.pair_growths} in the fit, {growths} "
                         f"in the probes")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise SystemExit("phase fit: non-finite loss")
    if not last < first:
        raise SystemExit(f"phase fit: the mean loss of the last "
                         f"{FIT_WINDOW} steps {last} is not below the "
                         f"first's {first}")
    # live counts: the initial cloud has no padding rows, so the first
    # event's n_before is its live count too
    if not events or not (events[0]["n_after"] > events[0]["n_before"]
                          and events[0]["n_cloned"] + events[0]["n_split"]):
        raise SystemExit(f"phase fit: the first densify event did not grow "
                         f"the live count: {events[:1]}")
    cap = dn.round_up_to(FIT_MAX_SPLATS)
    if any(e["rows_after"] > cap for e in events) or rep.n_splats > cap:
        raise SystemExit(f"phase fit: N exceeds round_up_to(max_splats) = "
                         f"{cap}")
    if not (rep.test_psnr == rep.test_psnr
            and abs(rep.test_psnr) != float("inf")
            and rep.test_psnr > psnr0):
        raise SystemExit(f"phase fit: holdout PSNR {rep.test_psnr} is not "
                         f"finite and above the initial cloud's {psnr0}")
    fit_kernels = ("expand_pairs_fused", "blend_subtiles", "blend_backward")
    for k in fit_kernels:
        if counts[k] != FIT_ITERS:
            raise SystemExit(f"phase fit: {k} launched {counts[k]} times "
                             f"in {FIT_ITERS} steps")
    for row in rows:    # the f32 table's expand and the two blends
        if row["name"] in fit_kernels[1:] or row.get("at", "").startswith(
                "the f32 stream's table"):
            row["fit_launches"] = counts[row["name"]]
            row["fit_max_abs_err"] = errs[row["name"]]
    log(f"phase fit: {card}: phase took {time.perf_counter() - t_phase:.2f}"
        f" s")
    return dict(
        views=vs.n_views, width=vs.width, height=vs.height, iters=FIT_ITERS,
        init_splats=n0, final_splats=rep.n_splats, events=events,
        max_pairs=FIT_MAX_PAIRS, max_live_pairs=max_pairs_seen,
        ms_per_step_initial=ms0[0], host_ms_per_step_initial=ms0[1],
        ms_per_step_final=ms1[0], host_ms_per_step_final=ms1[1],
        loss_first=first, loss_last=last, train_psnr=rep.train_psnr,
        test_psnr=rep.test_psnr, initial_test_psnr=psnr0,
        fit_s=fit_s, launches={k: counts[k] for k in fit_kernels},
        kernel_errors=errs)


def fit_kernel_check(torch, params, vs, cfg, view: int, card: str) -> dict:
    """Holds the fit's kernels against their plain versions on the inputs
    of one tiled step on `params` (the cloud after the last densify event,
    its padding rows included): the copy expand bit for bit, the forward
    blend at atol 1e-4, each backward row at 1e-3 of its largest value.
    Returns {kernel: max error}."""
    from gsrt_torch.models import densify as dn
    from gsrt_torch.models import trainer
    from gsrt_torch.ops import pair_expand, splat_grad, splat_subtile
    with Recorder(pair_expand, "expand_pairs_fused") as rec_x, \
            Recorder(splat_subtile, "blend_subtiles") as rec_fwd, \
            Recorder(splat_grad, "blend_backward") as rec_bwd:
        trainer.render_loss_tiled(params, vs.images[view], vs.camera_at(view),
                                  cfg, FIT_MAX_PAIRS, 0.2).backward()
    params.zero_grad(set_to_none=True)
    (tab, base, mp), _ = rec_x.calls[0]
    (binning,), fwd_kw = rec_fwd.calls[0]
    (payload, tile_start, pixstate), bwd_kw = rec_bwd.calls[0]
    pad = int((params.opacity_logit == dn._DEAD_LOGIT).sum())
    if not torch.equal(pair_expand.expand_pairs_fused(tab, base, mp),
                       pair_expand.expand_pairs_plain(tab, base, mp)):
        raise SystemExit("phase fit: the copy expand differs from its plain "
                         "version on the fit's table")
    fwd_err = max_abs_err(*(k - p for k, p in zip(
        splat_subtile.blend_subtiles(binning, **fwd_kw),
        splat_subtile.blend_subtiles_plain(binning, **fwd_kw))))
    grad_k = splat_grad.blend_backward(payload, tile_start, pixstate,
                                       **bwd_kw)
    grad_p = splat_grad.blend_backward_plain(payload, tile_start, pixstate,
                                             **bwd_kw)
    bwd_errs = [normalised_err(grad_k[r], grad_p[r])
                for r in range(splat_grad.GRAD_ROWS)]
    log(f"phase fit: {card}: kernels on view {view} after the last densify "
        f"event: {params.means.shape[0]} rows ({pad} padding rows at logit "
        f"{dn._DEAD_LOGIT}), table {tuple(tab.shape)}, "
        f"{int(binning.total_pairs)} pairs of max_pairs {mp}; copy expand "
        f"bitwise equal, blend_subtiles max |kernel - plain| {fwd_err:.3e} "
        f"(atol 1e-4), blend_backward per row max |kernel - plain| / max "
        f"|plain| {', '.join(f'{e:.2e}' for e in bwd_errs)} (atol 1e-3)")
    if not fwd_err <= 1e-4:
        raise SystemExit(f"phase fit: blend_subtiles differs from plain by "
                         f"{fwd_err}")
    if not all(e <= 1e-3 for e in bwd_errs):    # a NaN fails too
        raise SystemExit(f"phase fit: blend_backward differs from plain: "
                         f"{bwd_errs}")
    return {"expand_pairs_fused": 0.0, "blend_subtiles": fwd_err,
            "blend_backward": max(bwd_errs)}


def kbuffer_phase(torch, card: str) -> dict:
    """kbuffer: GaussianRayTracer(cfg, "reference") on the paper's
    configuration (REFERENCE_DEMO, the demo scene) and on the scale run
    (KB_SPLATS splats at KB_WxKB_H), each held against render_fast on the
    card; launch counts read around the scale run (the path is plain
    PyTorch: no kernel of the package launches)."""
    from gsrt_torch import REFERENCE_DEMO, RenderConfig, _kernels
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.scene import demo_gauss_splat, random_cloud

    def check(name, out, ref):
        dt = (out.trans - ref.trans).abs()
        dc = (out.color - ref.color).abs()
        bad_t = int((dt > 1e-5 + 1e-4 * ref.trans.abs()).sum())
        bad_c = int((dc > 1e-4 + 1e-3 * ref.color.abs()).sum())
        log(f"phase kbuffer: {name}: against render_fast max |trans diff| "
            f"{dt.max().item():.3e} (rtol 1e-4, atol 1e-5), max |colour "
            f"diff| {dc.max().item():.3e} (rtol 1e-3, atol 1e-4); entries "
            f"outside {bad_t} | {bad_c}")
        if bad_t or bad_c or not torch.isfinite(out.color).all():
            raise SystemExit(f"phase kbuffer: {name} differs from "
                             f"render_fast")

    c, cam = demo_gauss_splat(16, 16, device=DEVICE)
    demo = grt.GaussianRayTracer(REFERENCE_DEMO, "reference",
                                 device=DEVICE)(c, cam)
    check("REFERENCE_DEMO on demo_gauss_splat(16, 16)", demo,
          grt.render_fast(c, cam, REFERENCE_DEMO))
    log(f"phase kbuffer: demo passes max {int(demo.passes.max())}, hits "
        f"max {int(demo.hits.max())}, trans min {demo.trans.min().item():.5f}")

    cloud, camera = random_cloud(KB_SPLATS, seed=KB_SEED, width=KB_W,
                                 height=KB_H, device=DEVICE)
    cfg = RenderConfig(width=KB_W, height=KB_H, conic_mode="standard",
                       max_passes=KB_MAX_PASSES)
    tracer = grt.GaussianRayTracer(cfg, "reference", device=DEVICE)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ev[0].record()
    out = tracer(cloud, camera)
    ev[1].record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    frame_ms = ev[0].elapsed_time(ev[1])
    passes = out.passes.to(torch.int64)
    P = KB_W * KB_H
    if int(passes.max()) >= KB_MAX_PASSES:
        raise SystemExit("phase kbuffer: a pixel reached max_passes")
    # every pixel ran its passes and the empty pass that stopped it, each
    # testing every splat
    evals = (int(passes.sum()) + P) * KB_SPLATS
    log(f"phase kbuffer: {card}: {KB_SPLATS} splats at {KB_W}x{KB_H}, "
        f"{frame_ms:.1f} ms/frame on the card's clock ({host_s:.2f} s "
        f"host), passes max {int(passes.max())} mean "
        f"{passes.float().mean().item():.3f}, hits max "
        f"{int(out.hits.max())} mean {out.hits.float().mean().item():.2f}; "
        f"{evals} (pixel, splat) evaluations, "
        f"{evals / (frame_ms * 1e-3):.4e} a second; launches {counts}")
    if counts:
        raise SystemExit("phase kbuffer: a kernel launched on a plain "
                         "PyTorch path")
    check(f"{KB_SPLATS} splats at {KB_W}x{KB_H}", out,
          grt.render_fast(cloud, camera, cfg))
    return dict(demo_passes_max=int(demo.passes.max()), frame_ms=frame_ms,
                host_s=host_s, passes_max=int(passes.max()),
                passes_mean=passes.float().mean().item(),
                hits_max=int(out.hits.max()),
                hits_mean=out.hits.float().mean().item(), evaluations=evals,
                evaluations_per_s=evals / (frame_ms * 1e-3))


def splat_trace_phase(torch, card: str) -> dict:
    """splat-trace: the scale run's camera rays through trace_gaussian_rays
    and trace_gaussian_rays_clustered (clusters of 128, super-clusters of
    8, s_max every super-cluster), held together; the passes and the first
    pass's visited share. The brute force traces the cloud in the
    clusters' slot order: each tracer takes equal t* lowest position
    first, and ~1e-4 of the rays meet two splats at one f32 t*, whose
    blend order (and so colour) depends on that position."""
    from gsrt_torch import RenderConfig
    from gsrt_torch.core.types import GaussianCloud
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.models.path_tracer import generate_camera_rays
    from gsrt_torch.ops import clusters, splat_clusters
    from gsrt_torch.ops.sh import eval_sh
    from gsrt_torch.scene import random_cloud

    cloud, camera = random_cloud(KB_SPLATS, seed=KB_SEED, width=KB_W,
                                 height=KB_H, device=DEVICE)
    cfg = RenderConfig(width=KB_W, height=KB_H, conic_mode="standard")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    orig, dirn = generate_camera_rays(gen, camera, cfg)
    colors = eval_sh(cloud.sh, grt.unit_dirs(cloud.means, camera.position),
                     min(cfg.sh_degree, cloud.sh_degree))
    sc = splat_clusters.build_splat_clusters(cloud, cfg, colors, k=TRACE_K,
                                             sup=TRACE_SUP)
    ms = sc.clusters.sup_min.shape[0]
    r = splat_clusters.splat_world_radius(cloud, cfg)[:, None]
    slot = clusters.build_clusters(cloud.means - r, cloud.means + r,
                                   k=TRACE_K, sup=TRACE_SUP)[1][:cloud.n]
    slot = slot.long()
    slotted = GaussianCloud(*(a[slot] for a in cloud))

    def timed(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        res = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return res, ev[0].elapsed_time(ev[1])
    (bt, bc, bh), brute_ms = timed(lambda: grt.trace_gaussian_rays(
        slotted, orig, dirn, cfg, colors=colors[slot]))
    with Recorder(splat_clusters, "plan_visits") as rec:
        (ct, cc, ch, ovf), clus_ms = timed(
            lambda: splat_clusters.trace_gaussian_rays_clustered(
                sc, orig, dirn, cfg, rb=TRACE_RB, s_max=ms))
    passes = len(rec.calls)
    _, n_hit, _ = splat_clusters.plan_visits(*rec.calls[0][0],
                                             **rec.calls[0][1])
    share = n_hit.sum().item() / (n_hit.numel() * ms)
    err_t = (ct - bt).abs() - (1e-6 + 1e-5 * bt.abs())
    err_c = (cc - bc).abs() - (1e-5 + 1e-4 * bc.abs())
    hits_eq = torch.equal(ch, bh)
    log(f"phase splat-trace: {card}: {orig.shape[0]} camera rays, "
        f"{KB_SPLATS} splats in {sc.m} clusters of {TRACE_K}, {ms} "
        f"super-clusters; brute force (slot order) {brute_ms:.1f} ms, "
        f"clustered "
        f"{clus_ms:.1f} ms, {passes} passes, hits max {int(ch.max())} mean "
        f"{ch.float().mean().item():.2f}; the first pass visits "
        f"{share:.4f} of blocks x super-clusters; hits equal {hits_eq}, "
        f"max |trans diff| {(ct - bt).abs().max().item():.3e} (rtol 1e-5, "
        f"atol 1e-6), max |colour diff| {(cc - bc).abs().max().item():.3e} "
        f"(rtol 1e-4, atol 1e-5), overflow {bool(ovf)}")
    if not (hits_eq and bool((err_t <= 0).all()) and bool((err_c <= 0).all())
            and not bool(ovf)):
        raise SystemExit("phase splat-trace: the clustered tracer differs "
                         "from the brute force")
    return dict(brute_ms=brute_ms, clustered_ms=clus_ms, passes=passes,
                visited_share=share, hits_max=int(ch.max()),
                hits_mean=ch.float().mean().item(), super_clusters=ms)


def mixed_phase(torch, rows, card: str) -> dict:
    """mixed: mirror_in_gaussians path traced brute force and clustered
    (same seed), held together, launch counts read around the two
    renders; the binned cast (Q2.7) and the quad binning's copy expand
    (Q2.1) on the inputs they took there, each against its plain version
    bit for bit (rows of the kernels line); the calibrated render from
    gauss_s_max 1; then the splat-trace phase's cloud around the mirror,
    brute force against clustered."""
    from gsrt_torch import RenderConfig, _kernels
    from gsrt_torch.core.types import GaussianCloud
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.ops import clusters, splat_clusters, tri_binning
    from gsrt_torch.ops.sh import eval_sh
    from gsrt_torch.scene import mirror_in_gaussians, random_cloud

    def clustered(cloud, cam, cfg, k, sup):
        colors = eval_sh(cloud.sh, grt.unit_dirs(cloud.means, cam.position),
                         min(cfg.sh_degree, cloud.sh_degree))
        sc = splat_clusters.build_splat_clusters(cloud, cfg, colors, k=k,
                                                 sup=sup)
        return sc, sc.clusters.sup_min.shape[0]

    def timed(scene, cam, cfg, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        img, flags = pt.render_path_traced(scene, cam, cfg, seed=SEED,
                                           return_flags=True, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        return (img, {k: bool(v) for k, v in flags.items()},
                ev[0].elapsed_time(ev[1]), (time.perf_counter() - t0) * 1e3)

    def held(name, clus, brute):
        d = (clus - brute).abs()
        bad = int((d > 1e-3 + 5e-3 * brute.abs()).sum())
        log(f"phase mixed: {name}: max |clustered - brute| "
            f"{d.max().item():.3e} (rtol 5e-3, atol 1e-3), {bad} entries "
            f"outside")
        return bad

    scene, cloud, cam, opts = mirror_in_gaussians(MIX_W, MIX_H,
                                                  device=DEVICE)
    cfg = RenderConfig(width=MIX_W, height=MIX_H, samples=1,
                       bounces=MIX_BOUNCES, has_sky=opts["has_sky"],
                       gamma_correction=False)
    sc, ms = clustered(cloud, cam, cfg, MIX_K, MIX_SUP)
    bare = pt.render_path_traced(scene, cam, cfg, seed=SEED)   # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with Recorder(tri_binning, "cast_primary") as rec_c, \
            Recorder(tri_binning, "expand_pairs_fused") as rec_x:
        brute, f_b, brute_ms, brute_host = timed(scene, cam, cfg,
                                                 gaussians=cloud)
        clus, f_c, clus_ms, clus_host = timed(
            scene, cam, cfg, gauss_clusters=sc, gauss_s_max=ms,
            gauss_rb=MIX_RB)
    counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    # the clustered render coherence-sorts its bounce waves, the brute
    # force does not: unsorted it must give the same image bit for bit
    flat, f_u, flat_ms, _ = timed(scene, cam, cfg, gauss_clusters=sc,
                                  gauss_s_max=ms, gauss_rb=MIX_RB,
                                  sort_bounces=False)
    sorted_diff = (clus - flat).abs().max().item()
    splat_diff = (brute - bare).abs().max().item()
    log(f"phase mixed: {card}: mirror_in_gaussians({MIX_W}, {MIX_H}), "
        f"{cloud.n} splats ({sc.m} clusters of {MIX_K}, {ms} "
        f"super-clusters), {MIX_BOUNCES} bounces; brute force {brute_ms:.1f} "
        f"ms/render ({brute_host:.1f} host), clustered {clus_ms:.1f} "
        f"({clus_host:.1f} host), clustered unsorted {flat_ms:.1f}; sorted "
        f"against unsorted {sorted_diff:.3e} (must be 0); the splats "
        f"change the image by up to {splat_diff:.3f}; flags {f_b} | {f_c}; "
        f"launches {counts}")
    bad = held(f"{cloud.n} splats", clus, brute)
    if bad or sorted_diff or any(f_b.values()) or any(f_c.values()) or \
            any(f_u.values()) or not torch.isfinite(brute).all() or \
            splat_diff < 0.05:
        raise SystemExit("phase mixed: brute force and clustered differ, "
                         "or a flag is set")
    if counts.get("cast_primary", 0) < 2 or len(rec_c.calls) != 2 or \
            len(rec_x.calls) != 2:
        raise SystemExit("phase mixed: the binned primary cast and its "
                         "binning's expand did not run once a render")

    # Q2.7 and Q2.1 at the quad's binning, as bounce 0 of both renders
    # gave it to them (the same inputs twice, up to the payload's unused
    # columns: checked)
    (binning, dirs, origin), cast_kw = rec_c.calls[0]
    (binning2, dirs2, _), _ = rec_c.calls[1]
    live = int(binning.total_pairs)
    if not (torch.equal(dirs, dirs2)
            and torch.equal(binning.tile_start, binning2.tile_start)
            and torch.equal(binning.payload[:, :live],
                            binning2.payload[:, :live])):
        raise SystemExit("phase mixed: the two renders cast different "
                         "bounce-0 inputs")
    at = f"mirror_in_gaussians {MIX_W}x{MIX_H}, 2 triangles, bounce 0"
    cast = cast_row(torch, "cast_primary[mixed]", binning, dirs, origin,
                    cast_kw, max_sm_clock_hz(), phase="mixed")
    expand = tri_expand_rows(torch, rec_x.calls[:1],
                             ["expand_pairs_fused[mixed]"], at,
                             phase="mixed")[0]
    cast.update(launches=rec_c.launched("cast_primary"), at=at)
    expand["launches"] = rec_x.launched("expand_pairs_fused")
    if cast["launches"] != 2 or expand["launches"] != 2:
        raise SystemExit(f"phase mixed: launches {rec_c.launches} | "
                         f"{rec_x.launches}")
    rows += [cast, expand]
    del rec_c, rec_x, binning, binning2, dirs, dirs2

    img, info = pt.render_path_traced_calibrated(
        scene, cam, cfg, seed=SEED, gauss_clusters=sc, gauss_s_max=1,
        gauss_rb=MIX_RB, max_retries=4)
    same = (img - clus).abs().max().item()
    log(f"phase mixed: calibrated from gauss_s_max 1: {info['retries']} "
        f"re-renders, gauss_s_max {info['gauss_s_max']}, last flags "
        f"{info['flags']}, max |image - clustered| {same:.3e}")
    if info["retries"] < 1 or info["flags"]["gauss_visits_overflow"] or \
            same > 1e-6:
        raise SystemExit("phase mixed: the calibration did not report the "
                         "overflow and end without it")

    # the splat-trace phase's cloud moved round the mirror: every bounce
    # segment crosses thousands of splats. The brute force traces it in
    # the clusters' slot order, so both take equal t* alike (splat-trace)
    scene, _, cam, _ = mirror_in_gaussians(MIX_BIG_W, MIX_BIG_H,
                                           device=DEVICE)
    big, _ = random_cloud(KB_SPLATS, seed=KB_SEED, device=DEVICE)
    big = big._replace(means=big.means + torch.tensor(
        MIX_BIG_SHIFT, device=DEVICE))
    cfg_big = cfg.replace(width=MIX_BIG_W, height=MIX_BIG_H)
    sc_big, ms_big = clustered(big, cam, cfg_big, TRACE_K, TRACE_SUP)
    r = splat_clusters.splat_world_radius(big, cfg_big)[:, None]
    slot = clusters.build_clusters(big.means - r, big.means + r, k=TRACE_K,
                                   sup=TRACE_SUP)[1][:big.n].long()
    slotted = GaussianCloud(*(a[slot] for a in big))
    brute_b, fb_b, brute_b_ms, _ = timed(scene, cam, cfg_big,
                                         gaussians=slotted)
    clus_b, fc_b, clus_b_ms, _ = timed(
        scene, cam, cfg_big, gauss_clusters=sc_big, gauss_s_max=ms_big,
        gauss_rb=MIX_RB)
    log(f"phase mixed: {card}: {big.n} splats round the mirror at "
        f"{MIX_BIG_W}x{MIX_BIG_H} ({sc_big.m} clusters of {TRACE_K}, "
        f"{ms_big} super-clusters), {MIX_BOUNCES} bounces: brute force "
        f"{brute_b_ms:.1f} ms/render, clustered {clus_b_ms:.1f}; flags "
        f"{fb_b} | {fc_b}; mean colour {brute_b.mean().item():.5f}")
    bad = held(f"{big.n} splats", clus_b, brute_b)
    if bad or any(fb_b.values()) or any(fc_b.values()) or \
            not torch.isfinite(brute_b).all():
        raise SystemExit("phase mixed: brute force and clustered differ "
                         "round the 20,000-splat cloud, or a flag is set")
    return dict(brute_ms=brute_ms, clustered_ms=clus_ms,
                clustered_unsorted_ms=flat_ms, sorted_vs_unsorted=sorted_diff,
                brute_host_ms=brute_host, clustered_host_ms=clus_host,
                launches=counts, calibrated=dict(
                    retries=info["retries"], gauss_s_max=info["gauss_s_max"]),
                big=dict(splats=big.n, width=MIX_BIG_W, height=MIX_BIG_H,
                         brute_ms=brute_b_ms, clustered_ms=clus_b_ms,
                         super_clusters=ms_big))


def ellipse_phase(torch, rows, card: str) -> dict:
    """ellipse: the render cell with ellipse spans (compact tile stream),
    calibrated, one frame with its launches counted (each expand's on its
    own), against the rect tile stream, the worst pixel's difference
    traced to the pairs the ellipse drops (`ellipse_witness`); the two
    expands and the tile blend on its inputs against their plain versions
    (rows of the kernels line)."""
    from gsrt_torch import _kernels
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.ops import pair_expand, splat_packed, tile_binning

    W, H = WIDTH, HEIGHT
    cfg0, cloud, camera = render_cell()
    cfg = cfg0.replace(span_mode="ellipse")
    plan = grt.stream_plan(cfg, W, H)
    tracer = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)
    tracer.calibrate(cloud, camera)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with Recorder(pair_expand, "expand_pairs_fused") as rec_e, \
            Recorder(splat_packed, "blend_packed") as rec_b, \
            Recorder(tile_binning, "build_tile_binning") as rec_t:
        out = tracer(cloud, camera)
        torch.cuda.synchronize()
    counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    log(f"phase ellipse: {card}: plan {plan._asdict()}, max_rows "
        f"{tracer.max_rows}, max_pairs {tracer.max_pairs}; launches {counts}")
    if not (plan.span_mode == "ellipse" and len(rec_e.calls) == 2
            and counts.get("expand_pairs_fused") == 2
            and all(c == {"expand_pairs_fused": 1} for c in rec_e.launches)
            and counts.get("blend_packed_tile") == 1
            and not bool(out.overflow) and torch.isfinite(out.color).all()):
        raise SystemExit("phase ellipse: the frame did not run the two "
                         "expands and the tile blend once, or overflowed")
    (tab1, rbase, mr), _ = rec_e.calls[0]
    (tab2, pbase, mp), _ = rec_e.calls[1]
    (binning,), blend_kw = rec_b.calls[0]
    rect = grt.GaussianRayTracer(cfg0.replace(stream="tile"), "tiled",
                                 device=DEVICE)
    rect.calibrate(cloud, camera)
    with Recorder(splat_packed, "blend_packed") as rec_r:
        rout = rect(cloud, camera)
        torch.cuda.synchronize()
    rbin = rec_r.calls[0][0][0]
    err = max_abs_err(out.color - rout.color, out.trans - rout.trans)
    px_err = torch.maximum((out.color - rout.color).abs().amax(-1),
                           (out.trans - rout.trans).abs())
    over = int(((out.color - rout.color).abs() > 2e-3).sum()
               + ((out.trans - rout.trans).abs() > 2e-3).sum())
    worst_y, worst_x = divmod(int(px_err.argmax()), W)
    (cols, bkw), = rec_t.calls
    wit = ellipse_witness(torch, cols, bkw, blend_kw, worst_x, worst_y)
    fewer = bool((binning.tile_count <= rbin.tile_count).all())
    # the f32 payload: the pairs the ellipse drops are taken by no pixel
    f32 = [grt.GaussianRayTracer(c.replace(payload="f32"), "tiled",
                                 device=DEVICE)(cloud, camera)
           for c in (cfg, rect.cfg)]
    err32 = max_abs_err(f32[0].color - f32[1].color,
                        f32[0].trans - f32[1].trans)
    dead = pair_expand._DEAD_BASE
    n_rows = int((pbase != dead).sum())
    pairs, rpairs = int(binning.total_pairs), int(rbin.total_pairs)
    kw = dict(max_pairs=tracer.max_pairs, max_rows=tracer.max_rows)
    frame_ms = min(time_cuda(lambda: grt.render_tiled(cloud, camera, cfg,
                                                      **kw), FRAMES)
                   for _ in range(3))
    rect_ms = min(time_cuda(lambda: grt.render_tiled(
        cloud, camera, rect.cfg, max_pairs=rect.max_pairs), FRAMES)
        for _ in range(3))
    log(f"phase ellipse: {int((rbase != dead).sum())} splats with rows, "
        f"{n_rows} tile rows, {pairs} pairs against {rpairs} on rect spans "
        f"({pairs / rpairs:.4f}); every tile at most its rect count "
        f"{fewer}; max |ellipse - rect| on the f32 payload {err32:.3e} "
        f"(atol 2e-3), on the compact payload {err:.3e} ({over} entries "
        f"above 2e-3, at most {ELLIPSE_OVER_MAX}; at most 1e-2); frame "
        f"{frame_ms:.4f} ms (rect tile stream {rect_ms:.4f})")
    log(f"phase ellipse: the compact payload's worst pixel ({worst_x}, "
        f"{worst_y}), off by {px_err.max().item():.3e}: {wit['rect_pairs']} "
        f"pairs of its tile {wit['tile']} on rect spans, "
        f"{wit['dropped']} of them dropped by the ellipse, of which "
        f"{wit['lifted']} take the pixel only after the payload's rounding"
        + ("; the largest: splat {splat}, alpha {alpha_f32:.6f} in f32 "
           "(g {g_f32:.4f}, opacity {op_f32:.6f}) against "
           "{alpha_payload:.6f} on the payload (g {g_payload:.4f}, "
           "opacity {op_payload:.6f}), threshold {threshold:.6f}, colour "
           "{rgb}".format(**wit["largest"]) if wit["largest"] else ""))
    # on the compact payload a pair the ellipse drops (alpha under the
    # threshold at every pixel in f32) can clear the threshold under the
    # payload's bf16 Cholesky factor and u8 opacity: a few entries move by
    # about alpha_threshold times a colour. Past the f32 payload's 2e-3
    # only such a pair may move the worst pixel
    if not (fewer and err32 <= 2e-3 and err <= 1e-2
            and over <= ELLIPSE_OVER_MAX
            and (err <= 2e-3 or wit["lifted"] > 0)
            and not any(bool(o.overflow) for o in f32)):
        raise SystemExit("phase ellipse: the ellipse frame differs from the "
                         "rect one beyond what the payload's rounding "
                         "explains, or a tile gained pairs")

    def library(tab, base, n):
        src = torch.searchsorted(base, torch.arange(
            n, device=DEVICE, dtype=torch.int32), right=True)
        return lambda: tab.index_select(1, src.sub(1).clamp_(
            0, tab.shape[1] - 1))
    for name, tab, base, n, launched in (
            ("expand_pairs_fused[ellipse,rows]", tab1, rbase, mr,
             rec_e.launches[0]),
            ("expand_pairs_fused[ellipse,pairs]", tab2, pbase, mp,
             rec_e.launches[1])):
        rows.append(expand_row(
            name, EXPAND_TPU,
            lambda: pair_expand.expand_pairs_fused(tab, base, n),
            lambda: pair_expand.expand_pairs_plain(tab, base, n),
            library(tab, base, n), launched["expand_pairs_fused"],
            4 * (tab.shape[0] * (n + tab.shape[1]) + tab.shape[1]),
            phase="ellipse"))
        rows[-1]["at"] = f"{tuple(tab.shape)} -> {n}"

    # the tile blend on the ellipse payload
    rows.append(tile_blend_row(torch, "blend_packed_tile[ellipse]", binning,
                               blend_kw, counts["blend_packed_tile"],
                               "ellipse"))
    return dict(frame_ms=frame_ms, rect_frame_ms=rect_ms, pairs=pairs,
                rect_pairs=rpairs, tile_rows=n_rows, max_rows=tracer.max_rows,
                max_pairs=tracer.max_pairs, max_abs_err_vs_rect=err,
                entries_above_2e3=over, max_abs_err_vs_rect_f32=err32,
                worst_pixel=dict(x=worst_x, y=worst_y, **wit))


def ellipse_witness(torch, cols, bkw, blend_kw, x, y) -> dict:
    """What moves pixel (x, y) between the ellipse and the rect tile
    stream on the compact payload: the splats the rect spans bin into its
    tile, those whose ellipse row span (`ellipse_row_tiles`, the binning's
    own f32 math) leaves the tile out, and of these the ones the pixel
    rejects in f32 but takes after the payload's rounding (fixed-point
    tile-relative mean, bf16 Cholesky factor, u8 opacity), with the
    largest such pair's alphas both ways. `cols` and `bkw` are the
    arguments of the frame's build_tile_binning, `blend_kw` its blend's."""
    from gsrt_torch.ops import splat_packed as sp, tile_binning as tb
    (depth, m2x, m2y, qa, qb, qc, opacity, cr, cg, cb, rx, ry,
     alive) = cols
    tw, th = bkw["tile_w"], bkw["tile_h"]
    x0, x1, y0, y1, touched = tb.compute_tile_spans(
        m2x, m2y, rx, ry, alive, bkw["width"], bkw["height"], tw, th)
    op = torch.where(alive, opacity, torch.zeros_like(opacity))
    tx, ty = x // tw, y // th
    cand = ((touched > 0) & (x0 <= tx) & (tx <= x1) & (y0 <= ty)
            & (ty <= y1)).nonzero()[:, 0]
    e0, e1 = tb.ellipse_row_tiles(
        m2x[cand], m2y[cand], qa[cand], qb[cand], qc[cand], op[cand],
        torch.full_like(x0[cand], ty), x0[cand], x1[cand], tile_w=tw,
        tile_h=th, g_cutoff=bkw["g_cutoff"],
        alpha_threshold=bkw["alpha_threshold"])
    d = cand[(tx < e0) | (tx > e1)]
    akw = {k: blend_kw[k] for k in ("g_cutoff", "alpha_threshold",
                                    "alpha_clamp", "skip_range_check",
                                    "use_exp_lut")}
    at = lambda v: torch.tensor([float(v)], device=DEVICE)
    g32 = sp.response(dict(mx=m2x[d], my=m2y[d], qa=qa[d], qb=qb[d],
                           qc=qc[d]), at(x), at(y))[0]
    _, take32 = sp.alphas(g32[None], op[d], **akw)
    l11, l21, l22 = tb.conic_cholesky(qa[d], qb[d], qc[d])
    f = sp.decode_pairs(torch.stack([
        tb.pack_mean_rel(m2x[d] - tx * tw, m2y[d] - ty * th),
        tb.pack_bf16_pair(l11, l21), tb.pack_bf16_pair(l22, depth[d]),
        tb.pack_rgba8(cr[d], cg[d], cb[d], op[d])]))
    gp = sp.response(f, at(x - tx * tw), at(y - ty * th))[0]
    _, takep = sp.alphas(gp[None], f["op"], **akw)
    lifted = (takep & ~take32)[0]
    raw = lambda o, g: torch.clamp_max(o * torch.exp(-g),
                                       akw["alpha_clamp"])
    a32, ap = raw(op[d], g32), raw(f["op"], gp)
    largest = None
    if bool(lifted.any()):
        i = int(torch.where(lifted, ap, torch.full_like(ap, -1.0)).argmax())
        largest = dict(
            splat=int(d[i]), alpha_f32=a32[i].item(),
            alpha_payload=ap[i].item(), g_f32=g32[i].item(),
            g_payload=gp[i].item(), op_f32=op[d][i].item(),
            op_payload=f["op"][i].item(),
            threshold=akw["alpha_threshold"],
            rgb=[round(v, 4) for v in f["rgb"][i].tolist()])
    return dict(tile=[tx, ty], rect_pairs=int(cand.numel()),
                dropped=int(d.numel()), lifted=int(lifted.sum()),
                largest=largest)


def tri_soup(n: int, sd: float, seed: int = 0):
    """tools/tri_bench.py's generator: n centres U(-2, 2)^3, each vertex
    its centre + N(0, sd) (NumPy, as there)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    a = c + rng.normal(0, sd, c.shape).astype(np.float32)
    b = c + rng.normal(0, sd, c.shape).astype(np.float32)
    return c, a, b


def tri_scene(verts):
    """A one-material (Lambertian 0.73) triangle scene, as the port's
    users hand arrays over (interop.scene_from_numpy)."""
    import numpy as np
    from gsrt_torch.interop import scene_from_numpy
    z3, z = np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
    fields = dict(
        sph_center=z3, sph_radius=z, sph_mat=z.astype(np.int32),
        box_min=z3, box_max=z3, box_mat=z.astype(np.int32),
        tri_v0=verts[0], tri_v1=verts[1], tri_v2=verts[2],
        tri_mat=np.zeros(verts[0].shape[0], np.int32),
        materials=dict(model=np.int32([0]), diffuse=np.float32([[0.73] * 3]),
                       fuzziness=np.float32([0]),
                       refraction_index=np.float32([1]),
                       texture_id=np.int32([-1])))
    return scene_from_numpy(fields, device=DEVICE)


def cast_row(torch, name, binning, dirs, origin, kw, clock_hz,
             phase="tri-cast"):
    """Q2.7 against its plain version on one binning, bit for bit; the
    row with its times, bound, build, the warp cull's share of the
    (warp, pair) steps and the instruction floor."""
    from gsrt_torch.ops import tri_binning
    stats = {}
    t_p, id_p = tri_binning.cast_primary_plain(binning, dirs, origin,
                                               stats=stats, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tri_binning.cast_primary_plain(binning, dirs, origin, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    run = lambda: tri_binning.cast_primary(binning, dirs, origin, **kw)
    t_k, id_k = run()
    torch.cuda.synchronize()
    if not (torch.equal(t_k, t_p) and torch.equal(id_k, id_p)):
        raise SystemExit(
            f"phase {phase}: {name} differs from its plain version: "
            f"{int((t_k != t_p).sum())} t, {int((id_k != id_p).sum())} ids")
    W, H, npx = kw["width"], kw["height"], kw["tile_w"] * kw["tile_h"]
    total, cast = int(binning.total_pairs), int(stats["pairs"])
    t_ops = (CAST_FLOPS * npx + CAST_PAIR_FLOPS) * cast / F32_FLOPS
    # zmin of every pair, the rest of the payload where cast, tile_start,
    # the directions; t and id out
    t_bytes = (4 * (total + 10 * cast + binning.tile_start.numel())
               + 20 * W * H) / HBM_BYTES_PER_S
    hit = (t_k < 3e38).float().mean().item()
    info = cast_kernel_info(npx)
    row = dict(name=name, route="cuda", source=CAST_SRC, replaces=CAST_TPU,
               launches=0, max_abs_err=0.0, ms=time_cuda(run, 20),
               plain_ms=plain_s * 1e3, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=None, pairs=total, pairs_cast=cast,
               chunks_cast=int(stats["chunks"]), hit_fraction=hit,
               warp_steps=stats["warp_steps"],
               culled_steps=stats["culled_steps"], build=info,
               **blend_floor(stats, info, clock_hz))
    sass = info["sass"]
    log(f"phase {phase}: {name}: bit-equal to plain, {W}x{H} at "
        f"{kw['tile_w']}x{kw['tile_h']} tiles, {total} pairs, {cast} cast "
        f"in {stats['chunks']} chunks, {hit:.4f} of pixels hit; warp cull "
        f"{stats['culled_steps']} of {stats['warp_steps']} (warp, pair) "
        f"steps ({row['culled_share']:.4f}); kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.1f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); {info['registers']} registers, "
        f"{info['spill_bytes']} bytes spilled a thread, "
        f"{info['static_smem_bytes']} B shared, {info['blocks_per_sm']} "
        f"blocks of {npx} an SM; SASS a (warp, pair) step "
        + (f"{sass['per_test']:.2f}, instruction floor "
           f"{row['instruction_floor_ms']:.4f} ms" if sass and
           row["instruction_floor_ms"] else "not read (no cuobjdump)"))
    return row


def cast_kernel_info(threads: int) -> dict:
    """The cast kernel's build (gsrt_tri_cast_info) at `threads` a block,
    and the SASS of its (warp, pair) step loop (one MUFU.RCP a step)."""
    from gsrt_torch import _kernels
    info = build_info("tri_cast", "gsrt_tri_cast_info", threads)
    info.update(threads=threads, sass=sass_inner_loop(
        _kernels._lib_path("tri_cast"), os.path.dirname(_kernels._nvcc()),
        function="tri_cast_kernel"))
    return info


def tri_expand_rows(torch, calls, names, at, phase="tri-cast"):
    """Q2.1 rows (the copy kernel) at the triangle binning's recorded
    calls of expand_pairs_fused, bit for bit against the plain version."""
    from gsrt_torch.ops import pair_expand
    out = []
    for ((tab, base, mp), _), name in zip(calls, names):
        n = tab.shape[1]
        row = expand_row(
            name, EXPAND_TPU,
            lambda tab=tab, base=base, mp=mp:
                pair_expand.expand_pairs_fused(tab, base, mp),
            lambda tab=tab, base=base, mp=mp:
                pair_expand.expand_pairs_plain(tab, base, mp),
            lambda tab=tab, base=base, mp=mp:
                tab.index_select(1, pair_expand.source_index(base, mp)),
            0, 4 * (tab.shape[0] * (mp + n) + n), phase=phase)
        row["at"] = f"{at}, table {tuple(tab.shape)} to {mp} columns"
        out.append(row)
    return out


def build_info(lib: str, symbol: str, *args) -> dict:
    """Registers, shared memory, spills and resident blocks of a built
    kernel, from its library's info entry point (`symbol`(*args, info))."""
    import ctypes
    from gsrt_torch import _kernels
    fn = getattr(_kernels._load(lib), symbol)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_int * 5)()
    if fn(*args, buf) != 0:
        raise SystemExit(f"{symbol}{args} failed")
    return dict(zip(("registers", "static_smem_bytes", "dynamic_smem_bytes",
                     "spill_bytes", "blocks_per_sm"), buf))


def traverse_kernel_info(rb: int) -> dict:
    """The traversal kernel's build (gsrt_tri_traverse_info), and the SASS
    of its per-triangle loop where cuobjdump is installed."""
    from gsrt_torch import _kernels
    info = build_info("tri_kernel", "gsrt_tri_traverse_info", rb)
    info.update(threads=rb, sass=sass_inner_loop(
        _kernels._lib_path("tri_kernel"), os.path.dirname(_kernels._nvcc())))
    return info


# the packed blends' kinds in gsrt_blend_info, and their kernels' mangled
# names (the accept rule is the last template argument)
BLEND_KINDS = {"group": (0, "blend_group_kernelILi{rule}EE"),
               "tile": (1, "blend_tile_kernelILb1ELi{rule}EE"),
               "tile_f32": (2, "blend_tile_kernelILb0ELi{rule}EE")}


def blend_kernel_info(kind: str, blend_kw: dict, threads: int) -> dict:
    """The build (gsrt_blend_info) of the packed blend instance that
    `blend_packed(**blend_kw)` launches, and the SASS of its per-(pixel,
    pair) loop (the innermost loop holding the exp's MUFU.EX2)."""
    from gsrt_torch import _kernels
    rule = (int(bool(blend_kw["skip_range_check"]))
            + 2 * int(bool(blend_kw.get("use_exp_lut", False))))
    code, function = BLEND_KINDS[kind]
    info = build_info("splat_packed", "gsrt_blend_info", code, rule, threads)
    info.update(threads=threads, rule=rule, sass=sass_inner_loop(
        _kernels._lib_path("splat_packed"), os.path.dirname(_kernels._nvcc()),
        function=function.format(rule=rule), marker="MUFU.EX2"))
    return info


# the f32 tile stream's kernels: library, info entry point, mangled name
# (accept rule, then the launch-bound tier)
F32_KINDS = {"subtile": ("splat_subtile", "gsrt_subtile_info",
                         "subtile_fwd_kernelILi{rule}EE"),
             "grad": ("splat_grad", "gsrt_grad_info",
                      "subtile_bwd_kernelILi{rule}EE")}


def f32_kernel_info(kind: str, blend_kw: dict, tile_w: int,
                    tile_h: int) -> dict:
    """The build of the forward ("subtile") or backward ("grad") instance a
    launch with `blend_kw` at tile_w x tile_h runs, and the SASS of its
    innermost loop holding the exp (the forward: one pair for a thread's
    pixels; the backward: a group of 8 pairs), per (pixel, pair)."""
    from gsrt_torch import _kernels
    from gsrt_torch.ops import splat_grad, splat_subtile
    rule = (int(bool(blend_kw["skip_range_check"]))
            + 2 * int(bool(blend_kw.get("use_exp_lut", False))))
    lib, symbol, function = F32_KINDS[kind]
    pix = (splat_subtile if kind == "subtile" else
           splat_grad).PIXELS_PER_THREAD
    info = build_info(lib, symbol, rule, tile_w, tile_h)
    info.update(threads=splat_subtile.block_threads(tile_w, tile_h, pix),
                pixels_per_thread=pix, rule=rule, sass=sass_inner_loop(
                    _kernels._lib_path(lib),
                    os.path.dirname(_kernels._nvcc()),
                    function=function.format(rule=rule), marker="MUFU.EX2"))
    return info


def describe_build(info: dict) -> str:
    sass = info["sass"]
    return (f"{info['registers']} registers, {info['spill_bytes']} bytes "
            f"spilled a thread, {info['static_smem_bytes']} B static + "
            f"{info['dynamic_smem_bytes']} B dynamic shared memory, "
            f"{info['blocks_per_sm']} blocks of {info['threads']} threads "
            f"an SM; SASS per-(pixel, pair) loop "
            + (f"{sass['instructions']} instructions for {sass['tests']} "
               f"exps ({sass['per_test']:.2f} a step)"
               if sass else "not read (no cuobjdump)"))


_SASS_DUMPS: dict = {}


def sass_inner_loop(lib, cuda_bin: str, function: str = "tri_traverse_kernel",
                    marker: str = "MUFU.RCP"):
    """The innermost loop of `function`'s SASS that holds `marker`
    (tri_traverse_kernel: Moller-Trumbore's reciprocal, one MUFU.RCP a
    test): its instructions and markers an iteration, or None without
    cuobjdump. A slow path outside the loop is not counted."""
    import re
    import shutil
    key = str(lib)
    if key not in _SASS_DUMPS:
        tool = os.path.join(cuda_bin, "cuobjdump")
        tool = tool if os.path.isfile(tool) else shutil.which("cuobjdump")
        out = None
        if tool:
            try:
                out = subprocess.run([tool, "-sass", key],
                                     capture_output=True, text=True,
                                     timeout=120).stdout
            except (OSError, subprocess.TimeoutExpired):
                out = None
        _SASS_DUMPS[key] = out
    out = _SASS_DUMPS[key]
    if not out:
        return None
    insts, labels, pending, inside = [], {}, [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = function in line
            continue
        if not inside:
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insts.append((addr, m.group(2).strip()))
    loops = []
    for addr, text in insts:
        if "BRA" not in text.split()[0 if not text.startswith("@") else 1]:
            continue
        tgt = re.search(r"(\.L_x_\d+)", text)
        tgt = labels.get(tgt.group(1)) if tgt else None
        if tgt is None:
            hexa = re.search(r"0x([0-9a-f]+)", text)
            tgt = int(hexa.group(1), 16) if hexa else None
        if tgt is None or tgt > addr:
            continue
        body = [t for a, t in insts if tgt <= a <= addr]
        hits = sum(marker in t for t in body)
        if hits:
            loops.append((len(body), hits))
    if not loops:
        return None
    n, hits = min(loops)
    return dict(instructions=n, tests=hits, per_test=n / hits)


def max_sm_clock_hz():
    """The card's top SM clock (nvidia-smi clocks.max.sm), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        return float(out[0]) * 1e6
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        return None


def traverse_row(torch, name, tt, args, kw, info, clock_hz):
    """Q2.8 against its plain version on one ray bundle: closest hit with
    t, slots and executed visits equal; any hit with the hit mask equal
    and every returned t a hit of its triangle (max_abs_err: the largest
    |t - plain t| over the hits). The plain version also runs with the TPU
    kernel's block cull (cull_rays = RB): the rays whose result differs
    from the warp cull's are counted; in closest hit each must agree in t
    to rtol 1e-5 (a tie), in any hit the hit masks must be equal. The row
    times the kernel alone, on the bundle's prepared rays and plan, and
    bounds it by the tests the warp cull needs, beside the block cull's."""
    from gsrt_torch.ops import tri_kernel
    any_hit = kw.get("any_hit", False)
    G = tri_kernel.CULL_RAYS
    stats, stats_b = {}, {}
    t0 = time.perf_counter()
    t_p, s_p, h_p, plan_p = tri_kernel.closest_hit_packed_plain(
        tt, *args, stats=stats, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    t_b, s_b, h_b, plan_b = tri_kernel.closest_hit_packed_plain(
        tt, *args, stats=stats_b, cull_rays=RB, **kw)
    torch.cuda.synchronize()
    plain_b_s = time.perf_counter() - t0
    differ = (t_b != t_p) | (s_b != s_p)
    n_differ = int(differ.sum())
    tie = ((t_b - t_p).abs() <= 1e-5 * t_b.abs()) & (h_b == h_p)
    n_untied = int((differ & ~tie).sum())
    if (n_untied if not any_hit else int((h_b != h_p).sum())) or \
            not torch.equal(plan_b.actual, plan_p.actual):
        raise SystemExit(f"phase tri-traverse: {name}: the warp cull "
                         f"changes {n_untied} rays beyond a tie, or the "
                         f"hit mask or the visits, against the block cull")
    t_k, s_k, h_k, plan = tri_kernel.closest_hit_packed(tt, *args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(h_k, h_p):
        raise SystemExit(f"phase tri-traverse: {name}: hit masks differ on "
                         f"{int((h_k != h_p).sum())} rays")
    same = (torch.equal(t_k, t_p) and torch.equal(s_k, s_p)
            and torch.equal(plan.actual, plan_p.actual))
    if not any_hit and not same:
        raise SystemExit(f"phase tri-traverse: {name}: t, slots or executed "
                         f"visits differ from the plain version")
    err = (t_k - t_p)[h_k].abs().max().item() if bool(h_k.any()) else 0.0
    # every hit is a hit of the triangle in its slot, inside the window
    orig, dirn, t_min, t_max = args
    rays, plan_t, R = tri_kernel._prepare(tt, orig, dirn, t_min, t_max, RB,
                                          None)
    ray = rays[:, :R, None, None]
    tri = tt.table[s_k.long() // tri_kernel.K, :,
                   s_k.long() % tri_kernel.K][:, None, :, None]
    t_re = tri_kernel._mt(*ray, tri)[:, 0, 0]
    ok = (~h_k | (torch.isfinite(t_re)
                  & ((t_re - t_k).abs() <= 1e-5 * t_k.abs())))
    if not bool(ok.all()):
        raise SystemExit(f"phase tri-traverse: {name}: {int((~ok).sum())} "
                         f"returned t are no hit of their triangle")
    run = lambda: tri_kernel.traverse(tt, rays, plan_t, RB, any_hit)
    Rp, B = rays.shape[1], rays.shape[1] // RB
    visits = int(plan.actual.sum())
    warp_pass, block_pass = (int(stats["group_clusters_tested"]),
                             int(stats["clusters_tested"]))
    block_cull_pass = int(stats_b["clusters_tested"])
    candidates = int(stats["group_candidates"])
    tests = warp_pass * G * tri_kernel.K
    kernel_tests = candidates * G * tri_kernel.K  # what the kernel runs
    slab = SLAB_FLOPS * visits * tri_kernel.SUP * RB
    t_ops = (MT_FLOPS * tests + slab) / F32_FLOPS
    t_ops_b = (MT_FLOPS * block_cull_pass * RB * tri_kernel.K
               + slab) / F32_FLOPS
    t_bytes = (4 * (tt.table.numel() + 6 * tt.cl_min.shape[0]
                    + 2 * int(plan.total) + B + 1) + 40 * Rp + 4 * B) \
        / HBM_BYTES_PER_S
    sass = info["sass"]
    floor_ms = (kernel_tests * sass["per_test"] / (SMS * LANES * clock_hz)
                * 1e3 if sass and clock_hz else None)
    row = dict(name=name, route="cuda", source=TRAVERSE_SRC,
               replaces=TRAVERSE_TPU, launches=0, max_abs_err=err,
               ms=time_cuda(run, 5), plain_ms=plain_s * 1e3,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=None, block_cull_bound_ms=max(t_ops_b, t_bytes)
               * 1e3, instruction_floor_ms=floor_ms, rays=R, blocks=B,
               visits_planned_per_block=int(plan.total) / B,
               visits_per_block=visits / B, tests=tests,
               kernel_tests=kernel_tests, warp_cluster_passes=warp_pass,
               warp_cluster_candidates=candidates,
               block_cluster_passes=block_pass,
               block_cull_cluster_passes=block_cull_pass,
               clusters_tested_per_block=block_pass / B,
               rays_differing_from_block_cull=n_differ,
               plain_block_cull_ms=plain_b_s * 1e3,
               hit_fraction=h_k.float().mean().item(),
               equal_to_plain=same)
    if clock_hz:
        row["lane_cycles_per_test"] = (row["ms"] * 1e-3 * SMS * LANES
                                       * clock_hz / kernel_tests)
    log(f"phase tri-traverse: {name}: {R} rays in {B} blocks, hits equal"
        f"{', t, slots and visits equal' if same else ''}, max |t - plain "
        f"t| {err:.3e}; visits a block "
        f"{row['visits_per_block']:.2f} executed of "
        f"{row['visits_planned_per_block']:.2f} planned; cull passes "
        f"(warp, cluster) {warp_pass} = {warp_pass / B:.2f} a block "
        f"({warp_pass * G / (B * RB):.2f} clusters a ray), (block, "
        f"cluster) {block_pass} = {block_pass / B:.2f} a block; the "
        f"kernel's candidates (with the best before the visit) {candidates}"
        f" = {candidates / B:.2f} a block; the block "
        f"cull's (block, cluster) {block_cull_pass} = "
        f"{block_cull_pass / B:.2f} a block; rays differing from the block "
        f"cull {n_differ} ("
        + ("any hit: hit masks equal)" if any_hit
           else "all ties at rtol 1e-5)"))
    log(f"phase tri-traverse: {name}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.1f} ms (block cull {plain_b_s * 1e3:.1f} ms), "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; the block "
        f"cull's {row['block_cull_bound_ms']:.4f} ms), instruction floor "
        + (f"{floor_ms:.4f} ms ({kernel_tests} tests run x "
           f"{sass['per_test']:.2f} "
           f"instructions / ({SMS} SMs x {LANES} lanes x "
           f"{clock_hz / 1e6:.0f} MHz)), "
           f"{row['lane_cycles_per_test']:.1f} lane-cycles a test run"
           if floor_ms else "not measured"))
    return row


def tri_phases(torch, rows):
    """tri-cast, tri-traverse and tri-render (see the module docstring).
    Appends the Q2.7 and Q2.8 rows to `rows`; returns the figures."""
    from gsrt_torch import RenderConfig, _kernels
    from gsrt_torch.core.types import look_at, make_camera
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.ops import tri_binning, tri_bvh, tri_kernel

    W, H = WIDTH, HEIGHT
    camera = make_camera(look_at((0, 0, -7.0), (0, 0, 0.0)), 55.0, W, H,
                         device=DEVICE)
    cfg = RenderConfig(width=W, height=H, samples=PT_SAMPLES,
                       bounces=PT_BOUNCES)
    t0 = time.perf_counter()
    soup = pt.with_tri_table(tri_scene(tri_soup(SOUP_TRIS, SOUP_SD)))
    tt = soup.tri_table
    torch.cuda.synchronize()
    log(f"phase tri-cast: soup359k {SOUP_TRIS} triangles, "
        f"{tt.cl_min.shape[0]} clusters, {tt.sup_min.shape[0]} "
        f"super-clusters, made and clustered in "
        f"{time.perf_counter() - t0:.2f} s")
    sh = lambda **kw: pt.render_shadow_rays(  # noqa: E731
        soup, camera, cfg, LIGHT_POS, LIGHT_RADIUS, seed=SEED,
        return_flags=True, **kw)

    # --- tri-cast: capture the SH render's cast, expand and occlusion
    # calls ---
    with Recorder(tri_binning, "cast_primary") as rec_cast, \
            Recorder(tri_binning, "expand_pairs_fused") as rec_x, \
            Recorder(tri_kernel, "closest_hit_packed") as rec_trav:
        sh()
        torch.cuda.synchronize()
    if len(rec_cast.calls) != 1 or len(rec_x.calls) != 1 or \
            len(rec_trav.calls) != cfg.shadow_rays:
        raise SystemExit("phase tri-cast: expected one cast, one expand "
                         "and one traversal per shadow ray in the SH "
                         "render")
    (binning, dirs, origin), cast_kw = rec_cast.calls[0]
    clock_hz = max_sm_clock_hz()
    tri_rows = {"cast_primary": cast_row(torch, "cast_primary", binning,
                                         dirs, origin, cast_kw, clock_hz)}
    tri_rows["cast_primary"]["at"] = "soup359k, rect spans, 32x16 tiles"
    v = (soup.tri_v0, soup.tri_v1, soup.tri_v2)
    need = tri_binning.count_tri_pairs_numpy(*v, camera, tile_w=cfg.tile_w,
                                             tile_h=cfg.tile_h,
                                             span_exact=True)
    with Recorder(tri_binning, "expand_pairs_fused") as rec_xe:
        exact = tri_binning.build_tri_binning(
            *v, camera, tile_w=cfg.tile_w, tile_h=cfg.tile_h,
            max_pairs=int(need * 1.2) + 1024, span_exact=True)
    tri_rows["cast_primary[exact]"] = cast_row(
        torch, "cast_primary[exact]", exact, dirs, origin, cast_kw,
        clock_hz)
    tri_rows["cast_primary[exact]"]["at"] = \
        "soup359k, exact spans, 32x16 tiles"
    del exact
    # the triangle binning's 15-row copies: one a rect binning, two with
    # exact spans (triangles to tile rows, rows to pairs)
    x_names = ("expand_pairs_fused[tri]", "expand_pairs_fused[tri,rows]",
               "expand_pairs_fused[tri,pairs]")
    for row in (tri_expand_rows(torch, rec_x.calls, x_names[:1],
                                "soup359k, rect spans")
                + tri_expand_rows(torch, rec_xe.calls, x_names[1:],
                                  "soup359k, exact spans")):
        tri_rows[row["name"]] = row
    del rec_x, rec_xe

    # bigtris at 16x8 tiles, rect and exact; the binned primary cast
    # (binning + cast) timed as tools/tri_bench.py times it
    big_v = tuple(torch.as_tensor(a, device=DEVICE)
                  for a in tri_soup(BIGTRIS, 1.0))
    cfg16 = RenderConfig(width=W, height=H, tile_w=16, tile_h=8)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    _, big_dirs = pt.generate_camera_rays(gen, camera, cfg16)
    big_kw = dict(width=W, height=H, tile_w=16, tile_h=8,
                  t_min=cfg16.t_min, t_max=cfg16.t_max)
    bigtris = {}
    for span_exact in (False, True):
        name = "cast_primary[bigtris" + (",exact]" if span_exact else "]")
        need = tri_binning.count_tri_pairs_numpy(
            *big_v, camera, tile_w=16, tile_h=8, span_exact=span_exact)
        mp = int(need * 1.2) + 1024

        def binned(span_exact=span_exact, mp=mp):
            b = tri_binning.build_tri_binning(
                *big_v, camera, tile_w=16, tile_h=8, max_pairs=mp,
                span_exact=span_exact)
            return b, tri_binning.cast_primary(b, big_dirs, camera.position,
                                               **big_kw)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        b, _ = binned()
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        if counts["cast_primary"] != 1 or bool(b.overflow):
            raise SystemExit(f"phase tri-cast: {name}: launches {counts}, "
                             f"overflow {bool(b.overflow)}")
        tri_rows[name] = cast_row(torch, name, b, big_dirs, camera.position,
                                  big_kw, clock_hz)
        tri_rows[name]["launches"] = counts["cast_primary"]
        tri_rows[name]["at"] = (f"bigtris, {'exact' if span_exact else 'rect'}"
                                f" spans, 16x8 tiles")
        fig = bigtris["exact" if span_exact else "rect"] = dict(
            pairs_needed=need, max_pairs=mp,
            binned_primary_ms=time_cuda(binned, 8))
        log(f"phase tri-cast: {name}: binned primary (binning + cast) "
            f"{fig['binned_primary_ms']:.4f} ms, launches {counts}")
        del b

    # --- tri-traverse: closest hit on PT's first bounce wave (as the path
    # hands it over: coherence-sorted, retired rays parked) and on the
    # 1080p primary bundle (bounce 0 of primary_impl "block"); any hit on
    # the SH render's first shadow bundle ---
    with Recorder(tri_bvh, "closest_hit_bvh") as rec_pt:
        pt.render_path_traced(soup, camera, cfg, seed=SEED)
        torch.cuda.synchronize()
    if len(rec_pt.calls) != cfg.bounces - 1:
        raise SystemExit("phase tri-traverse: expected one per-ray walk per "
                         "bounce after the first in the PT render")
    (_, *wave), _ = rec_pt.calls[0]
    wave_kw = {}
    del rec_pt
    info = traverse_kernel_info(RB)
    sass = info["sass"]
    log(f"phase tri-traverse: kernel build: {info['registers']} registers, "
        f"{info['spill_bytes']} bytes spilled a thread, "
        f"{info['static_smem_bytes']} B static + "
        f"{info['dynamic_smem_bytes']} B dynamic shared memory, "
        f"{info['blocks_per_sm']} blocks of {RB} threads an SM; SASS "
        + (f"per-triangle loop {sass['instructions']} instructions for "
           f"{sass['tests']} tests ({sass['per_test']:.2f} a test)"
           if sass else "not read (no cuobjdump)")
        + f"; top SM clock "
        + (f"{clock_hz / 1e6:.0f} MHz" if clock_hz else "not read"))
    tri_rows["closest_hit_packed"] = traverse_row(
        torch, "closest_hit_packed", tt, tuple(wave), wave_kw, info,
        clock_hz)
    tri_rows["closest_hit_packed"]["at"] = \
        "soup359k, the PT render's first bounce wave (which the per-ray " \
        "tree now takes)"
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    orig, dirn = pt.generate_camera_rays(gen, camera, cfg)
    tri_rows["closest_hit_packed[primary]"] = traverse_row(
        torch, "closest_hit_packed[primary]", tt,
        (orig, dirn, cfg.t_min, cfg.t_max), {}, info, clock_hz)
    tri_rows["closest_hit_packed[primary]"]["at"] = \
        "soup359k, the 1080p primary bundle"
    (_, *any_args), any_kw = rec_trav.calls[0]
    tri_rows["closest_hit_packed_any"] = traverse_row(
        torch, "closest_hit_packed_any", tt, tuple(any_args), any_kw, info,
        clock_hz)
    tri_rows["closest_hit_packed_any"]["at"] = \
        "soup359k, the SH render's first shadow bundle"
    del rec_cast, rec_trav, binning, dirs, orig, dirn, wave

    # --- tri-render: SH, AO and PT through their entry points, counts
    # set to 0 just before each and read just after ---
    renders = {
        "SH": sh,
        "AO": lambda: pt.render_ambient_occlusion(
            soup, camera, cfg, seed=SEED, ao_radius=AO_RADIUS,
            return_flags=True),
        "PT": lambda: pt.render_path_traced(soup, camera, cfg, seed=SEED,
                                            return_flags=True),
        "SH[exact]": lambda: sh(tri_span_exact=True),
        "SH[block]": lambda: sh(primary_impl="block")}
    want = {"SH": ("closest_hit_packed_any",),
            "AO": ("closest_hit_packed_any",),
            "PT": ("closest_hit_bvh",),
            "SH[exact]": ("closest_hit_packed_any",),
            "SH[block]": ("closest_hit_packed", "closest_hit_packed_any")}
    figures, launches = {}, {}
    for name, render in renders.items():
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        start.record()
        img, flags = render()
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        counts = _kernels.launch_counts()
        flags = {k: bool(v) for k, v in flags.items()}
        log(f"phase tri-render: {name}: {start.elapsed_time(end):.3f} ms on "
            f"the card's clock, {host_ms:.3f} ms on the host's; launches "
            f"{counts}; flags {flags}; mean colour "
            f"{img.mean().item():.7f}"
            + (f" (the block-cull kernel's: {BLOCK_CULL_MEANS[name]:.7f})"
               if name in BLOCK_CULL_MEANS else ""))
        casts = int(name != "SH[block]")
        expands = casts * (2 if name == "SH[exact]" else 1)
        if counts["cast_primary"] != casts or \
                any(counts[k] <= 0 for k in want[name]) or \
                counts["expand_pairs_fused"] != expands:
            raise SystemExit(f"phase tri-render: {name} did not run its "
                             f"kernels: {counts}")
        if any(flags.values()):
            raise SystemExit(f"phase tri-render: {name} overflowed: {flags}")
        if img.shape != (H, W, 3) or not torch.isfinite(img).all() or \
                not 0.01 < img.mean().item() < 0.99:
            raise SystemExit(f"phase tri-render: {name} image is off")
        figures[name] = dict(ms=start.elapsed_time(end), host_ms=host_ms,
                             launches=counts, mean=img.mean().item())
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + (v if name in ("SH", "AO",
                                                              "PT") else 0)
    # where a render's time goes: CUDA events at its stage boundaries, then
    # the kernels' device time from torch.profiler over one more render
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    traverse = tri_kernel.traverse
    for name in ("SH", "AO", "PT"):
        actuals = []        # each traversal launch's visits a block

        def recorded(*args):
            out = traverse(*args)
            actuals.append(out[2])
            return out
        tri_kernel.traverse = recorded
        stamps = Stamps(torch)
        stamps.wrap(tri_binning, "build_tri_binning", "binning")
        stamps.wrap(tri_binning, "cast_primary", "cast")
        stamps.wrap(tri_kernel, "plan_visits", "plan")
        stamps.wrap(tri_kernel, "traverse", "traverse")
        stamps.wrap(tri_bvh, "closest_hit_bvh", "per-ray")
        try:
            stamps.mark("render:start")
            renders[name]()
            stamps.mark("render:end")
        finally:
            stamps.restore()
            tri_kernel.traverse = traverse
        split, launch_ms = {}, []
        for label, ms in stamps.intervals():
            stage, edge = label.split(":")
            key = stage if edge == "end" and stage != "render" else "other"
            split[key] = split.get(key, 0.0) + ms
            if label == "traverse:end":
                launch_ms.append(ms)
        visits = [a.float().mean().item() for a in actuals]
        figures[name]["traverse_launches"] = [
            dict(ms=ms, visits_per_block=v) for ms, v in zip(launch_ms,
                                                              visits)]
        log(f"phase tri-render: {name} traversal launches (card ms, visits "
            f"a block): " + ", ".join(f"{ms:.2f} ({v:.1f})" for ms, v in
                                       zip(launch_ms, visits)))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            renders[name]()
            torch.cuda.synchronize()
        # the device's own events (kernels, copies, fills), as the
        # profiler's table sums them; the CPU ops that launched them are
        # not counted again
        device_ms = {e.key: e.self_device_time_total / 1e3
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)}
        busy = sum(device_ms.values())
        top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:4]
        figures[name].update(
            split_ms=split, device_busy_ms=busy,
            device_busy_share=busy / figures[name]["ms"] if busy else None,
            top_device_ms=dict(top) if busy else None)
        log(f"phase tri-render: {name} split (card ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + (f"; profiler: device busy {busy:.3f} ms, "
               f"{busy / figures[name]['ms']:.3f} of the render; top "
               + ", ".join(f"{k} {v:.3f}" for k, v in top)
               if busy else "; profiler: no device time, busy share not "
               "measured"))

    tri_rows["cast_primary"]["launches"] = launches["cast_primary"]
    tri_rows["cast_primary[exact]"]["launches"] = \
        figures["SH[exact]"]["launches"]["cast_primary"]
    # one rect binning's expand in each of SH, AO and PT; the exact
    # binning's two (one each shape) in SH with exact spans
    tri_rows["expand_pairs_fused[tri]"]["launches"] = \
        launches["expand_pairs_fused"]
    for k in x_names[1:]:
        tri_rows[k]["launches"] = \
            figures["SH[exact]"]["launches"]["expand_pairs_fused"] // 2
    for k in ("closest_hit_packed", "closest_hit_packed_any"):
        tri_rows[k]["launches"] = launches[k]
    tri_rows["closest_hit_packed[primary]"]["launches"] = \
        figures["SH[block]"]["launches"]["closest_hit_packed"]
    rows += list(tri_rows.values())
    return dict(width=W, height=H, soup_triangles=SOUP_TRIS,
                clusters=tt.cl_min.shape[0],
                super_clusters=tt.sup_min.shape[0], renders=figures,
                pt_samples=PT_SAMPLES, pt_bounces=PT_BOUNCES,
                bigtris=bigtris)


def bvh_kernel_info() -> dict:
    """The per-ray kernel's build (gsrt_tri_bvh_info) and its spills
    (nvcc -Xptxas -v, where this run built it)."""
    import ctypes
    from gsrt_torch import _kernels
    fn = _kernels._load("tri_bvh").gsrt_tri_bvh_info
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_int * 6)()
    if fn(buf) != 0:
        raise SystemExit("gsrt_tri_bvh_info failed")
    info = dict(zip(("registers", "static_smem_bytes", "local_bytes",
                     "blocks_per_sm", "threads", "grid_blocks"), buf))
    rep = ptxas_report(_kernels.build.last_log, "tri_bvh", "tri_bvh_kernel")
    info["spill_bytes"] = next(iter(rep.values())).get("spill_bytes") \
        if rep else None
    return info


def bathroom_setup(torch) -> dict:
    """bathroom-pt's scene on the card with its table and tree, timed:
    {"scene", "cam", "cfg", "kw" (render_path_traced's), "triangles",
    "table_s", "tree_s"}."""
    import json
    from benchmark import counts as bench_counts
    from benchmark import port, tri_scene as bathroom
    from gsrt_torch import RenderConfig
    from gsrt_torch.interop import scene_from_numpy
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.ops import tri_binning, tri_bvh
    with open(BVH_CONFIG) as f:
        c = json.load(f)
    W, H = c["frame"]["width"], c["frame"]["height"]
    s = bathroom.build(c["triangles"], W, H, c["assumed"]["scene_seed"])
    scene = scene_from_numpy(s.fields(), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = pt.with_tri_table(scene)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tri_bvh.build_tri_bvh(scene.tri_table)
    torch.cuda.synchronize()
    tree_s = time.perf_counter() - t0
    cam = port.camera(s.view, DEVICE)
    cfg = RenderConfig(width=W, height=H, samples=1, bounces=c["bounces"],
                       t_min=c["t_min"], t_max=c["t_max"], **c["render"])
    need = tri_binning.count_tri_pairs_numpy(s.v0, s.v1, s.v2, cam,
                                             tile_w=cfg.tile_w,
                                             tile_h=cfg.tile_h)
    kw = dict(seed=SEED, primary_impl="binned", return_flags=True,
              tri_max_pairs=bench_counts.pair_bucket(int(need * 1.1)))
    return dict(scene=scene, cam=cam, cfg=cfg, kw=kw, triangles=s.n,
                table_s=table_s, tree_s=tree_s)


def bathroom_waves(torch) -> dict:
    """bathroom-pt's scene on the card (its configuration's triangles,
    frame and bounces), its table and tree built and timed, and one
    path-traced frame (after a warm-up) with every per-ray call recorded:
    {"scene", "table", "calls" (one (args, kw) a wave after bounce 0),
    "launches" (the kernel's, read in that frame), "triangles", "width",
    "height", "bounces", "table_s", "tree_s", "frame_ms", "flags"}."""
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.ops import tri_bvh
    b = bathroom_setup(torch)
    scene, cam, cfg, kw = b["scene"], b["cam"], b["cfg"], b["kw"]
    W, H = cfg.width, cfg.height
    pt.render_path_traced(scene, cam, cfg, **kw)             # warm-up
    with Recorder(tri_bvh, "closest_hit_bvh") as rec:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _, flags = pt.render_path_traced(scene, cam, cfg, **kw)
        end.record()
        torch.cuda.synchronize()
    flags = {k: bool(v) for k, v in flags.items()}
    launches = rec.launched("closest_hit_bvh")
    if len(rec.calls) != cfg.bounces - 1 or launches != cfg.bounces - 1 \
            or any(flags.values()):
        raise SystemExit(f"phase tri-bvh: want one per-ray launch a wave "
                         f"after bounce 0, no flag: {len(rec.calls)} calls, "
                         f"flags {flags}")
    return dict(scene=scene, table=scene.tri_table, calls=rec.calls,
                launches=launches, triangles=b["triangles"], width=W,
                height=H, bounces=cfg.bounces, table_s=b["table_s"],
                tree_s=b["tree_s"], frame_ms=start.elapsed_time(end),
                flags=flags)


def bvh_phase(torch, rows) -> dict:
    """tri-bvh (see the module docstring). Appends the per-ray kernel's
    rows, one a timed wave; returns the figures."""
    from gsrt_torch.ops import tri_bvh, tri_kernel
    got = bathroom_waves(torch)
    tt, W, H = got["table"], got["width"], got["height"]
    bvh = tt.bvh
    table_s, tree_s, frame_ms = got["table_s"], got["tree_s"], got["frame_ms"]
    launches = got["launches"]
    info = bvh_kernel_info()
    log(f"phase tri-bvh: {got['triangles']} triangles, {bvh.n_leaves} leaves, "
        f"{bvh.nodes.shape[0]} nodes ({bvh.nodes.numel() * 4} B), depth "
        f"{bvh.depth}; table {table_s:.2f} s with the tree, the tree "
        f"alone {tree_s:.2f} s; a {W}x{H} frame {frame_ms:.1f} ms on the "
        f"card's clock; build {info}")
    waves = {}
    for b in BVH_WAVES:
        (_, *args), _ = got["calls"][b - 1]
        R = args[0].shape[0]
        counts = torch.zeros(3, dtype=torch.int64, device=DEVICE)
        t_k, s_k, h_k = tri_bvh.closest_hit_bvh(tt, *args, counts=counts)
        nodes, tests, entered = counts.tolist()
        ms = time_cuda(lambda: tri_bvh.closest_hit_bvh(tt, *args), 10)
        perm = torch.randperm(R, device=DEVICE)
        shuffled = [a[perm] if torch.is_tensor(a) and a.dim() else a
                    for a in args]
        shuffled_ms = time_cuda(
            lambda: tri_bvh.closest_hit_bvh(tt, *shuffled), 5)
        t_q, s_q, _, _ = tri_kernel.closest_hit_packed(tt, *args)
        q_ms = time_cuda(lambda: tri_kernel.closest_hit_packed(tt, *args),
                         3)
        idx = torch.arange(0, R, BVH_PLAIN_STRIDE, device=DEVICE)
        sub = [a[idx] if torch.is_tensor(a) and a.dim() else a for a in args]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_p, s_p, _ = tri_bvh.closest_hit_bvh_plain(tt, *sub)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if not (torch.equal(t_k[idx].view(torch.int32),
                            t_p.view(torch.int32))
                and torch.equal(s_k[idx], s_p)):
            raise SystemExit(f"phase tri-bvh: bounce {b}: the kernel "
                             f"differs from its plain version")
        if bool((t_k > t_q).any()):
            raise SystemExit(f"phase tri-bvh: bounce {b}: a hit farther "
                             f"than the block walk's")
        differ = (t_k != t_q) | (s_k != s_q)
        name = f"closest_hit_bvh[bounce {b}]"
        row = dict(
            name=name, route="cuda", source=BVH_SRC,
            replaces="none (the block walk, csrc/tri_kernel.cu, on the "
            "PT's later waves)", launches=launches, max_abs_err=0.0,
            ms=ms, plain_ms=plain_s * 1e3, plain_rays=idx.numel(),
            bound_ms=None, library_ms=None,
            block_walk_ms=q_ms, shuffled_ms=shuffled_ms, rays=R,
            rays_entered=entered, nodes_per_ray=nodes / max(entered, 1),
            tests_per_ray=tests / max(entered, 1),
            rays_differing_from_block_walk=int(differ.sum()),
            nearer_than_block_walk=int((t_k < t_q).sum()),
            hit_fraction=h_k.float().mean().item(), build=info,
            at=f"bathroom-pt's scene, {W}x{H}, the wave of bounce {b} as "
            f"the path hands it over (coherence-sorted, retired rays "
            f"parked)")
        rows.append(row)
        waves[b] = row
        log(f"phase tri-bvh: {name}: {R} rays, {entered} entered the tree, "
            f"{row['nodes_per_ray']:.2f} nodes and {row['tests_per_ray']:.2f}"
            f" tests a ray; kernel {ms:.3f} ms ({shuffled_ms:.3f} shuffled), "
            f"the block walk {q_ms:.3f} ms; plain (brute force) on "
            f"{idx.numel()} rays bit-equal, {row['plain_ms']:.0f} ms on "
            f"those rays; rays differing from the block walk "
            f"{row['rays_differing_from_block_walk']} "
            f"({row['nearer_than_block_walk']} nearer)")
    return dict(triangles=got["triangles"], leaves=bvh.n_leaves,
                depth=bvh.depth,
                node_bytes=bvh.nodes.numel() * 4, table_s=table_s,
                tree_s=tree_s, frame_ms=frame_ms, build=info,
                waves={str(b): {k: v for k, v in r.items() if k != "build"}
                       for b, r in waves.items()})


def pt_shade_info() -> dict:
    """The shading kernel's build (gsrt_pt_shade_info) and its spills
    (nvcc -Xptxas -v, where this run built it)."""
    import ctypes
    from gsrt_torch import _kernels
    fn = _kernels._load("pt_shade").gsrt_pt_shade_info
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_int * 4)()
    if fn(buf) != 0:
        raise SystemExit("gsrt_pt_shade_info failed")
    info = dict(zip(("registers", "static_smem_bytes", "local_bytes",
                     "blocks_per_sm"), buf))
    rep = ptxas_report(_kernels.build.last_log, "pt_shade",
                       "pt_shade_kernel")
    info["spill_bytes"] = next(iter(rep.values())).get("spill_bytes") \
        if rep else None
    return info


def pt_shade_phase(torch, rows) -> dict:
    """pt-shade (see the module docstring). Appends the shading kernel's
    rows, one a timed wave; returns the figures."""
    from gsrt_torch import _kernels
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.ops import pt_shade
    b = bathroom_setup(torch)
    scene, cam, cfg, kw = b["scene"], b["cam"], b["cfg"], b["kw"]
    pt.render_path_traced(scene, cam, cfg, **kw)             # warm-up
    captured, calls = {}, [0]
    shade_wave = pt.shade_wave

    def capture(gen, mats, *wave):
        if calls[0] in PT_SHADE_WAVES:
            captured[calls[0]] = (gen.get_state(), mats, [
                a.clone() if torch.is_tensor(a) else a for a in wave])
        calls[0] += 1
        return shade_wave(gen, mats, *wave)
    _kernels.reset_launch_counts()
    with Replaced(pt, "shade_wave", capture):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _, flags = pt.render_path_traced(scene, cam, cfg, **kw)
        end.record()
        torch.cuda.synchronize()
    launches = _kernels.launch_counts()["pt_shade"]
    if launches != cfg.bounces or calls[0] != cfg.bounces \
            or any(bool(v) for v in flags.values()):
        raise SystemExit(f"phase pt-shade: want one launch a wave: "
                         f"{launches} launches, {calls[0]} waves, flags "
                         f"{flags}")
    frame_ms = start.elapsed_time(end)
    info = pt_shade_info()
    log(f"phase pt-shade: {b['triangles']} triangles, {cfg.width}x"
        f"{cfg.height}, {cfg.bounces} bounces: a frame {frame_ms:.1f} ms on "
        f"the card's clock, {launches} launches; build {info}")

    def generator(state):
        g = torch.Generator(device=DEVICE)
        g.set_state(state)
        return g

    def fresh(wave):
        return [a.clone() if torch.is_tensor(a) else a for a in wave]
    out = {}
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t  # noqa
    for bounce in PT_SHADE_WAVES:
        state, mats, wave = captured[bounce]
        R = wave[0].shape[0]
        got = pt_shade.shade_wave(generator(state), mats, *fresh(wave))
        want = pt._shade_plain(generator(state), mats, *fresh(wave))
        torch.cuda.synchronize()
        differ = {k: int((bits(g) != bits(w)).sum()) for k, g, w in zip(
            ("orig", "dirn", "ray_color", "out_color", "active"), got, want)}
        if any(differ.values()):
            raise SystemExit(f"phase pt-shade: bounce {bounce}: the kernel "
                             f"differs from its plain version: {differ}")
        g = generator(state)
        unit, uni = pt._random_unit(g, (R, 3)), pt._uniform(g, (R,))
        work = fresh(wave)

        def kernel():
            pt_shade._launch(mats, *work[:9], unit, uni, work[9], work[10])
        ms = time_cuda(kernel, 20)
        wave_ms = time_cuda(
            lambda: pt_shade.shade_wave(generator(state), mats, *work), 10)
        plain_ms = time_cuda(
            lambda: pt._shade_plain(generator(state), mats, *wave), 3)
        bytes_moved = PT_SHADE_RAY_BYTES * R
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        live = int(wave[6].sum())
        name = f"pt_shade[bounce {bounce}]"
        row = dict(
            name=name, route="cuda", source=PT_SHADE_SRC, replaces=None,
            launches=launches, max_abs_err=0.0, ms=ms, wave_ms=wave_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
            library_ms=None, bytes=bytes_moved, rays=R, live=live,
            hit=int(wave[3].sum()), build=info,
            at=f"bathroom-pt's scene, {cfg.width}x{cfg.height}, the wave of "
            f"bounce {bounce} as the path hands it to the shading")
        rows.append(row)
        out[str(bounce)] = {k: v for k, v in row.items() if k != "build"}
        log(f"phase pt-shade: {name}: {R} rays, {live} live, {row['hit']} "
            f"hit; bitwise equal to the plain version; kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({PT_SHADE_RAY_BYTES} B a ray, "
            f"{bound_ms / ms:.1%} of it); with the draws {wave_ms:.4f} ms; "
            f"plain {plain_ms:.3f} ms")
    return dict(frame_ms=frame_ms, launches=launches, build=info,
                waves=out)


def splat_bvh_info() -> dict:
    """The splat tree kernel's build (gsrt_splat_bvh_info) and its spills
    (nvcc -Xptxas -v, where this run built it)."""
    import ctypes
    from gsrt_torch import _kernels
    fn = _kernels._load("splat_bvh").gsrt_splat_bvh_info
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_int * 6)()
    if fn(buf) != 0:
        raise SystemExit("gsrt_splat_bvh_info failed")
    info = dict(zip(("registers", "static_smem_bytes", "local_bytes",
                     "blocks_per_sm", "threads", "grid_blocks"), buf))
    rep = ptxas_report(_kernels.build.last_log, "splat_bvh",
                       "splat_bvh_kernel")
    info["spill_bytes"] = next(iter(rep.values())).get("spill_bytes") \
        if rep else None
    return info


def splat_bvh_phase(torch, rows) -> dict:
    """splat-bvh (see the module docstring). Appends the splat tree
    kernel's rows, one a view; returns the figures."""
    import dataclasses
    from benchmark import port, rt_roofline, scene
    from gsrt_torch import _kernels
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.ops import splat_bvh
    with open(SPLAT_BVH_CONFIG) as f:
        c = json.load(f)
    with open(SPLAT_BVH_MIX) as f:
        mix = json.load(f)
    a = c["assumed"]
    W, H = c["width"], c["height"]
    t0 = time.perf_counter()
    cl = scene.random_cloud(
        c["splats"], SEED, DEVICE, extent=a["extent"],
        scale_range=a["scale_range"], opacity_range=a["opacity_range"],
        sh_degree=c["sh_degree"], scene_seed=a["scene_seed"])
    cloud = port.cloud(cl, scene.cov3d(cl.quats, cl.scales))
    cfg = port.render_config(c)
    n = int(mix["views"])
    cams = [port.camera(v, DEVICE) for v in scene.orbit_from_mix(
        mix["orbit"], [360.0 * i / n for i in SPLAT_BVH_VIEWS], W, H)]
    torch.cuda.synchronize()
    cloud_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = splat_bvh.build_splat_bvh(cloud, cfg)
    torch.cuda.synchronize()
    tree_s = time.perf_counter() - t0
    info = splat_bvh_info()
    tree_bytes = 4 * (tree.nodes.numel() + tree.slots.numel())
    log(f"phase splat-bvh: {cloud.n} splats ({tree.n_splats} above the "
        f"threshold), {tree.n_leaves} leaves, {tree.nodes.shape[0]} nodes, "
        f"depth {tree.depth}, {tree_bytes} B; cloud {cloud_s:.2f} s, tree "
        f"{tree_s:.2f} s; build {info}")
    tree_splats = tree.n_splats
    del tree
    tracer = grt.GaussianRayTracer(cfg, "traced", device=DEVICE)
    tracer(cloud, cams[0])                       # builds the tree; warm-up
    torch.cuda.synchronize()
    out = {}
    for vi, cam in zip(SPLAT_BVH_VIEWS, cams):
        _kernels.reset_launch_counts()
        with Recorder(grt, "trace_gaussian_rays_bvh") as rec:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            frame = tracer(cloud, cam)
            end.record()
            torch.cuda.synchronize()
        launches = rec.launched("trace_gaussian_rays_bvh")
        if len(rec.calls) != 1 or launches != 1:
            raise SystemExit(f"phase splat-bvh: view {vi}: want one launch "
                             f"a frame: {len(rec.calls)} calls, {launches} "
                             f"launches")
        frame_ms = start.elapsed_time(end)
        (tree, o, d, _, colors), _ = rec.calls[0]
        R = o.shape[0]
        counts = torch.zeros(5, dtype=torch.int64, device=DEVICE)
        trans, color, hits, passes = splat_bvh.trace_gaussian_rays_bvh(
            tree, o, d, cfg, colors, counts=counts)
        nodes, tests, walks, blended, replays = counts.tolist()
        if not (torch.equal(hits.reshape(H, W), frame.hits)
                and torch.equal(color.reshape(H, W, 3), frame.color)):
            raise SystemExit(f"phase splat-bvh: view {vi}: a second launch "
                             f"differs from the frame's")
        ms = time_cuda(lambda: splat_bvh.trace_gaussian_rays_bvh(
            tree, o, d, cfg, colors), 3)
        idx = torch.arange(0, R, SPLAT_BVH_PLAIN_STRIDE, device=DEVICE)
        plain_cfg = dataclasses.replace(
            cfg, splat_chunk=SPLAT_BVH_PLAIN_PAIRS // idx.numel())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_trans, p_color, p_hits, p_passes = \
            splat_bvh.trace_gaussian_rays_bvh_plain(
                tree, o[idx], d[idx], plain_cfg, colors)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max_abs_err(color[idx] - p_color, trans[idx] - p_trans)
        hits_off = int((hits[idx] != p_hits).sum())
        passes_off = int((passes[idx] != p_passes).sum())
        if hits_off or passes_off or not err <= SPLAT_BVH_TOL:
            raise SystemExit(
                f"phase splat-bvh: view {vi}: the kernel differs from its "
                f"plain version on {idx.numel()} rays: hits on {hits_off}, "
                f"passes on {passes_off}, max |colour, trans| {err:.3e}")
        total_hits = int(hits.sum())
        t_ops = rt_roofline.HIT_FLOPS * total_hits / F32_FLOPS
        t_bytes = (rt_roofline.SPLAT_BYTES * tree.n_splats
                   + rt_roofline.RAY_BYTES * R) / HBM_BYTES_PER_S
        bound_ms = rt_roofline.least_seconds(total_hits, tree.n_splats,
                                             R) * 1e3
        name = f"trace_gaussian_rays_bvh[view {vi}]"
        row = dict(
            name=name, route="cuda", source=SPLAT_BVH_SRC,
            replaces="none (the k-buffer of free rays is plain jnp in the "
            "JAX package)", launches=launches, max_abs_err=err, ms=ms,
            frame_ms=frame_ms, plain_ms=plain_s * 1e3,
            plain_rays=idx.numel(), bound_ms=bound_ms,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None,
            rays=R, hits_per_ray=total_hits / R,
            passes_per_ray=int(passes.sum()) / R, walks_per_ray=walks / R,
            replays_per_ray=replays / R, nodes_per_ray=nodes / R,
            tests_per_ray=tests / R, tests_per_hit=tests / max(blended, 1),
            build=info, at=f"m360-rt's cloud, {W}x{H}, orbit view {vi} of "
            f"{n}")
        rows.append(row)
        out[str(vi)] = {k: v for k, v in row.items() if k != "build"}
        log(f"phase splat-bvh: {name}: {R} rays, {row['hits_per_ray']:.1f} "
            f"hits, {row['passes_per_ray']:.2f} passes, "
            f"{row['walks_per_ray']:.2f} walks and "
            f"{row['replays_per_ray']:.2f} replays, "
            f"{row['nodes_per_ray']:.0f} nodes and "
            f"{row['tests_per_ray']:.0f} tests a ray "
            f"({row['tests_per_hit']:.1f} a hit); frame {frame_ms:.1f} ms, "
            f"{launches} launch; kernel {ms:.1f} ms at {info['registers']} "
            f"registers, {info['static_smem_bytes']} B shared, "
            f"{info['local_bytes']} B local, {info['blocks_per_sm']} blocks "
            f"an SM; bound {bound_ms:.3f} ms ({row['bound_by']}, "
            f"{bound_ms / ms:.3%} of it); plain (brute force) on "
            f"{idx.numel()} rays: hits and passes equal, max |colour, "
            f"trans| {err:.2e}, {plain_s:.1f} s on those rays")
    return dict(splats=cloud.n, tree_splats=tree_splats,
                tree_bytes=tree_bytes, cloud_s=cloud_s, tree_s=tree_s,
                build=info, views=out)


# --- the scenes phase: the catalog, foveated PT, the foliage field ---

# the catalog at its factories' sizes: (factory, width, height, kwargs)
CATALOG = {"rtiow": ("ray_tracing_in_one_weekend", 640, 480, {}),
           "planets": ("planets_in_one_weekend", 640, 480, {}),
           "cubesgrid": ("cubes_and_common_scene", 640, 480, dict(grid=30)),
           "cylinders": ("cylinder_cubes_common_scene", 640, 480,
                         dict(grid=30)),
           "mandelbulb": ("mandelbulb_scene", 640, 480, {}),
           "cubes": ("cube_and_spheres", 256, 256, {}),
           "simple": ("simple_test", 512, 512, {})}
FOV_RINGS, FOV_SPP = (15, 40), (16, 8, 1)
# the foliage field: one grass card (a quad with texcoords) instanced on a
# 300 x 300 grid of 0.1-unit cells, random y rotation, scale 0.5-1.5, on
# RTIOW's ground sphere; LumiBench's trees_and_grass shape at 1080p
FIELD_N, FIELD_CELL, FIELD_SEED = 300, 0.1, 0
FIELD_TEX = 64
FIELD_EYE, FIELD_AT, FIELD_FOV = (0.0, 1.0, -17.0), (0.0, 0.0, 0.0), 40.0
CLUSTER_W, CLUSTER_H = 480, 270
# the cutout render's traversal launches are held to their plain version
# on every HOLD_STRIDE-th block: on all blocks the plain versions took
# 217-293 s of the phase on an H100 80GB HBM3 at 700 W, and the whole
# script 995 s of its 1200 (PERF.md)
HOLD_STRIDE = 4


def timed_render(torch, render):
    """(output, card ms, host ms, peak MiB allocated) of one render."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev[0].record()
    out = render()
    ev[1].record()
    torch.cuda.synchronize()
    return (out, ev[0].elapsed_time(ev[1]), (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() / 2 ** 20)


def catalog_renders(torch) -> dict:
    """The catalog's scenes, PT at 1 spp and 16 bounces with each
    factory's aperture, focus, sky and gamma, twice with one seed (bit for
    bit), launch counts read around the first: only `simple` has
    triangles (its binned cast and the binning's expand, once each).
    RTIOW's entry keeps its render on the host ("image") for the
    front-ends phase."""
    from gsrt_torch import RenderConfig, _kernels
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.scene import primitives_catalog as cat
    out = {}
    for name, (fn, w, h, kw) in CATALOG.items():
        scene, cam, opts = getattr(cat, fn)(w, h, device=DEVICE, **kw)
        cfg = RenderConfig(width=w, height=h, samples=PT_SAMPLES,
                           bounces=PT_BOUNCES, has_sky=opts["has_sky"],
                           gamma_correction=opts["gamma"])
        render = lambda: pt.render_path_traced(  # noqa: E731
            scene, cam, cfg, seed=SEED, aperture=opts["aperture"],
            focus=opts["focus"], return_flags=True)
        _kernels.reset_launch_counts()
        (img, flags), ms, host_ms, peak = timed_render(torch, render)
        counts = {k: v for k, v in _kernels.launch_counts().items() if v}
        (again, _), ms2, _, _ = timed_render(torch, render)
        want = ({"cast_primary": 1, "expand_pairs_fused": 1}
                if name == "simple" else {})
        log(f"phase scenes: {name} {w}x{h} ({scene.counts[0]} spheres, "
            f"{scene.counts[1]} boxes, {scene.counts[2]} triangles"
            + (f", {scene.cyl_center.shape[0]} cylinders"
               if scene.cyl_center is not None else "")
            + (f", {scene.mnd_center.shape[0]} Mandelbulb"
               if scene.mnd_center is not None else "")
            + f"): {ms:.1f} ms ({host_ms:.1f} host; again {ms2:.1f}), peak "
            f"{peak:.0f} MiB, launches {counts}, mean colour "
            f"{img.mean().item():.6f}")
        if not torch.equal(img, again) or counts != want or \
                any(bool(v) for v in flags.values()) or \
                not torch.isfinite(img).all() or img.std().item() < 0.02:
            raise SystemExit(f"phase scenes: {name}: the two renders differ, "
                             f"its launches are {counts} (want {want}), a "
                             f"flag is set or the image is off")
        out[name] = dict(width=w, height=h, ms=ms, again_ms=ms2,
                         host_ms=host_ms, peak_mib=peak, launches=counts,
                         mean=img.mean().item(), counts=scene.counts)
        if name == "rtiow":
            out[name]["image"] = img.cpu()
        del scene, img, again
    return out


def foveated(torch) -> dict:
    """render_foveated on RTIOW at 640x480, rings (15, 40), spp (16, 8,
    1): the outer ring bit-equal to the 1-spp render at seed SEED * 16."""
    from gsrt_torch import RenderConfig
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.scene import ray_tracing_in_one_weekend
    scene, cam, opts = ray_tracing_in_one_weekend(640, 480, device=DEVICE)
    cfg = RenderConfig(width=640, height=480, bounces=PT_BOUNCES,
                       has_sky=opts["has_sky"], gamma_correction=opts["gamma"])
    lens = dict(aperture=opts["aperture"], focus=opts["focus"])
    img, ms, _, peak = timed_render(torch, lambda: pt.render_foveated(
        scene, cam, cfg, seed=SEED, rings=FOV_RINGS, ring_samples=FOV_SPP,
        **lens))
    one = pt.render_path_traced(scene, cam, cfg.replace(samples=1),
                                seed=SEED * max(FOV_SPP), **lens)
    ys, xs = torch.meshgrid(torch.arange(480, device=DEVICE),
                            torch.arange(640, device=DEVICE), indexing="ij")
    outer = torch.sqrt((xs - 320.0) ** 2 + (ys - 240.0) ** 2).to(
        torch.int32) > FOV_RINGS[1]
    same = torch.equal(img[outer], one[outer])
    log(f"phase scenes: foveated RTIOW 640x480, rings {FOV_RINGS}, spp "
        f"{FOV_SPP}: {ms:.1f} ms, peak {peak:.0f} MiB; the outer ring "
        f"({int(outer.sum())} px) equals the 1-spp render at seed "
        f"{SEED * max(FOV_SPP)}: {same}")
    if not same or not torch.isfinite(img).all():
        raise SystemExit("phase scenes: the foveated outer ring differs "
                         "from its 1-spp render")
    return dict(ms=ms, peak_mib=peak, outer_pixels=int(outer.sum()))


def foliage_field(torch, tmpdir: str, cutout: bool = True):
    """The foliage field: an OBJ grass card (with vt; its MTL has no
    map_Kd) loaded by load_obj, a procedural 64x64 texture and a blade
    cutout (about half the texels clear) attached with _replace, 90,000
    instances, RTIOW's ground sphere, the traversal table. Returns (scene,
    seconds to build, the share of clear texels)."""
    import numpy as np
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.scene.instancing import instantiate_scene, make_transform
    from gsrt_torch.scene.obj import load_obj
    from gsrt_torch.scene.reference_scenes import _add_ground_sphere
    t0 = time.perf_counter()
    with open(os.path.join(tmpdir, "grass.mtl"), "w") as f:
        f.write("newmtl blade\nKd 0.9 0.9 0.9\n")
    with open(os.path.join(tmpdir, "grass.obj"), "w") as f:
        f.write("mtllib grass.mtl\nv -0.08 0 0\nv 0.08 0 0\nv 0.08 0.35 0\n"
                "v -0.08 0.35 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                "usemtl blade\nf 1/1 2/2 3/3 4/4\n")
    card = load_obj(os.path.join(tmpdir, "grass.obj"), device=DEVICE)
    y, x = np.mgrid[:FIELD_TEX, :FIELD_TEX] / (FIELD_TEX - 1.0)
    rgb = np.stack([0.25 + 0.2 * np.sin(9 * x), 0.55 + 0.3 * y,
                    0.15 + 0.1 * np.cos(7 * x)], -1).astype(np.float32)
    blade = (np.abs(x - 0.5) < 0.5 * (1.0 - y)).astype(np.float32)
    mats = card.materials._replace(texture_id=torch.tensor(
        [-1] * (card.materials.model.shape[0] - 1) + [0], dtype=torch.int32,
        device=DEVICE))
    card = card._replace(
        materials=mats, textures=torch.as_tensor(rgb[None], device=DEVICE),
        alpha_textures=(torch.as_tensor(blade[None], device=DEVICE)
                        if cutout else None))
    rng = np.random.default_rng(FIELD_SEED)
    half = FIELD_N * FIELD_CELL / 2
    xs = (np.arange(FIELD_N) + 0.5) * FIELD_CELL - half
    jit = rng.uniform(-0.4, 0.4, (FIELD_N, FIELD_N, 2)) * FIELD_CELL
    rot = rng.uniform(0, 360, (FIELD_N, FIELD_N))
    scale = rng.uniform(0.5, 1.5, (FIELD_N, FIELD_N))
    transforms = [make_transform((xs[i] + jit[i, j, 0], 0.0,
                                  xs[j] + jit[i, j, 1]), rot[i, j],
                                 scale[i, j])
                  for i in range(FIELD_N) for j in range(FIELD_N)]
    field = instantiate_scene(card, transforms)
    field = _add_ground_sphere(field, (0.0, -1000.0, 0.0), 1000.0,
                               (0.5, 0.5, 0.5))
    field = pt.with_tri_table(field)
    torch.cuda.synchronize()
    return field, time.perf_counter() - t0, 1.0 - float(blade.mean())


def held_launches(torch, calls, stride: int = HOLD_STRIDE,
                  phase="scenes") -> dict:
    """Every recorded closest_hit_packed call launched again; the plain
    version runs on every stride-th block of RB rays of it (launch k from
    block k % stride, so the launches cover every block position) and
    must give those rays' t and slots and those blocks' executed visits
    bit for bit. Blocks are traversed independently, so a block's rays
    take the same results in any set of whole blocks. Returns the
    launches held, the rays held and the plain version's seconds."""
    from gsrt_torch.ops import tri_kernel
    rays = 0
    t0 = time.perf_counter()
    for k, ((tt, *args), kw) in enumerate(calls):
        t_k, s_k, _, plan_k = tri_kernel.closest_hit_packed(tt, *args, **kw)
        R = t_k.shape[0]
        blocks = torch.arange(k % stride, -(-R // RB), stride,
                              device=t_k.device)
        idx = (blocks[:, None] * RB + torch.arange(RB, device=t_k.device)
               ).reshape(-1)
        idx = idx[idx < R]
        sub = [a[idx] if torch.is_tensor(a) and a.dim() and a.shape[0] == R
               else a for a in args]
        t_p, s_p, _, plan_p = tri_kernel.closest_hit_packed_plain(tt, *sub,
                                                                  **kw)
        torch.cuda.synchronize()
        if not (torch.equal(t_k[idx], t_p) and torch.equal(s_k[idx], s_p)
                and torch.equal(plan_k.actual[blocks], plan_p.actual)):
            raise SystemExit(
                f"phase {phase}: traversal launch {k} differs from its "
                f"plain version: {int((t_k[idx] != t_p).sum())} t, "
                f"{int((s_k[idx] != s_p).sum())} slots")
        rays += idx.numel()
    return dict(held=len(calls), rays_held=rays, stride=stride,
                seconds=time.perf_counter() - t0)


def foliage_cutout(torch, rows, field, camera, cfg, card: str) -> dict:
    """PT of the cutout field: launch counts around the render, every
    traversal launch (re-traces with a per-ray t_min too) recorded and
    held to its plain version, the bounce-0 re-trace as the kernels
    line's row, sorted waves against unsorted bit for bit, the rays each
    cutout trace cut, and the card time split."""
    from gsrt_torch import _kernels
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.ops import tri_bvh, tri_kernel
    render = lambda **kw: pt.render_path_traced(  # noqa: E731
        field, camera, cfg, seed=SEED, return_flags=True, **kw)
    cutouts = pt._closest_hit_cutout
    traces = []

    def counted(*a, **kw):
        traces.append([])
        return cutouts(*a, retraced=traces[-1], **kw)
    render()                                                # warm-up
    _kernels.reset_launch_counts()
    with Recorder(tri_kernel, "closest_hit_packed") as rec, \
            Replaced(pt, "_closest_hit_cutout", counted):
        (img, flags), ms, host_ms, peak = timed_render(torch, render)
    counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    flags = {k: bool(v) for k, v in flags.items()}
    (flat, _), flat_ms, _, _ = timed_render(
        torch, lambda: render(sort_bounces=False))
    sorted_diff = (img - flat).abs().max().item()
    per_trace = [sum(t[i] for t in traces if len(t) > i)
                 for i in range(max(map(len, traces)))]
    log(f"phase scenes: {card}: foliage field with cutouts, "
        f"{field.tri_v0.shape[0]} triangles, {cfg.width}x{cfg.height}, "
        f"{cfg.bounces} bounces: {ms:.1f} ms ({host_ms:.1f} host), peak "
        f"{peak:.0f} MiB; unsorted waves {flat_ms:.1f} ms, max |sorted - "
        f"unsorted| {sorted_diff:.3e} (must be 0); launches {counts}; "
        f"flags {flags}; rays cut by trace 1, 2, ...: bounce 0 "
        f"{traces[0]}, all {len(traces)} bounces {per_trace}; mean colour "
        f"{img.mean().item():.6f}")
    if sorted_diff or any(flags.values()) or counts.get("cast_primary") or \
            counts.get("closest_hit_packed", 0) != len(rec.calls) or \
            len(traces[0]) < 2 or not traces[0][0] or \
            not torch.isfinite(img).all():
        raise SystemExit("phase scenes: the cutout field's render is off "
                         "(or bounce 0 cut no ray)")
    held = held_launches(torch, rec.calls)
    log(f"phase scenes: all {held['held']} traversal launches of the "
        f"render equal their plain version bit for bit (t, slots, visits) "
        f"on every {held['stride']}th block ({held['rays_held']} rays); "
        f"plain {held['seconds']:.1f} s")
    # the kernels line's row: the first re-trace past a cutout (bounce 0,
    # a per-ray t_min)
    (tt, *args), kw = rec.calls[1]
    row = traverse_row(torch, "closest_hit_packed[foliage-cutout]", tt,
                       tuple(args), kw, traverse_kernel_info(RB),
                       max_sm_clock_hz())
    row.update(launches=counts["closest_hit_packed"],
               at=f"foliage field, {tt.n_tris} triangles, "
               f"{cfg.width}x{cfg.height}: bounce 0's first re-trace past a "
               f"cutout, a per-ray t_min")
    rows.append(row)
    del rec
    # where the card's time goes
    stamps = Stamps(torch)
    stamps.wrap(tri_kernel, "traverse", "traversal")
    stamps.wrap(tri_kernel, "plan_visits", "plan")
    stamps.wrap(tri_bvh, "closest_hit_bvh", "per-ray")
    stamps.wrap(pt, "_sample_alpha", "cutout")
    try:
        stamps.mark("render:start")
        render()
        stamps.mark("render:end")
    finally:
        stamps.restore()
    split = {}
    for label, t in stamps.intervals():
        stage, edge = label.split(":")
        key = stage if edge == "end" and stage != "render" else "shading"
        split[key] = split.get(key, 0.0) + t
    log("phase scenes: cutout field split (card ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    return dict(ms=ms, host_ms=host_ms, peak_mib=peak, unsorted_ms=flat_ms,
                launches=counts, rays_cut_per_trace=per_trace,
                bounce0_rays_cut_per_trace=traces[0],
                held=held, split_ms=split, mean=img.mean().item())


def foliage_mips(torch, rows, field, camera, cfg) -> dict:
    """PT of the field without cutouts, with mips: the binned primary
    casts bounce 0; the cast (Q2.7) and its binning's copy expand (Q2.1)
    held to their plain versions bit for bit (rows of the kernels line);
    the LOD histogram of bounce 0's hits."""
    from gsrt_torch import _kernels
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.ops import mip, tri_binning
    scene = pt.with_texture_mips(field._replace(alpha_textures=None))
    render = lambda: pt.render_path_traced(  # noqa: E731
        scene, camera, cfg, seed=SEED, return_flags=True)
    render()
    lods = []
    cone = mip.ray_cone_lod

    def kept(*a):
        lods.append(cone(*a))
        return lods[-1]
    _kernels.reset_launch_counts()
    with Recorder(tri_binning, "cast_primary") as rec_c, \
            Recorder(tri_binning, "expand_pairs_fused") as rec_x, \
            Replaced(mip, "ray_cone_lod", kept):
        (img, flags), ms, host_ms, peak = timed_render(torch, render)
    counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    lod0 = lods[0][torch.isfinite(lods[0])]
    hist = torch.histc(lod0, bins=scene.tex_mips.shape[1].bit_length(),
                       min=0, max=scene.tex_mips.shape[1].bit_length())
    hist = [int(v) for v in hist.tolist()]
    log(f"phase scenes: foliage field with mips, no cutouts: {ms:.1f} ms "
        f"({host_ms:.1f} host), peak {peak:.0f} MiB, launches {counts}, "
        f"flags {({k: bool(v) for k, v in flags.items()})}; bounce-0 LOD "
        f"histogram (levels 0, 1, ...): {hist}; mean colour "
        f"{img.mean().item():.6f}")
    if counts.get("cast_primary") != 1 or \
            counts.get("expand_pairs_fused") != 1 or \
            not counts.get("closest_hit_bvh") or \
            any(bool(v) for v in flags.values()) or \
            not torch.isfinite(img).all():
        raise SystemExit("phase scenes: the mips field did not cast its "
                         "primary through the kernels, or overflowed")
    (binning, dirs, origin), cast_kw = rec_c.calls[0]
    at = (f"foliage field, {scene.tri_v0.shape[0]} triangles, "
          f"{cfg.width}x{cfg.height}, bounce 0")
    cast = cast_row(torch, "cast_primary[foliage]", binning, dirs, origin,
                    cast_kw, max_sm_clock_hz(), phase="scenes")
    expand = tri_expand_rows(torch, rec_x.calls[:1],
                             ["expand_pairs_fused[foliage]"], at,
                             phase="scenes")[0]
    cast.update(launches=rec_c.launched("cast_primary"), at=at)
    expand["launches"] = rec_x.launched("expand_pairs_fused")
    rows += [cast, expand]
    return dict(ms=ms, host_ms=host_ms, peak_mib=peak, launches=counts,
                lod_histogram=hist, mean=img.mean().item())


def foliage_triclusters(torch, field) -> dict:
    """with_tri_clusters on the field; 480x270 primary rays through
    closest_hit_tri_clusters against the brute-force sweep: t bit-equal,
    triangle ids equal where t has no tie (where they differ, both
    triangles must give that t)."""
    from gsrt_torch import RenderConfig
    from gsrt_torch.core.types import look_at, make_camera
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.ops import clusters, primitives
    scene = pt.with_tri_clusters(field._replace(tri_table=None))
    tc = scene.tri_clusters
    cam = make_camera(look_at(FIELD_EYE, FIELD_AT), FIELD_FOV, CLUSTER_W,
                      CLUSTER_H, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    orig, dirn = pt.generate_camera_rays(
        gen, cam, RenderConfig(width=CLUSTER_W, height=CLUSTER_H))
    (t, c, k, hit, aabb_n, leaf_n), ms, _, peak = timed_render(
        torch, lambda: clusters.closest_hit_tri_clusters(tc, orig, dirn,
                                                         1e-3, 1e4))
    bmin = torch.minimum(torch.minimum(field.tri_v0, field.tri_v1),
                         field.tri_v2)
    bmax = torch.maximum(torch.maximum(field.tri_v0, field.tri_v1),
                         field.tri_v2)
    order = clusters.build_clusters(bmin, bmax, k=tc.clusters.k,
                                    sup=tc.clusters.sup)[1].long()
    ids = order[c.long() * tc.clusters.k + k.long()]
    (i_b, (t_b, _, _)), brute_ms, _, brute_peak = timed_render(
        torch, lambda: pt._sweep(lambda s, e: primitives.ray_triangle(
            orig, dirn, field.tri_v0[s:e], field.tri_v1[s:e],
            field.tri_v2[s:e], 1e-3, 1e4), field.tri_v0.shape[0],
            orig.shape[0]))
    differ = hit & (ids != i_b)
    n_differ = int(differ.sum())
    ties = True
    if n_differ:
        r = differ.nonzero()[:, 0]
        t_own = primitives.ray_triangle(
            orig[r], dirn[r], field.tri_v0[ids[r]], field.tri_v1[ids[r]],
            field.tri_v2[ids[r]], 1e-3, 1e4)[0].diagonal()
        ties = torch.equal(t_own, t[r])
    log(f"phase scenes: tri-clusters ({tc.clusters.m} clusters of "
        f"{tc.clusters.k}, {tc.clusters.sup_min.shape[0]} super-clusters) "
        f"on {CLUSTER_W}x{CLUSTER_H} primary rays: {ms:.1f} ms (peak "
        f"{peak:.0f} MiB), {aabb_n} AABB tests, {leaf_n} (ray, cluster) "
        f"intersections = {leaf_n / orig.shape[0]:.1f} clusters a ray; "
        f"brute-force sweep {brute_ms:.1f} ms (peak {brute_peak:.0f} MiB); "
        f"t bit-equal {torch.equal(t, t_b)}, hits {hit.float().mean():.4f}, "
        f"ids differ at {n_differ} rays, all ties: {ties}")
    if not torch.equal(t, t_b) or not ties:
        raise SystemExit("phase scenes: tri-clusters differ from the sweep")
    return dict(ms=ms, brute_ms=brute_ms, aabb_tests=aabb_n,
                clusters_tested=leaf_n, clusters=tc.clusters.m,
                ids_differing=n_differ, hit_fraction=hit.float().mean()
                .item(), peak_mib=peak, brute_peak_mib=brute_peak)


def ply_round_trip(torch, tmpdir: str) -> dict:
    """The render cell's 1,000,000 splats through save_gaussian_ply and
    the native decode: means and SH bit-equal, opacity and Σ within 1e-6;
    one render_tiled frame of each cloud, launches counted around the
    loaded cloud's, within 2e-2."""
    from gsrt_torch import _kernels, native
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.scene.ply import load_gaussian_ply, save_gaussian_ply
    from gsrt_torch.scene.catalog import random_cloud_params
    cfg, cloud, camera = render_cell(DEVICE)
    means, quats, scales, opac, sh = random_cloud_params(
        SPLATS, seed=SEED, scale_range=(0.004, 0.03))
    path = os.path.join(tmpdir, "cell.ply")
    t0 = time.perf_counter()
    save_gaussian_ply(path, means, quats, scales, opac, sh)
    save_s = time.perf_counter() - t0
    if not native.available():
        raise SystemExit("phase scenes: the host library does not build")
    t0 = time.perf_counter()
    loaded = load_gaussian_ply(path, device=DEVICE)
    torch.cuda.synchronize()
    parse_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with Replaced(native, "available", lambda: False):
        load_gaussian_ply(path, device=DEVICE)
    torch.cuda.synchronize()
    numpy_ms = (time.perf_counter() - t0) * 1e3
    errs = dict(opacity=max_abs_err(loaded.opacity - cloud.opacity),
                cov3d=max_abs_err(loaded.cov3d - cloud.cov3d))
    same = torch.equal(loaded.means, cloud.means) and \
        torch.equal(loaded.sh, cloud.sh)
    tracer = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)
    tracer.calibrate(loaded, camera)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    got = tracer(loaded, camera)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    ref = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)
    ref.calibrate(cloud, camera)
    want = ref(cloud, camera)
    d = (got.color - want.color).abs().max().item()
    size = os.path.getsize(path)
    log(f"phase scenes: PLY of {SPLATS} splats, SH 3, {size} bytes: "
        f"written in {save_s:.2f} s, parsed natively in {parse_ms:.1f} ms "
        f"(NumPy {numpy_ms:.1f} ms); means and SH bit-equal {same}, "
        f"opacity {errs['opacity']:.2e}, cov3d {errs['cov3d']:.2e} (1e-6); "
        f"a render_tiled frame of it: launches {counts}, max |colour - the "
        f"original cloud's| {d:.3e} (2e-2)")
    path_kernels = ("expand_pairs_fused", "expand_pairs_binned",
                    "partition_group_stream", "blend_packed_group")
    if not same or max(errs.values()) > 1e-6 or d > 2e-2 or \
            bool(got.overflow) or any(not counts.get(k) for k in
                                      path_kernels):
        raise SystemExit("phase scenes: the PLY round trip is off")
    return dict(bytes=size, parse_ms=parse_ms, numpy_parse_ms=numpy_ms,
                save_s=save_s, launches=counts, frame_diff=d, **errs)


def scenes_phase(torch, rows, card: str) -> dict:
    """scenes: the catalog's scenes, foveated PT, the foliage field (with
    cutouts through the traversal kernel, opaque with mips through the
    binned cast, through tri-clusters) and a 1M-splat PLY round trip."""
    import tempfile
    from gsrt_torch import RenderConfig
    from gsrt_torch.core.types import look_at, make_camera
    t0 = time.perf_counter()
    out = dict(catalog=catalog_renders(torch), foveated=foveated(torch))
    camera = make_camera(look_at(FIELD_EYE, FIELD_AT), FIELD_FOV, WIDTH,
                         HEIGHT, device=DEVICE)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=PT_SAMPLES,
                       bounces=PT_BOUNCES)
    with tempfile.TemporaryDirectory() as tmpdir:
        field, build_s, clear = foliage_field(torch, tmpdir)
        tt = field.tri_table
        log(f"phase scenes: foliage field: {field.tri_v0.shape[0]} "
            f"triangles ({FIELD_N}x{FIELD_N} instances of a grass card, "
            f"{clear:.3f} of its texels clear), {tt.cl_min.shape[0]} "
            f"clusters, {tt.sup_min.shape[0]} super-clusters, built in "
            f"{build_s:.1f} s")
        out["foliage"] = dict(
            triangles=field.tri_v0.shape[0], build_s=build_s,
            clear_texels=clear,
            cutout=foliage_cutout(torch, rows, field, camera, cfg, card),
            mips=foliage_mips(torch, rows, field, camera, cfg),
            tri_clusters=foliage_triclusters(torch, field))
        del field
        out["ply"] = ply_round_trip(torch, tmpdir)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase scenes: {out['seconds']:.1f} s")
    return out


# the front-ends phase: the CLI's subcommands in the process, the viewer,
# and `python -m gsrt_torch.bench` as a subprocess
FE_SOUP = 20_000        # triangles of the lumibench step's synthetic tree
FE_FIT_ITERS, FE_FIT_DENSIFY = 100, 50
FE_TRAIN_ITERS = 50
FE_HOLD_S = 2.0         # seconds the serving viewer's key is held


def run_cli(torch, argv: list) -> tuple:
    """(stdout, launch counts, wall s, peak MiB) of one in-process
    `gsrt_torch.cli.main(argv)`, counts set to 0 just before and read just
    after; fails on a non-zero exit code."""
    import contextlib
    import io
    from gsrt_torch import _kernels, cli
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if rc != 0:
        raise SystemExit(f"phase front-ends: cli {' '.join(argv)} exited "
                         f"with {rc}")
    return buf.getvalue(), counts, wall, peak


def json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def fe_check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"phase front-ends: {msg}")


def record_cli(argv: list, wrappers: tuple) -> list:
    """Runs `gsrt_torch.cli.main(argv)` once more, its output dropped,
    with a Recorder around each (module, name) of `wrappers` (the last
    call of each, every call of the traversal): the calls the front-ends
    rows hold. The counted run stays free of recorders, whose kept
    arguments would add to its peak memory."""
    import contextlib
    import io
    from gsrt_torch import cli
    with contextlib.ExitStack() as stack:
        recs = [stack.enter_context(Recorder(
            m, n, last_only=n != "closest_hit_packed")) for m, n in wrappers]
        stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        fe_check(cli.main(argv) == 0, f"cli {' '.join(argv)} failed when "
                 f"recorded")
    return recs


def keyword_defaults(fn) -> dict:
    import inspect
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.kind == p.KEYWORD_ONLY}


TILE_PLAIN_KEYS = ("width", "height", "sub_w", "sub_h", "bs", "chunk",
                   "g_cutoff", "alpha_threshold", "alpha_clamp", "term_eps",
                   "skip_range_check", "use_exp_lut")


def tile_blend_row(torch, name, binning, kw, launches, phase) -> dict:
    """The tile-stream blend (Q2.3) on one recorded call against its plain
    version, every tile: color and trans within 2e-3, consumed equal where
    the call tracks it, hits equal on the f32 payload (at most 1 apart on
    at most 0.1% of pixels on the compact one); the row with the kernel's
    time on the call, the plain version's, the bound from the pairs the
    tiles blend and the instruction floor."""
    from gsrt_torch.ops import splat_packed, tile_binning
    kw = {**keyword_defaults(splat_packed.blend_packed), **kw}
    W, H, npx = kw["width"], kw["height"], kw["sub_w"] * kw["sub_h"]
    ntx, nty = tile_binning.tile_extent(W, H, kw["sub_w"], kw["sub_h"])
    T = ntx * nty
    compact = binning.payload.shape[0] == tile_binning.COMPACT_WIDTH
    stats = {}
    t0 = time.perf_counter()
    cp, tp, consp, hp = splat_packed.blend_packed_tile_plain(
        binning, stats=stats, **{k: kw[k] for k in TILE_PLAIN_KEYS})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    run = lambda: splat_packed.blend_packed(binning, **kw)
    out = run()
    torch.cuda.synchronize()
    err = max_abs_err(out[0] - cp, out[1] - tp)
    ok, msg = err <= 2e-3, ""
    if kw["track_consumed"]:
        same = torch.equal(out[2], consp)
        ok, msg = ok and same, f", consumed equal {same}"
    if kw["track_hits"]:
        d = (out[-1] - hp).abs()
        off = int((d != 0).sum())
        ok = ok and (d.max().item() <= 1 and off <= 1e-3 * d.numel()
                     if compact else off == 0)
        msg += f", hits differ at {off} px"
    blended = stats["pairs_blended"]
    log(f"phase {phase}: {name}: max |kernel - plain| {err:.3e} (atol "
        f"2e-3){msg}, {blended} pairs blended of {int(binning.total_pairs)}")
    if not ok:
        raise SystemExit(f"phase {phase}: {name} differs from its plain "
                         f"version")
    t_ops = BLEND_FLOPS_PER_PAIR_PIXEL * npx * blended / F32_FLOPS
    t_bytes = (4 * (binning.payload.shape[0] * blended + T + 1
                    + (consp.numel() if kw["track_consumed"] else 0))
               + (20 if kw["track_hits"] else 16) * W * H) / HBM_BYTES_PER_S
    info = blend_kernel_info("tile" if compact else "tile_f32", kw, npx)
    row = dict(
        name=name, route="cuda", source=BLEND_SRC, replaces=BLEND_TPU,
        launches=launches, max_abs_err=err, ms=time_cuda(run, 10),
        plain_ms=plain_s * 1e3, bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, **blend_floor(stats, info, max_sm_clock_hz()),
        build=info)
    floor = row["instruction_floor_ms"]
    log(f"phase {phase}: {name}: row cull {row['culled_share']:.4f}; "
        f"kernel {row['ms']:.4f} ms, plain {plain_s * 1e3:.1f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), instruction floor "
        + (f"{floor:.4f} ms" if floor else "not measured"))
    return row


def group_blend_rows(torch, tag, binning, kw, counts, phase) -> list:
    """The group stream's partition (bit for bit) and blend (color and
    trans within 2e-3, hits at most 1 apart on at most 0.1% of pixels) on
    one recorded call against their plain versions, every tile: the rows
    partition_group_stream[tag] and blend_packed_group[tag], the blend
    timed on the partition's lists as phase blend times it."""
    from gsrt_torch.ops import splat_packed, tile_binning
    kw = {**keyword_defaults(splat_packed.blend_packed), **kw}
    W, H, bs = kw["width"], kw["height"], kw["bs"]
    ntx, nty = tile_binning.tile_extent(W, H, kw["sub_w"], kw["sub_h"])
    T, npx = ntx * nty, kw["sub_w"] * kw["sub_h"]
    t0 = time.perf_counter()
    order_p, seg_p = splat_packed.partition_group_stream_plain(
        binning.payload[4], binning.tile_start, T, bs)
    torch.cuda.synchronize()
    part_plain_s = time.perf_counter() - t0
    part = lambda: splat_packed.partition_group_stream(binning, T, bs)
    order_k, seg_k = part()
    torch.cuda.synchronize()
    n_cols = int(seg_p[T])
    if not (torch.equal(seg_k, seg_p)
            and torch.equal(order_k[:n_cols], order_p[:n_cols])):
        raise SystemExit(f"phase {phase}: partition_group_stream[{tag}] "
                         f"differs from its plain version")
    rows = [dict(
        name=f"partition_group_stream[{tag}]", route="cuda",
        source=BLEND_SRC, replaces=BLEND_TPU,
        launches=counts.get("partition_group_stream", 0), max_abs_err=0.0,
        ms=time_cuda(part, 20), plain_ms=part_plain_s * 1e3,
        bound_ms=4 * (2 * n_cols + 2 * (T + 1)) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=time_cuda(lambda: torch.sort(
            binning.payload[4, :n_cols], stable=True), 10))]
    stats = {}
    plain_kw = {k: kw[k] for k in TILE_PLAIN_KEYS if k != "chunk"}
    t0 = time.perf_counter()
    cp, tp, hp = splat_packed.blend_packed_plain(
        binning, stats=stats, track_hits=True, **plain_kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    ck, tk, hk = splat_packed.blend_packed(binning,
                                           **{**kw, "track_hits": True})
    torch.cuda.synchronize()
    err = max_abs_err(ck - cp, tk - tp)
    hd = (hk - hp).abs()
    hits_off = int((hd != 0).sum())
    total = int(binning.total_pairs)
    log(f"phase {phase}: partition_group_stream[{tag}] of {n_cols} columns "
        f"into {T} tile lists bitwise equal; blend_packed_group[{tag}]: max "
        f"|kernel - plain| {err:.3e} (atol 2e-3), hits differ at "
        f"{hits_off} px, {stats['pairs_blended']} pairs blended of {total}")
    if not (err <= 2e-3 and hd.max().item() <= 1
            and hits_off <= 1e-3 * hd.numel()):
        raise SystemExit(f"phase {phase}: blend_packed_group[{tag}] differs "
                         f"from its plain version")
    info = blend_kernel_info("group", kw, npx)
    t_ops = BLEND_FLOPS_PER_PAIR_PIXEL * npx * stats["pairs_blended"] \
        / F32_FLOPS
    t_bytes = (4 * (tile_binning.COMPACT_WIDTH * total
                    + binning.tile_start.numel()) + 16 * W * H) \
        / HBM_BYTES_PER_S
    with Replaced(splat_packed, "partition_group_stream",
                  lambda *a: (order_k, seg_k)):
        ms = time_cuda(lambda: splat_packed.blend_packed(binning, **kw), 10)
    rows.append(dict(
        name=f"blend_packed_group[{tag}]", route="cuda", source=BLEND_SRC,
        replaces=BLEND_TPU, launches=counts.get("blend_packed_group", 0),
        max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3,
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, **blend_floor(stats, info, max_sm_clock_hz()),
        hits_differing=hits_off, build=info))
    log(f"phase {phase}: partition_group_stream[{tag}] "
        f"{rows[0]['ms']:.4f} ms (plain {rows[0]['plain_ms']:.1f} ms); "
        f"blend_packed_group[{tag}] {ms:.4f} ms, plain "
        f"{plain_s * 1e3:.1f} ms, bound {rows[1]['bound_ms']:.4f} ms "
        f"({rows[1]['bound_by']})")
    return rows


def held_rows(torch, rows, recs, tag: str, counts: dict, at: str,
              phase: str = "front-ends"):
    """Rows `<kernel>[tag]` of the kernels line: the last recorded call of
    each wrapper held to its plain version (the expands bit for bit, the
    blends every tile), every recorded traversal launch held bit for bit
    and its last launch of each mode a row; launches are the step's
    counted run's."""
    from gsrt_torch.ops import pair_expand
    new = []
    for rec in recs:
        if not rec.calls:
            raise SystemExit(f"phase {phase}: {tag}: no call of {rec.name} "
                             f"recorded")
        args, kw = rec.calls[-1]
        if rec.name.startswith("expand_pairs"):
            tab, base, mp = args
            n, name = tab.shape[1], f"{rec.name}[{tag}]"
            fn = getattr(pair_expand, rec.name)
            if rec.name == "expand_pairs_binned":
                new.append(expand_row(
                    name, EXPAND_TPU, lambda: fn(tab, base, mp, **kw),
                    lambda: pair_expand.expand_pairs_binned_plain(
                        tab, base, mp, **kw), None, counts.get(rec.name, 0),
                    4 * (pair_expand.EMIT_ROWS * mp
                         + pair_expand.EMIT_TAB_ROWS * n + n),
                    phase=phase))
            else:
                new.append(expand_row(
                    name, GATHER_TPU if rec.name == "expand_pairs"
                    else EXPAND_TPU, lambda: fn(tab, base, mp),
                    lambda: pair_expand.expand_pairs_plain(tab, base, mp),
                    lambda: tab.index_select(
                        1, pair_expand.source_index(base, mp)),
                    counts.get(rec.name, 0),
                    4 * (tab.shape[0] * (mp + n) + n), phase=phase))
        elif rec.name == "blend_packed" and kw.get("group_stream", True):
            new += group_blend_rows(torch, tag, args[0], kw, counts,
                                    phase)
        elif rec.name == "blend_packed":
            new.append(tile_blend_row(
                torch, f"blend_packed_tile[{tag}]", args[0], kw,
                counts.get("blend_packed_tile", 0), phase))
        elif rec.name == "cast_primary":
            new.append(cast_row(torch, f"cast_primary[{tag}]", *args, kw,
                                max_sm_clock_hz(), phase=phase))
            new[-1]["launches"] = counts.get("cast_primary", 0)
        else:                                   # closest_hit_packed
            held = held_launches(torch, rec.calls, stride=1,
                                 phase=phase)
            log(f"phase {phase}: {tag}: all {held['held']} traversal "
                f"launches equal their plain version bit for bit (t, "
                f"slots, visits) on every block ({held['rays_held']} rays)")
            for key, any_hit in (("closest_hit_packed", False),
                                 ("closest_hit_packed_any", True)):
                calls = [c for c in rec.calls
                         if c[1].get("any_hit", False) == any_hit]
                if calls:
                    (tt, *a), k = calls[-1]
                    new.append(traverse_row(
                        torch, f"{key}[{tag}]", tt, tuple(a), k,
                        traverse_kernel_info(RB), max_sm_clock_hz()))
                    new[-1].update(launches=counts.get(key, 0), held=held)
    for row in new:
        row["at"] = at
    rows += new
    return [row["name"] for row in new]


def fe_render(torch, rows, tmp: str) -> dict:
    """cli render of random1000000 at 1080p at the CLI's defaults (f32
    payload, --expand-impl pallas, the tile stream) with --out, --heatmap,
    --dump-binary and --stats, then cli compare of its PNG; its expand
    and tile blend held to their plain versions (rows [cli-render])."""
    import numpy as np
    from gsrt_torch import RenderConfig
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.ops import pair_expand, splat_packed
    from gsrt_torch.scene import random_cloud
    from gsrt_torch.utils.image import read_png, save_png, to_uint8
    png, heat, dump = (os.path.join(tmp, f) for f in
                       ("render.png", "heat.png", "render.bin"))
    argv = ["render", "--scene", f"random{SPLATS}", "--width", str(WIDTH),
            "--height", str(HEIGHT), "--out", png, "--heatmap", heat,
            "--dump-binary", dump, "--stats"]
    text, counts, wall, peak = run_cli(torch, argv)
    stats = json_lines(text)[0]
    # the same frame directly: the CLI's configuration and cloud
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, conic_mode="standard",
                       expand_impl="pallas", payload="f32", scan_impl="roll")
    cloud, camera = random_cloud(SPLATS, width=WIDTH, height=HEIGHT,
                                 device=DEVICE)
    direct = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)(cloud,
                                                                camera)
    pairs = int(grt.count_pairs(cloud, camera, cfg))
    want = to_uint8(direct.color)
    got = read_png(png)
    size = os.path.getsize(dump)
    log(f"phase front-ends: render {WIDTH}x{HEIGHT} random{SPLATS} (CLI "
        f"defaults, scale_range (0.02, 0.25)): {pairs} pairs, "
        f"{stats['frame_time_s'] * 1e3:.3f} ms/frame, "
        f"{stats['mrays_per_s']:.3f} Mrays/s, peak {peak:.0f} MiB, "
        f"overflow {stats['overflow']}, command {wall:.2f} s; launches "
        f"{counts}; PNG equal to a direct frame {np.array_equal(got, want)}"
        f"; image.binary {size} bytes")
    fe_check(counts.get("expand_pairs", 0) == 2
             and counts.get("blend_packed_tile", 0) == 2
             and not counts.get("blend_packed_group"),
             f"render launched {counts}: want Q2.2 and the f32 tile blend "
             f"once a render (warm and timed)")
    fe_check(np.array_equal(got, want), "the render's PNG differs from a "
             "direct frame")
    fe_check(size == WIDTH * HEIGHT * 7, f"image.binary is {size} bytes")
    fe_check(read_png(heat).shape == (HEIGHT, WIDTH, 3)
             and not stats["overflow"] and stats["n_splats"] == SPLATS,
             f"heatmap or stats off: {stats}")
    direct_png = os.path.join(tmp, "direct.png")
    save_png(direct_png, direct.color)
    cmp = {}
    for name, b in (("self", png), ("direct", direct_png)):
        text, _, cwall, _ = run_cli(torch, ["compare", png, b])
        cmp[name] = json_lines(text)[-1]
        fe_check(cmp[name] == {"psnr_db": 999.0, "ssim": 1.0},
                 f"compare with {name}: {cmp[name]}")
    log(f"phase front-ends: compare with itself {cmp['self']}, with a "
        f"save_png of the direct frame {cmp['direct']} ({cwall:.2f} s)")
    del cloud, direct
    held = held_rows(torch, rows, record_cli(argv, (
        (pair_expand, "expand_pairs"), (splat_packed, "blend_packed"))),
        "cli-render", counts, f"cli render at its defaults: random{SPLATS}"
        f" (scale_range (0.02, 0.25)), {WIDTH}x{HEIGHT}, {pairs} pairs")
    return dict(pairs=pairs, held_rows=held, ms=stats["frame_time_s"] * 1e3,
                mrays_per_s=stats["mrays_per_s"], peak_mib=peak,
                launches=counts, wall_s=wall, compare=cmp)


def fe_orbit(torch, rows, tmp: str, serving: dict) -> dict:
    """cli orbit at its defaults (1080p, random1000000 at bench.py's
    scales, 24 frames over 90 degrees, serving) with --stats-out, its last
    frame's expand and tile blend held (rows [cli-orbit]); then 2 frames
    with --out-dir."""
    from gsrt_torch.ops import pair_expand, splat_packed
    from gsrt_torch.utils.image import read_png
    st_path = os.path.join(tmp, "orbit.json")
    argv = ["orbit", "--stats-out", st_path]
    text, counts, wall, peak = run_cli(torch, argv)
    rec = json_lines(text)[-1]
    with open(st_path) as f:
        per_frame = json.load(f)
    served = rec["frames"] + rec["full_renders"]
    log(f"phase front-ends: orbit {rec['frames']} frames: steady "
        f"{rec['steady_ms']} ms/frame (the serving phase's served "
        f"{serving['served_ms']:.3f} ms on the card's clock, "
        f"{serving['served_host_ms']:.3f} on the host's), "
        f"{rec['ms_per_frame']} ms/frame over the path, violations "
        f"{rec['violations']}, re-renders {rec['full_renders']}, pairs "
        f"{rec['pairs_first']} -> {rec['pairs_last']}, peak {peak:.0f} "
        f"MiB; launches {counts}")
    fe_check(len(per_frame) == rec["frames"] == 24 and rec["serving"],
             f"orbit record {rec}")
    fe_check(counts.get("blend_packed_tile") == served
             and not counts.get("blend_packed_group")
             and not counts.get("partition_group_stream"),
             f"orbit launched {counts}: want one tile blend a served frame "
             f"({served}) and no group blend")
    held = held_rows(torch, rows, record_cli(argv, (
        (pair_expand, "expand_pairs_fused"), (splat_packed, "blend_packed"))),
        "cli-orbit", counts, f"cli orbit at its defaults: the last of "
        f"{rec['frames']} served frames of random{SPLATS} at bench.py's "
        f"scales, {WIDTH}x{HEIGHT}")
    out_dir = os.path.join(tmp, "orbit")
    run_cli(torch, ["orbit", "--frames", "2", "--out-dir", out_dir])
    shapes = [read_png(os.path.join(out_dir, f"frame_{i:04d}.png")).shape
              for i in range(2)]
    fe_check(shapes == [(HEIGHT, WIDTH, 3)] * 2, f"orbit frames {shapes}")
    return dict(record=rec, launches=counts, wall_s=wall, peak_mib=peak,
                frames_written=len(shapes), held_rows=held)


def fe_pt(torch, tmp: str, rtiow) -> dict:
    """cli pt --scene rtiow at 640x480 (1 spp, 16 bounces) against the
    scenes phase's RTIOW render (the same scene, configuration and
    seed)."""
    import numpy as np
    from gsrt_torch.utils.image import read_png, to_uint8
    png = os.path.join(tmp, "pt.png")
    text, counts, wall, peak = run_cli(torch, [
        "pt", "--scene", "rtiow", "--width", "640", "--height", "480",
        "--out", png])
    same = np.array_equal(read_png(png), to_uint8(rtiow))
    log(f"phase front-ends: pt rtiow 640x480: {text.splitlines()[0]}, "
        f"peak {peak:.0f} MiB, launches {counts}; PNG equal to the scenes "
        f"phase's render {same}")
    fe_check(same, "pt's PNG differs from render_path_traced's")
    return dict(line=text.splitlines()[0], launches=counts, wall_s=wall)


def write_soup_tree(root: str) -> None:
    """A reference tree holding one directory scene, Bathroom: FE_SOUP
    triangles of tools/tri_bench.py's generator (sd 0.05) as an OBJ file,
    seen from (0, 0, -7) through a .camera file."""
    import numpy as np
    path = os.path.join(root, "Scenes", "Bathroom")
    os.makedirs(path)
    v = np.stack(tri_soup(FE_SOUP, SOUP_SD, SEED), 1).reshape(-1, 3)
    with open(os.path.join(path, "soup.obj"), "w") as f:
        f.write("".join(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in v))
        f.write("".join(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n"
                        for i in range(FE_SOUP)))
    with open(os.path.join(path, "view.camera"), "w") as f:
        f.write("0 0 -7 0 0 0\n")


def fe_bench(torch, rows, tmp: str) -> dict:
    """cli bench --primary binned: the synthetic suite at the CLI's
    128x128 (9 records), then the lumibench suite on a synthetic tree
    (GSRT_REFERENCE_ROOT's layout), whose soup has the traversal table;
    each suite's last cast and expand and lumibench's traversal held
    (rows [cli-bench], [lumibench])."""
    from gsrt_torch.ops import tri_binning, tri_kernel
    from gsrt_torch.scene import reference_scenes
    cast = ((tri_binning, "expand_pairs_fused"), (tri_binning, "cast_primary"))
    argv = ["bench", "--primary", "binned"]
    text, counts, wall, _ = run_cli(torch, argv)
    recs = json_lines(text)
    renders = 2 * sum("binned_pairs" in r for r in recs)  # warm + timed
    log(f"phase front-ends: bench synthetic --primary binned: "
        + ", ".join(f"{r['scene']}/{r['workload']} {r['ms']} ms"
                    for r in recs) + f"; launches {counts}")
    fe_check(len(recs) == 9 and renders == 6, f"bench records {recs}")
    fe_check(counts.get("cast_primary") == renders,
             f"bench launched {counts}: want the binned cast once a render "
             f"of a triangle scene ({renders})")
    held = held_rows(torch, rows, record_cli(argv, cast), "cli-bench",
                     counts, "cli bench --primary binned at 128x128: the "
                     "Cornell box's last render")
    write_soup_tree(tmp)
    argv = ["bench", "--suite", "lumibench", "--scenes", "bathroom",
            "--primary", "binned"]
    with Replaced(reference_scenes, "REF_ROOT", tmp):
        text, lcounts, lwall, _ = run_cli(torch, argv)
        recorded = record_cli(argv,
                              cast + ((tri_kernel, "closest_hit_packed"),))
    lrecs = json_lines(text)
    log(f"phase front-ends: bench lumibench (synthetic Bathroom, {FE_SOUP} "
        f"triangles) --primary binned: "
        + ", ".join(f"{r['workload']} {r['ms']} ms" for r in lrecs)
        + f"; visits a block {lrecs[0].get('sup_visits_actual_per_block')}"
        f" of {lrecs[0].get('sup_visits_per_block')} planned; launches "
        f"{lcounts}")
    fe_check(len(lrecs) == 3 and lrecs[0].get("tris") == FE_SOUP,
             f"lumibench records {lrecs}")
    fe_check(lcounts.get("cast_primary") == 6
             and lcounts.get("closest_hit_packed", 0) > 0
             and lcounts.get("closest_hit_packed_any", 0) > 0,
             f"lumibench launched {lcounts}: want the cast once a render "
             f"and both traversal modes")
    held += held_rows(torch, rows, recorded, "lumibench", lcounts,
                      f"cli bench --suite lumibench at 128x128: a "
                      f"synthetic Bathroom of {FE_SOUP} soup triangles, "
                      f"its last render")
    return dict(synthetic=recs, launches=counts, wall_s=wall, held_rows=held,
                lumibench=lrecs, lumibench_launches=lcounts,
                lumibench_wall_s=lwall)


def fe_fit(torch, tmp: str, capture_dir: str) -> dict:
    """cli fit on the fit phase's capture (targets as PNGs) with
    --iters 100 --densify-every 50 and --save-ply."""
    from gsrt_torch.scene.ply import load_gaussian_ply
    ply = os.path.join(tmp, "fit.ply")
    text, counts, wall, peak = run_cli(torch, [
        "fit", "--colmap", capture_dir, "--iters", str(FE_FIT_ITERS),
        "--densify-every", str(FE_FIT_DENSIFY), "--save-ply", ply])
    done = [ln for ln in text.splitlines() if ln.startswith("fit done")][0]
    train_psnr = float(done.split("train PSNR ")[1].split()[0])
    test_psnr = float(done.split("test PSNR ")[1].split()[0])
    n = load_gaussian_ply(ply, device=DEVICE).n
    grown = [ln for ln in text.splitlines() if "pair buffer grown" in ln]
    log(f"phase front-ends: fit {FE_FIT_ITERS} steps: "
        f"{text.splitlines()[0]}; {done}; {wall:.2f} s, peak {peak:.0f} "
        f"MiB; PLY read back with {n} splats; the pair buffer grew "
        f"{len(grown)} times {grown}; launches {counts}")
    fe_check(all(counts.get(k, 0) >= FE_FIT_ITERS for k in (
        "expand_pairs_fused", "blend_subtiles", "blend_backward")),
        f"fit launched {counts}: want Q2.1, Q2.4 and Q2.5 every step")
    fe_check(all(x == x and abs(x) != float("inf")
                 for x in (train_psnr, test_psnr)), f"fit PSNR: {done}")
    return dict(train_psnr=train_psnr, test_psnr=test_psnr, splats=n,
                pair_buffer_growths=len(grown), launches=counts,
                wall_s=wall, peak_mib=peak)


def fe_train(torch, tmp: str) -> dict:
    """cli train: the demo on render_fast (no kernel, as in gsrt)."""
    text, counts, wall, _ = run_cli(torch, [
        "train", "--iters", str(FE_TRAIN_ITERS),
        "--save-ply", os.path.join(tmp, "train.ply")])
    losses = [float(ln.split()[-1]) for ln in text.splitlines()
              if " loss " in ln]
    log(f"phase front-ends: train {FE_TRAIN_ITERS} steps: losses "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} ({len(losses)} read), "
        f"{wall:.2f} s, launches {counts}")
    fe_check(losses and all(x == x and abs(x) != float("inf")
                            for x in losses) and losses[-1] < losses[0],
             f"train losses {losses}")
    fe_check(not counts, f"train launched {counts}")
    return dict(losses=losses, wall_s=wall)


def http(port: int, path: str, body=None) -> tuple:
    """(status, bytes) of a GET, or a POST of `body` (bytes)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_for(cond, what: str, timeout_s: float = 60.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        val = cond()
        if val:
            return val
        time.sleep(0.02)
    raise SystemExit(f"phase front-ends: view: no {what} in {timeout_s} s")


def fe_view(torch, rows) -> dict:
    """ViewerServer from `cli view`'s arguments (960x540, random100000,
    127.0.0.1, port 0): "tiled" frame by frame, then "serving" under a
    held key; each renderer's last frame's kernels held to their plain
    versions (rows [view], [view-serving])."""
    import contextlib
    import numpy as np
    from gsrt_torch import _kernels, cli
    from gsrt_torch.core.types import make_camera
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.ops import pair_expand, splat_packed
    from gsrt_torch.utils.image import decode_png, to_uint8
    parser = cli.build_parser()

    def recorded(stack, *names):
        return [stack.enter_context(Recorder(
            splat_packed if n == "blend_packed" else pair_expand, n,
            last_only=True)) for n in names]

    def stats(srv):
        code, body = http(srv.port, "/stats")
        fe_check(code == 200, f"view: /stats answered {code}: {body[:400]}")
        return json.loads(body)

    def key(srv, pressed):
        body = json.dumps({"type": "key", "key": "w",
                           "pressed": pressed}).encode()
        fe_check(http(srv.port, "/input", body)[0] == 200, "view: input")

    srv = cli.viewer_from_args(parser.parse_args(
        ["view", "--port", "0", "--renderer", "tiled"]))
    cfg, state = srv.cfg, srv.state
    cam = make_camera(state.controller.view(), srv.fov, cfg.width,
                      cfg.height, device=DEVICE)
    want = to_uint8(grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)(
        srv.cloud, cam).color)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        recs = recorded(stack, "expand_pairs_fused", "expand_pairs_binned",
                        "blend_packed")
        srv.start()
        try:
            wait_for(lambda: stats(srv).get("frame_id") == 1,
                     "first frame")
            code, png = http(srv.port, "/frame.png")
            first = {k: v for k, v in _kernels.launch_counts().items()
                     if v}
            same = code == 200 and np.array_equal(decode_png(png), want)
            pos0 = state.controller.position.copy()
            key(srv, True)
            wait_for(lambda: stats(srv)["frame_id"] > 1, "new frame")
            key(srv, False)
            moved = stats(srv)["frame_id"]
            fe_check(not np.allclose(state.controller.position, pos0),
                     "view: w did not move the camera")
            toggle = json.dumps({"type": "setting",
                                 "heatmap": "toggle"}).encode()
            http(srv.port, "/input", toggle)
            wait_for(lambda: stats(srv)["heatmap"], "heatmap frame")
            heat_png = decode_png(http(srv.port, "/frame.png")[1])
            http(srv.port, "/input", toggle)
            bad = http(srv.port, "/input", b"{not json")[0]
        finally:
            srv.stop()
    tiled = {k: v for k, v in _kernels.launch_counts().items() if v}
    log(f"phase front-ends: view tiled {cfg.width}x{cfg.height}, "
        f"{srv.cloud.n} splats: first frame equal to a direct tiled frame "
        f"{same}, launches from the render thread {first}; w moved the "
        f"camera (frame_id {moved}), heatmap frame {heat_png.shape}, bad "
        f"input {bad}")
    fe_check(same, "view: the first frame differs from a direct frame")
    fe_check(bad == 400, f"view: bad input answered {bad}")
    fe_check(first.get("blend_packed_group", 0) > 0,
             f"view: the render thread launched {first}")
    at = (f"cli view's viewer: {srv.cloud.n} splats at "
          f"{cfg.width}x{cfg.height}, the last frame of the ")
    held = held_rows(torch, rows, recs, "view", tiled,
                     at + "\"tiled\" renderer")

    srv = cli.viewer_from_args(parser.parse_args(["view", "--port", "0"]))
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        recs = recorded(stack, "expand_pairs_fused", "blend_packed")
        srv.start()
        try:
            wait_for(lambda: stats(srv).get("frame_id") == 1,
                     "first frame")
            f0 = stats(srv)["frame_id"]
            key(srv, True)
            time.sleep(FE_HOLD_S)
            last = stats(srv)
            key(srv, False)
        finally:
            srv.stop()
    counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    frames = last["frame_id"] - f0
    log(f"phase front-ends: view serving: {frames} frames in "
        f"{FE_HOLD_S} s of a held key, last frame {last['ms']} ms "
        f"({last['fps']} fps, {last['mrays_s']} Mrays/s; render and host "
        f"read, PNG encoding aside); launches from the render thread "
        f"{counts}")
    fe_check(frames > 0 and counts.get("blend_packed_tile", 0) >= frames,
             f"view serving: {frames} frames, launches {counts}")
    held += held_rows(torch, rows, recs, "view-serving", counts,
                      at + "\"serving\" renderer under a held key")
    return dict(tiled_first_frame_equal=same, tiled_launches=first,
                serving_frames=frames, serving_last_ms=last["ms"],
                serving_fps=last["fps"], serving_launches=counts,
                held_rows=held)


def fe_bench_module(main_mrays: float, frame_ms: float) -> dict:
    """python -m gsrt_torch.bench as a subprocess: its one JSON line;
    beside it `gsrt_torch.bench.run()` in this process, the same workload
    and clock, to tell the process's state from the workload."""
    from gsrt_torch import bench
    t0 = time.perf_counter()
    inproc = bench.run()
    log(f"phase front-ends: gsrt_torch.bench.run() in this process: "
        f"{inproc['value']} Mrays/s ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "gsrt_torch.bench"],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    fe_check(r.returncode == 0, f"gsrt_torch.bench exited "
             f"{r.returncode}: {r.stderr[-2000:]}")
    lines = r.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    log(f"phase front-ends: python -m gsrt_torch.bench: {lines[-1]} "
        f"({wall:.1f} s; the main phase's frame {frame_ms:.4f} ms, "
        f"{main_mrays:.2f} Mrays/s)")
    fe_check(len(lines) == 1 and set(rec) == {"metric", "value", "unit",
                                              "vs_baseline"}
             and rec["value"] > 0, f"bench line {lines}")
    return dict(record=rec, wall_s=wall, in_process_mrays_s=inproc["value"])


def front_ends_phase(torch, rows, capture_dir: str, rtiow, serving: dict,
                     main_mrays: float, frame_ms: float) -> dict:
    """front-ends: the CLI's subcommands (render, compare, orbit, pt,
    bench, fit, train) through gsrt_torch.cli.main, the viewer, and
    python -m gsrt_torch.bench (see the module docstring). Appends the
    rows that hold the steps' kernels on their inputs to `rows`."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = dict(render=fe_render(torch, rows, tmp))
        out["orbit"] = fe_orbit(torch, rows, tmp, serving)
        out["pt"] = fe_pt(torch, tmp, rtiow)
        out["bench"] = fe_bench(torch, rows, tmp)
        out["fit"] = fe_fit(torch, tmp, capture_dir)
        out["train"] = fe_train(torch, tmp)
    out["view"] = fe_view(torch, rows)
    out["bench_module"] = fe_bench_module(main_mrays, frame_ms)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase front-ends: {out['seconds']:.1f} s")
    return out


# --- multi-device: the sharded paths on one card ---

MD_TILES = 4             # row slabs of the data-parallel render (a)
MD_MESH = (2, 4)         # (tiles, splats) of the splat-sharded render (b)
MD_TIERS = (("compact", {}), ("f32", dict(payload="f32", blend_math="f32")))
MD_TERM_EPS = 1e-4       # a blend stops a tile once no pixel of it is above
# A sharded frame against the single-card frame. A slab renders with its
# own camera (principal point cy - y0, rounded in f32, and on the compact
# payload means fixed-point relative to the slab's own tile grid: 1080 rows
# have no slab height that is a multiple of 16), so a pair whose alpha at
# a pixel sits at the threshold can be taken in one frame and not in the
# other, and a tile stops at saturation at another pair. Gate: every entry
# within MD_FRAME_CAP (render_tiled against render_fast, phase check) and
# at most MD_FRAME_SHARE of the pixels past MD_FRAME_ATOL (the blends'
# tolerance; the share is the blend's hits gate); the worst pixel past it
# is logged with what moves it (`slab_witness`).
MD_FRAME_ATOL, MD_FRAME_CAP, MD_FRAME_SHARE = 2e-3, 2e-2, 1e-3
# the JAX suite's bounds (set on 400 splats), logged beside the gate:
# (a) f32 at tests/test_parallel.py:112-115, (b) at :138-141; gather
# against butterfly at :84-87, a gate
MD_BOUNDS = {
    "dp-f32": dict(rtol=(1e-5, 1e-4), atol=(1e-6, 1e-5)),
    "sharded": dict(rtol=(1e-4, 1e-3), atol=(1e-5, 1e-4)),
    "composites": dict(rtol=(1e-5, 1e-5), atol=(1e-6, 1e-6)),
}
MD_PATH = {"compact": ("project_splats", "expand_pairs_fused",
                       "expand_pairs_binned", "partition_group_stream",
                       "blend_packed_group"),
           "f32": ("project_splats", "expand_pairs_fused",
                   "blend_packed_tile")}
MD_RANKS = 2
MD_RANK_TIMEOUT = 180    # seconds the two ranks may take together
# one rank of the two-rank step: loads the kernels the build phase made
MD_RANK_CODE = r'''
import json, sys
import numpy as np
import torch
import chip_smoke as cs
from gsrt_torch import RenderConfig, _kernels
from gsrt_torch.parallel import multihost, render_data_parallel, tiled_render_fn
from gsrt_torch.scene import random_cloud

port, rank, mp, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
stale = [n for n in _kernels.SOURCES if not _kernels._fresh(n)]
if stale:
    raise SystemExit(f"rank {rank}: kernels not built: {stale}")
multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
cfg, cloud, camera = cs.render_cell()
mesh = multihost.global_render_mesh()
torch.cuda.synchronize()
_kernels.reset_launch_counts()
slabs = render_data_parallel(cloud, camera, cfg, mesh,
                             render_fn=tiled_render_fn(mp))
torch.cuda.synchronize()
counts = {k: v for k, v in _kernels.launch_counts().items() if v}
trans, color = multihost.gather_to_hosts(slabs)
multihost.sync_hosts()
sc, scam = random_cloud(256, seed=3, width=64, height=32, device="cuda")
scfg = RenderConfig(width=64, height=32, conic_mode="standard",
                    splat_chunk=64)
small = multihost.gather_to_hosts(
    multihost.render_data_parallel_global(sc, scam, scfg, mesh))
multihost.sync_hosts()
if rank == 0:
    np.savez(out, trans=trans, color=color, small_trans=small[0],
             small_color=small[1])
print("RANK " + json.dumps({
    "rank": rank, "y0": list(slabs.y0), "launches": counts,
    "backend": torch.distributed.get_backend(),
    "device": str(mesh.devices[rank][0])}), flush=True)
torch.distributed.destroy_process_group()
'''


def md_diff(torch, got, want, rtol, atol) -> dict:
    """got, want: (trans [H, W], colour [H, W, 3]). The largest |got -
    want| of each, the entries past atol + rtol·|want| (`over`, NaN
    counted), and both again over the pixels whose transmittance stays
    above the blends' stop threshold in both frames (`_open`): only there
    does each frame blend every pair of the pixel."""
    open_px = (got[0] > MD_TERM_EPS) & (want[0] > MD_TERM_EPS)
    res = dict(saturated_px=int((~open_px).sum()))
    for name, g, w, r, a, m in zip(
            ("trans", "color"), got, want, rtol, atol,
            (open_px, open_px[..., None].expand_as(got[1]))):
        d = (g - w).abs()
        over = (d > a + r * w.abs()) | ~torch.isfinite(d)
        res[f"{name}_max_abs"] = d.max().item()
        res[f"{name}_over"] = int(over.sum())
        res[f"{name}_max_abs_open"] = d[m].max().item() if m.any() else 0.0
        res[f"{name}_over_open"] = int((over & m).sum())
    res["ok"] = res["trans_over"] == 0 and res["color_over"] == 0
    return res


def describe_diff(d: dict) -> str:
    return (f"max |d trans| {d['trans_max_abs']:.3e}, |d colour| "
            f"{d['color_max_abs']:.3e}, entries past the bound {d['trans_over']}"
            f" / {d['color_over']} (on pixels above {MD_TERM_EPS} in both: "
            f"{d['trans_max_abs_open']:.3e} / {d['color_max_abs_open']:.3e}, "
            f"{d['trans_over_open']} / {d['color_over_open']}); "
            f"{d['saturated_px']} px at or below {MD_TERM_EPS}")


def slab_witness(torch, cloud, camera, cfg, slab_h, x, y) -> dict:
    """What moves pixel (x, y) between the single-card frame and the
    frame of its row slab, each in its render's math (the camera's
    projection, the rect spans that bin a splat to the pixel's tile, then
    the f32 payload's means, conic and 15-bit opacity, or the compact
    payload's tile-relative fixed-point mean, bf16 Cholesky factor and u8
    opacity):
    the splats the pixel takes in one and not in the other (and of these
    the ones binned to its tile in one only), with the largest such alpha
    both ways, and the largest alpha difference of a splat taken in
    both."""
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.ops import splat_packed as sp, tile_binning as tb
    from gsrt_torch.parallel.tiles import _slab_camera
    y0 = y // slab_h * slab_h
    tw, th = cfg.tile_w, cfg.tile_h
    akw = grt.blend_params(cfg)
    compact = grt.stream_plan(cfg, camera.width, camera.height).compact
    at = lambda v: torch.tensor([float(v)], device=DEVICE)
    takes, alpha, binned = [], [], []
    for cam, py in ((camera, y), (_slab_camera(camera, y0, slab_h), y - y0)):
        depth, mean2d, quad, in_front, colors = grt._project_sh(
            cloud, cam, cfg)
        alive = grt.alive_mask(depth, cloud.opacity, in_front, cfg)
        op = torch.where(alive, cloud.opacity,
                         torch.zeros_like(cloud.opacity))
        mx, my, qa, qb, qc = mean2d[:, 0], mean2d[:, 1], *quad.unbind(1)[:3]
        rx, ry = grt.screen_extents_abc(
            qa, qb, qc, cfg.conic_mode, cfg.g_cutoff, opacity=cloud.opacity,
            alpha_threshold=cfg.alpha_threshold)
        tx, ty = x // tw, py // th
        sx0, sx1, sy0, sy1, touched = tb.compute_tile_spans(
            mx, my, rx, ry, alive, cam.width, cam.height, tw, th)
        binned.append((touched > 0) & (sx0 <= tx) & (tx <= sx1)
                      & (sy0 <= ty) & (ty <= sy1))
        if compact:
            l11, l21, l22 = tb.conic_cholesky(qa, qb, qc)
            f = sp.decode_pairs(torch.stack([
                tb.pack_mean_rel(mx - tx * tw, my - ty * th),
                tb.pack_bf16_pair(l11, l21), tb.pack_bf16_pair(l22, depth),
                tb.pack_rgba8(colors[:, 0], colors[:, 1], colors[:, 2],
                              op)]))
            g, op = sp.response(f, at(x - tx * tw), at(py - ty * th))[0], \
                f["op"]
        else:
            g = sp.response(dict(mx=mx, my=my, qa=qa, qb=qb, qc=qc), at(x),
                            at(py))[0]
            op = tb.unpack15(tb.pack15(colors[:, 2], op))[1]
        _, take = sp.alphas(g[None], op, **akw)
        takes.append(take[0] & alive & binned[-1])
        alpha.append(torch.clamp_max(op * torch.exp(-g), akw["alpha_clamp"]))
    one_side = takes[0] != takes[1]
    both = takes[0] & takes[1]
    res = dict(pixel=[x, y], slab_y0=y0, taken=[int(t.sum()) for t in takes],
               one_side=int(one_side.sum()),
               one_side_binned=int((one_side & (binned[0] != binned[1]))
                                   .sum()), largest=None)
    step = torch.where(both, (alpha[0] - alpha[1]).abs(),
                       torch.zeros_like(alpha[0]))
    res["alpha_max_diff_both"] = step.max().item()
    if res["one_side"]:
        i = int(torch.where(one_side, torch.maximum(*alpha),
                            torch.full_like(alpha[0], -1.0)).argmax())
        res["largest"] = dict(splat=i, alpha_frame=alpha[0][i].item(),
                              alpha_slab=alpha[1][i].item(),
                              threshold=cfg.alpha_threshold)
    return res


def md_frame(torch, got, want, cloud, camera, cfg, slab_h) -> dict:
    """A sharded frame (trans, colour) against the single-card frame under
    the gate of MD_FRAME_*: per pixel the largest |difference| of its
    entries."""
    d = torch.maximum((got[0] - want[0]).abs(),
                      (got[1] - want[1]).abs().amax(-1))
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    over = int((d > MD_FRAME_ATOL).sum())
    y, x = divmod(int(d.argmax()), d.shape[1])
    res = dict(max_abs=d.max().item(), px_over=over, worst=[x, y],
               worst_saturated=bool(min(got[0][y, x], want[0][y, x])
                                    <= MD_TERM_EPS), witness=None)
    if over:
        res["witness"] = slab_witness(torch, cloud, camera, cfg, slab_h, x, y)
    res["ok"] = (res["max_abs"] <= MD_FRAME_CAP
                 and over <= MD_FRAME_SHARE * d.numel())
    return res


def describe_frame(f: dict) -> str:
    w = f["witness"]
    return (f"max |d| {f['max_abs']:.3e} (cap {MD_FRAME_CAP}), {f['px_over']}"
            f" px past {MD_FRAME_ATOL} (at most {MD_FRAME_SHARE} of the "
            f"pixels); worst pixel {f['worst']}"
            + (" at or below the stop" if f["worst_saturated"] else "")
            + ("" if w is None else
               f", {w['one_side']} splats taken there on one side only "
               f"({w['one_side_binned']} binned to its tile on one side "
               f"only; frame {w['taken'][0]}, slab {w['taken'][1]}), the "
               f"largest "
               f"{w['largest']}; largest alpha difference of a splat taken "
               f"on both {w['alpha_max_diff_both']:.3e}"))


def md_counted(torch, render, wrappers):
    """One call of `render` with the launch counts set to 0 just before
    and read just after, the last call of each (module, name) recorded."""
    import contextlib
    from gsrt_torch import _kernels
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        recs = [stack.enter_context(Recorder(m, n, last_only=True))
                for m, n in wrappers]
        _kernels.reset_launch_counts()
        got = render()
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
    return got, {k: v for k, v in counts.items() if v}, recs


def md_wrappers(tier: str):
    from gsrt_torch.ops import pair_expand, splat_packed
    return ((pair_expand, "expand_pairs_fused"),) + (
        ((pair_expand, "expand_pairs_binned"),) if tier == "compact"
        else ()) + ((splat_packed, "blend_packed"),)


def md_peak_mib(torch, render) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    render()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def md_data_parallel(torch, rows, cloud, camera, cfg, tier, ref, fails):
    """(a): calibrate_sharded, then render_data_parallel over MD_TILES
    row slabs of the card with the tiled render fn; launches, buffer,
    frame against the single-card frame, ms; rows from the last slab."""
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.parallel import (calibrate_sharded, make_render_mesh,
                                     render_data_parallel, tiled_render_fn)
    from gsrt_torch.parallel.tiles import _slab_camera
    t0 = time.perf_counter()
    mp = calibrate_sharded(cloud, camera, cfg, MD_TILES)
    cal_s = time.perf_counter() - t0
    slab_h = camera.height // MD_TILES
    need = [int(grt.count_pairs(cloud, _slab_camera(camera, i * slab_h,
                                                     slab_h), cfg))
            for i in range(MD_TILES)]
    mesh = make_render_mesh(MD_TILES, devices=[DEVICE] * MD_TILES)
    fn = tiled_render_fn(mp)
    render = lambda: render_data_parallel(cloud, camera, cfg, mesh,
                                          render_fn=fn)
    got, counts, recs = md_counted(torch, render, md_wrappers(tier))
    want = {k: MD_TILES for k in MD_PATH[tier]}
    frame = md_frame(torch, got, ref, cloud, camera, cfg, slab_h)
    res = dict(max_pairs=mp, calibrate_s=cal_s, slab_pairs=need,
               launches=counts, frame=frame, ms=time_cuda(render, 5),
               peak_mib=md_peak_mib(torch, render))
    if tier == "f32":
        res["jax_bounds"] = md_diff(torch, got, ref, **MD_BOUNDS["dp-f32"])
    log(f"phase multi-device: (a) {tier}: calibrate_sharded over "
        f"{MD_TILES} slabs of {slab_h} rows {cal_s:.2f} s on the host, "
        f"max_pairs {mp}; slab pairs {need}; launches {counts}")
    log(f"phase multi-device: (a) {tier} against the single-card frame: "
        f"{describe_frame(frame)}")
    if "jax_bounds" in res:
        log(f"phase multi-device: (a) {tier} at tests/test_parallel.py:"
            f"112-115's bounds: {describe_diff(res['jax_bounds'])}")
    log(f"phase multi-device: (a) {tier}: {res['ms']:.4f} ms a frame over "
        f"{MD_TILES} slabs, peak {res['peak_mib']:.0f} MiB (the slabs run "
        f"one after another on one card: the cost of slabbing, not a "
        f"speedup)")
    if counts != want:
        fails.append(f"(a) {tier} launched {counts}, want {want}")
    if max(need) > mp:
        fails.append(f"(a) {tier}: a slab needs {max(need)} pairs > {mp}")
    if not frame["ok"]:
        fails.append(f"(a) {tier} differs from the single-card frame")
    tag = "dp" if tier == "compact" else "dp-f32"
    res["rows"] = held_rows(
        torch, rows, recs, tag, counts,
        f"multi-device (a): the last of {MD_TILES} row slabs ({slab_h} "
        f"rows) of the render cell, {tier} payload", phase="multi-device")
    return res


def md_splat_sharded(torch, rows, cloud, camera, cfg, tier, ref, fails):
    """(b): shard_cloud_by_depth, calibrate_sharded and
    render_splat_sharded on an MD_MESH mesh of the card, both composites
    (the gather's counted run recorded on the compact payload), and the
    butterfly with a white background; launches, buffer, frames against
    the single-card frame and each other, ms, peak memory."""
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.parallel import (calibrate_sharded, make_render_mesh,
                                     render_splat_sharded, tiled_render_fn)
    from gsrt_torch.parallel.tiles import (_shard, _slab_camera,
                                           shard_cloud_by_depth)
    n_t, n_sh = MD_MESH
    slab_h = camera.height // n_t
    sharded = shard_cloud_by_depth(cloud, camera, n_sh)
    t0 = time.perf_counter()
    mp = calibrate_sharded(sharded, camera, cfg, n_t, n_sh)
    cal_s = time.perf_counter() - t0
    need = [int(grt.count_pairs(_shard(sharded, j, n_sh),
                                _slab_camera(camera, i * slab_h, slab_h),
                                cfg))
            for i in range(n_t) for j in range(n_sh)]
    mesh = make_render_mesh(n_t, n_sh, [DEVICE] * (n_t * n_sh))
    fn = tiled_render_fn(mp)
    want = {k: n_t * n_sh for k in MD_PATH[tier]}
    log(f"phase multi-device: (b) {tier}: {sharded.n} splats in {n_sh} "
        f"depth slabs over {n_t} row slabs of {slab_h} rows; "
        f"calibrate_sharded {cal_s:.2f} s on the host, max_pairs {mp}; "
        f"shard pairs {need}")
    if max(need) > mp:
        fails.append(f"(b) {tier}: a shard needs {max(need)} pairs > {mp}")
    res = dict(max_pairs=mp, calibrate_s=cal_s, shard_pairs=need)
    frames = {}
    for comp in ("gather", "butterfly", "white"):
        c = cfg.replace(white_background=comp == "white")
        render = lambda c=c, comp=comp: render_splat_sharded(
            sharded, camera, c, mesh, render_fn=fn,
            composite="gather" if comp == "gather" else "butterfly")
        record = tier == "compact" and comp == "gather"
        got, counts, recs = md_counted(
            torch, render, md_wrappers(tier) if record else ())
        frames[comp] = got
        target = (ref[0], ref[1] + ref[0][..., None]) if comp == "white" \
            else ref
        frame = md_frame(torch, got, target, cloud, camera, cfg, slab_h)
        r = dict(launches=counts, frame=frame, ms=time_cuda(render, 3),
                 peak_mib=md_peak_mib(torch, render),
                 jax_bounds=md_diff(torch, got, target,
                                    **MD_BOUNDS["sharded"]))
        log(f"phase multi-device: (b) {tier} {comp}: launches {counts}; "
            f"against the single-card frame: {describe_frame(frame)}; "
            f"{r['ms']:.4f} ms a frame, peak {r['peak_mib']:.0f} MiB")
        log(f"phase multi-device: (b) {tier} {comp} at tests/test_parallel"
            f".py:138-141's bounds: {describe_diff(r['jax_bounds'])}")
        if counts != want:
            fails.append(f"(b) {tier} {comp} launched {counts}, want {want}")
        if not frame["ok"]:
            fails.append(f"(b) {tier} {comp} differs from the single-card "
                         f"frame")
        if record:
            r["rows"] = held_rows(
                torch, rows, recs, "sharded", counts,
                f"multi-device (b): the last of {n_t}x{n_sh} shards "
                f"({sharded.n // n_sh} splats, {slab_h} rows) of the render "
                f"cell, gather composite", phase="multi-device")
        res[comp] = r
    comp_diff = md_diff(torch, frames["butterfly"], frames["gather"],
                        **MD_BOUNDS["composites"])
    res["butterfly_vs_gather"] = comp_diff
    log(f"phase multi-device: (b) {tier} butterfly against gather: "
        f"{describe_diff(comp_diff)}")
    if not comp_diff["ok"]:
        fails.append(f"(b) {tier}: butterfly differs from gather")
    return res


def md_padded(torch, fails) -> dict:
    """333 splats padded to 336 over a 2x4 mesh through the kernels: the
    padding splats bin no pair, and the frame matches the single-card
    one."""
    from gsrt_torch import RenderConfig
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.parallel import (calibrate_sharded, make_render_mesh,
                                     render_splat_sharded, tiled_render_fn)
    from gsrt_torch.parallel.tiles import _slab_camera, shard_cloud_by_depth
    from gsrt_torch.scene import random_cloud
    n_t, n_sh = MD_MESH
    cloud, camera = random_cloud(333, seed=6, width=256, height=128,
                                 device=DEVICE)
    cfg = RenderConfig(width=256, height=128, conic_mode="standard")
    sharded = shard_cloud_by_depth(cloud, camera, n_sh)
    pad = type(sharded)(*(x[cloud.n:] for x in sharded))
    pad_pairs = [int(grt.count_pairs(pad, _slab_camera(camera, 64 * i, 64),
                                     cfg)) for i in range(n_t)]
    mp = calibrate_sharded(sharded, camera, cfg, n_t, n_sh)
    ref = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)(cloud, camera)
    got, counts, _ = md_counted(torch, lambda: render_splat_sharded(
        sharded, camera, cfg, make_render_mesh(n_t, n_sh,
                                               [DEVICE] * (n_t * n_sh)),
        render_fn=tiled_render_fn(mp), composite="butterfly"), ())
    frame = md_frame(torch, got, (ref.trans, ref.color), cloud, camera, cfg,
                     camera.height // n_t)
    log(f"phase multi-device: padded: {pad.n} padding splats bin "
        f"{pad_pairs} pairs in the slabs; launches {counts}; against the "
        f"single-card frame: {describe_frame(frame)}")
    if any(pad_pairs) or pad.opacity.any():
        fails.append(f"padding splats bin {pad_pairs} pairs")
    if counts != {k: n_t * n_sh for k in MD_PATH["compact"]}:
        fails.append(f"padded case launched {counts}")
    if not frame["ok"]:
        fails.append("padded case differs from the single-card frame")
    return dict(pad_splats=pad.n, pad_pairs=pad_pairs, launches=counts,
                frame=frame)


def md_train(torch, fails) -> dict:
    """make_train_step_dp over MD_TILES row slabs of the card against
    train_step (λ_ssim 0, so the slabs' mean loss and gradients are the
    whole image's), from the same parameters: no kernel may launch."""
    import numpy as np
    from gsrt_torch import RenderConfig
    from gsrt_torch.interop import params_from_numpy, params_to_numpy
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.models.trainer import (init_params, make_optimizer,
                                           make_train_step_dp, train_step)
    from gsrt_torch.parallel import make_render_mesh
    from gsrt_torch.scene import demo_gauss_splat
    cloud, camera = demo_gauss_splat(width=64, height=64, device=DEVICE)
    cfg = RenderConfig(width=64, height=64, conic_mode="standard")
    target = grt.render_fast(cloud, camera, cfg).color * 0.5
    arrays = params_to_numpy(init_params(cloud))
    p1, p2 = (params_from_numpy(*arrays, device=DEVICE) for _ in range(2))
    loss1 = float(train_step(p1, make_optimizer(p1), target, camera, cfg,
                             lambda_ssim=0.0))
    step = make_train_step_dp(
        cfg, make_optimizer(p2),
        make_render_mesh(MD_TILES, devices=[DEVICE] * MD_TILES), 0.0)
    loss2, counts, _ = md_counted(
        torch, lambda: step(p2, target, camera), ())
    loss2 = float(loss2)
    a, b = params_to_numpy(p2), params_to_numpy(p1)
    same = {name: bool(np.allclose(a[k], b[k], rtol=1e-4, atol=1e-6))
            for k, name in ((0, "means"), (4, "sh"))}
    ok = abs(loss2 - loss1) <= 1e-5 * abs(loss1) and all(same.values())
    step_ms = time_cuda(lambda: step(p2, target, camera), 3)
    single_ms = time_cuda(lambda: train_step(
        p1, make_optimizer(p1), target, camera, cfg, lambda_ssim=0.0), 3)
    log(f"phase multi-device: train: make_train_step_dp over {MD_TILES} "
        f"slabs loss {loss2:.8f}, train_step {loss1:.8f} (rtol 1e-5); "
        f"means and SH within rtol 1e-4 / atol 1e-6 {same}; launches "
        f"{counts}; {step_ms:.3f} ms a DP step, {single_ms:.3f} ms a "
        f"single step")
    if not ok:
        fails.append("the DP train step differs from train_step")
    if counts:
        fails.append(f"the DP train step launched {counts}")
    return dict(loss=loss2, single_loss=loss1, params_close=same,
                launches=counts, ms=step_ms, single_ms=single_ms)


def md_ranks(torch, cloud, camera, cfg, fails) -> dict:
    """Two ranks on the card, spawned as processes and joined over TCP on
    localhost with backend="gloo" (NCCL refuses two ranks on one card):
    each renders its row slab of the render cell through
    render_data_parallel on global_render_mesh() with the tiled render
    fn, then gather_to_hosts and sync_hosts, and render_data_parallel_global
    at tests/test_multihost.py's size. Rank 0's image must equal the
    in-process render over MD_RANKS slabs bit for bit; the small one
    render_fast's within test_multihost's bounds."""
    import socket
    import tempfile
    import numpy as np
    from gsrt_torch import RenderConfig
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.parallel import (calibrate_sharded, make_render_mesh,
                                     render_data_parallel, tiled_render_fn)
    from gsrt_torch.scene import random_cloud
    mp = calibrate_sharded(cloud, camera, cfg, MD_RANKS)
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    log(f"phase multi-device: ranks: {MD_RANKS} processes on the card, "
        f"backend gloo, localhost:{port}, max_pairs {mp}")
    reports, logs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.npz")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", MD_RANK_CODE, str(port), str(r), str(mp),
             out], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(MD_RANKS)]
        try:
            for r, p in enumerate(procs):
                left = MD_RANK_TIMEOUT - (time.perf_counter() - t0)
                try:
                    so, se = p.communicate(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    fails.append(f"rank {r} did not end within "
                                 f"{MD_RANK_TIMEOUT} s")
                    break
                logs.append(f"rank {r} (exit {p.returncode}): "
                            f"{se[-2000:]}")
                if p.returncode != 0:
                    fails.append(f"rank {r} exited {p.returncode}")
                reports += [json.loads(line[5:]) for line in so.splitlines()
                            if line.startswith("RANK ")]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        got = dict(np.load(out)) if os.path.exists(out) else None
    for line in logs:
        if "exit 0" not in line:
            log(f"phase multi-device: {line}")
    res = dict(wall_s=wall, reports=reports, max_pairs=mp)
    log(f"phase multi-device: ranks: {wall:.1f} s wall; {reports}")
    want_y0 = [[r * camera.height // MD_RANKS] for r in range(MD_RANKS)]
    path = {k: 1 for k in MD_PATH["compact"]}
    if len(reports) != MD_RANKS or [r["y0"] for r in reports] != want_y0 \
            or any(r["launches"] != path or r["backend"] != "gloo"
                   for r in reports):
        fails.append(f"ranks reported {reports}: want each slab y0 "
                     f"{want_y0}, launches {path}, backend gloo")
    if got is None:
        fails.append("rank 0 wrote no image")
        return res
    mesh = make_render_mesh(MD_RANKS, devices=[DEVICE] * MD_RANKS)
    trans, color = render_data_parallel(cloud, camera, cfg, mesh,
                                        render_fn=tiled_render_fn(mp))
    same = bool(np.array_equal(got["trans"], trans.cpu().numpy())
                and np.array_equal(got["color"], color.cpu().numpy()))
    sc, scam = random_cloud(256, seed=3, width=64, height=32, device=DEVICE)
    ref = grt.render_fast(sc, scam, RenderConfig(
        width=64, height=32, conic_mode="standard", splat_chunk=64))
    small = bool(np.allclose(got["small_trans"], ref.trans.cpu().numpy(),
                             rtol=1e-5, atol=1e-6)
                 and np.allclose(got["small_color"], ref.color.cpu().numpy(),
                                 rtol=1e-5, atol=1e-5))
    res.update(image_bitwise_equal=same, small_within_bounds=small)
    log(f"phase multi-device: ranks: the gathered 1080p frame equals the "
        f"in-process render over {MD_RANKS} slabs bit for bit: {same}; "
        f"render_data_parallel_global at 64x32 within rtol 1e-5 of "
        f"render_fast: {small}")
    if not same:
        fails.append("the two ranks' frame differs from the in-process one")
    if not small:
        fails.append("render_data_parallel_global differs from render_fast")
    return res


def multi_device_phase(torch, rows) -> dict:
    """multi-device: the sharded paths of gsrt_torch.parallel on one card
    (see the module docstring). Appends the rows that hold the path's
    kernels on the last shard's inputs to `rows`."""
    from gsrt_torch.models import gaussian_rt as grt
    t0 = time.perf_counter()
    fails = []
    cfg0, cloud, camera = render_cell()
    out = {}
    for tier, kw in MD_TIERS:
        cfg = cfg0.replace(**kw)
        tracer = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)
        frame = tracer(cloud, camera)
        ref = (frame.trans, frame.color)
        res = dict(single_ms=time_cuda(lambda: tracer(cloud, camera), 5),
                   single_peak_mib=md_peak_mib(
                       torch, lambda: tracer(cloud, camera)),
                   single_max_pairs=tracer.max_pairs)
        log(f"phase multi-device: {tier}: the single-card frame "
            f"{res['single_ms']:.4f} ms, peak {res['single_peak_mib']:.0f} "
            f"MiB, max_pairs {tracer.max_pairs}; "
            f"{int((frame.trans <= MD_TERM_EPS).sum())} px at or below "
            f"{MD_TERM_EPS}")
        res["dp"] = md_data_parallel(torch, rows, cloud, camera, cfg, tier,
                                     ref, fails)
        res["sharded"] = md_splat_sharded(torch, rows, cloud, camera, cfg,
                                          tier, ref, fails)
        out[tier] = res
        del tracer, frame, ref
    out["padded"] = md_padded(torch, fails)
    out["train"] = md_train(torch, fails)
    out["ranks"] = md_ranks(torch, cloud, camera, cfg0, fails)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase multi-device: {out['seconds']:.1f} s")
    if fails:
        raise SystemExit("phase multi-device: " + "; ".join(fails))
    return out


def main() -> int:
    t_run = time.perf_counter()
    card = phase_device()
    try:
        import torch
        from gsrt_torch import RenderConfig, _kernels
        from gsrt_torch.models import gaussian_rt as grt
        from gsrt_torch.ops import pair_expand, splat_packed, tile_binning
        from gsrt_torch.scene import random_cloud
    except ImportError as e:
        raise SystemExit(f"gsrt_torch is not importable here: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    W, H = WIDTH, HEIGHT
    t0 = time.perf_counter()
    cfg, cloud, camera = render_cell()
    torch.cuda.synchronize()
    log(f"workload: {SPLATS} splats, {W}x{H}, SH degree "
        f"{cloud.sh_degree}, made in {time.perf_counter() - t0:.2f} s")

    # --- capture: one render with the kernel entry points recorded ---
    tracer = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)
    t0 = time.perf_counter()
    tracer.calibrate(cloud, camera)
    log(f"phase capture: calibrate {time.perf_counter() - t0:.2f} s, "
        f"max_pairs {tracer.max_pairs}, max_rows {tracer.max_rows}")
    with Recorder(pair_expand, "expand_pairs_fused") as rec_fused, \
            Recorder(pair_expand, "expand_pairs_binned") as rec_binned, \
            Recorder(splat_packed, "blend_packed") as rec_blend:
        out = tracer(cloud, camera)
        torch.cuda.synchronize()
    if not (len(rec_fused.calls) == len(rec_binned.calls)
            == len(rec_blend.calls) == 1):
        raise SystemExit("phase capture: expected one call per kernel "
                         "entry point (an overflow re-render happened?)")
    (tab1, ubase, mu), _ = rec_fused.calls[0]
    (tab2, pbase, mp), emit_kw = rec_binned.calls[0]
    (binning,), blend_kw = rec_blend.calls[0]
    total = int(binning.total_pairs)
    dead = pair_expand._DEAD_BASE
    splats_live = int((ubase != dead).sum())
    units = int((pbase != dead).sum())
    log(f"phase capture: {splats_live} splats with pairs, {units} units, "
        f"{total} pairs; buffers {mu} units, {mp} pairs; overflow "
        f"{bool(out.overflow)}")

    # --- expand parity, at the main path's two shapes ---
    rows = []
    n1, n2 = tab1.shape[1], tab2.shape[1]
    rows.append(expand_row(
        "expand_pairs_fused", EXPAND_TPU,
        lambda: pair_expand.expand_pairs_fused(tab1, ubase, mu),
        lambda: pair_expand.expand_pairs_plain(tab1, ubase, mu),
        lambda: tab1.index_select(1, torch.searchsorted(
            ubase, torch.arange(mu, device=DEVICE, dtype=torch.int32),
            right=True).sub_(1).clamp_(0, n1 - 1)),
        None, 4 * (tab1.shape[0] * (mu + n1) + n1)))
    rows.append(expand_row(
        "expand_pairs_binned", EXPAND_TPU,
        lambda: pair_expand.expand_pairs_binned(tab2, pbase, mp, **emit_kw),
        lambda: pair_expand.expand_pairs_binned_plain(tab2, pbase, mp,
                                                      **emit_kw),
        None, None,
        4 * (pair_expand.EMIT_ROWS * mp
             + pair_expand.EMIT_TAB_ROWS * n2 + n2)))

    # --- partition parity: the group stream's tile lists, bit for bit ---
    ntx, nty = tile_binning.tile_extent(W, H, cfg.tile_w, cfg.tile_h)
    T, bs = ntx * nty, blend_kw["bs"]
    npx = cfg.tile_w * cfg.tile_h
    t0 = time.perf_counter()
    order_p, seg_p = splat_packed.partition_group_stream_plain(
        binning.payload[4], binning.tile_start, T, bs)
    torch.cuda.synchronize()
    part_plain_s = time.perf_counter() - t0
    part = lambda: splat_packed.partition_group_stream(binning, T, bs)
    order_k, seg_k = part()
    torch.cuda.synchronize()
    n_cols = int(seg_p[T])
    if not (torch.equal(seg_k, seg_p)
            and torch.equal(order_k[:n_cols], order_p[:n_cols])):
        raise SystemExit("phase blend: the partition kernel differs from "
                         "its plain version")
    rows.append(dict(
        name="partition_group_stream", route="cuda", source=BLEND_SRC,
        replaces=BLEND_TPU, launches=0, max_abs_err=0.0,
        ms=time_cuda(part, 20), plain_ms=part_plain_s * 1e3,
        bound_ms=4 * (2 * n_cols + 2 * (T + 1)) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=time_cuda(lambda: torch.sort(
            binning.payload[4, :n_cols], stable=True), 10)))
    log(f"phase blend: partition of {n_cols} columns into {T} tile lists "
        f"bitwise equal to its plain version (seg == tile_start "
        f"{torch.equal(seg_k, binning.tile_start)}); kernel "
        f"{rows[-1]['ms']:.4f} ms, plain {rows[-1]['plain_ms']:.1f} ms, "
        f"bound {rows[-1]['bound_ms']:.4f} ms (bytes), stable torch.sort "
        f"{rows[-1]['library_ms']:.4f} ms")

    # --- blend parity on the captured payload, every tile, hits too ---
    stats = {}
    plain_kw = {k: blend_kw[k] for k in (
        "width", "height", "sub_w", "sub_h", "bs", "g_cutoff",
        "alpha_threshold", "alpha_clamp", "skip_range_check")}
    hits_kw = {**blend_kw, "track_hits": True}
    t0 = time.perf_counter()
    color_p, trans_p, hits_p = splat_packed.blend_packed_plain(
        binning, stats=stats, track_hits=True, **plain_kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    color_k, trans_k, hits_k = splat_packed.blend_packed(binning, **hits_kw)
    torch.cuda.synchronize()
    err = max_abs_err(color_k - color_p, trans_k - trans_p)
    hd = (hits_k - hits_p).abs()
    hits_off = int((hd != 0).sum())
    culled = stats["culled_steps"] / stats["warp_steps"]
    log(f"phase blend: all {T} tiles, max |kernel - plain| {err:.3e} (atol "
        f"2e-3), hits differ at {hits_off} px by at most "
        f"{int(hd.max())} (<= 1 on <= 0.1%), {stats['pairs_blended']} "
        f"pairs blended of {total}; the row cull removes "
        f"{stats['culled_steps']} of {stats['warp_steps']} (warp, pair) "
        f"steps ({culled:.4f})")
    if not (err <= 2e-3 and hd.max().item() <= 1
            and hits_off <= 1e-3 * hd.numel()):
        raise SystemExit(f"phase blend: kernel differs from plain by {err}, "
                         f"hits at {hits_off} px")
    group_info = blend_kernel_info("group", blend_kw, npx)
    clock_hz = max_sm_clock_hz()
    log(f"phase blend: group kernel build: {describe_build(group_info)}; "
        f"top SM clock " + (f"{clock_hz / 1e6:.0f} MHz" if clock_hz
                            else "not read"))
    blend_ops = BLEND_FLOPS_PER_PAIR_PIXEL * npx * stats["pairs_blended"]
    blend_bytes = 4 * (tile_binning.COMPACT_WIDTH * total
                       + binning.tile_start.numel()) + 16 * W * H
    t_ops, t_bytes = blend_ops / F32_FLOPS, blend_bytes / HBM_BYTES_PER_S
    # the blend kernel alone: the partition's lists computed once
    with Replaced(splat_packed, "partition_group_stream",
                  lambda *a: (order_k, seg_k)):
        group_ms = time_cuda(
            lambda: splat_packed.blend_packed(binning, **blend_kw), 10)
    stage_ms = time_cuda(
        lambda: splat_packed.blend_packed(binning, **blend_kw), 10)
    rows.append(dict(
        name="blend_packed_group", route="cuda", source=BLEND_SRC,
        replaces=BLEND_TPU, launches=0, max_abs_err=err, ms=group_ms,
        plain_ms=plain_s * 1e3, bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, **blend_floor(stats, group_info, clock_hz),
        hits_differing=hits_off, build=group_info))
    log(f"phase blend: kernel {rows[-1]['ms']:.4f} ms, plain "
        f"{rows[-1]['plain_ms']:.1f} ms, bound {rows[-1]['bound_ms']:.4f} ms"
        f" ({rows[-1]['bound_by']}), instruction floor "
        + (f"{rows[-1]['instruction_floor_ms']:.4f} ms"
           if rows[-1]["instruction_floor_ms"] else "not measured")
        + f"; partition + blend {stage_ms:.4f} ms")
    del color_p, trans_p, color_k, trans_k, hits_p, hits_k, order_p, seg_p

    # --- main path: counts to 0, calibrate + one frame, counts read ---
    main_tracer = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    main_tracer.calibrate(cloud, camera)
    out = main_tracer(cloud, camera)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    log(f"phase main: launches {counts}")
    for row in rows:    # the render path's kernels
        if counts[row["name"]] <= 0:
            raise SystemExit(f"phase main: kernel {row['name']} never "
                             f"launched")
    if bool(out.overflow):
        raise SystemExit("phase main: the calibrated frame overflowed")
    if out.color.shape != (H, W, 3) or out.trans.shape != (H, W):
        raise SystemExit(f"phase main: output shapes {out.color.shape}, "
                         f"{out.trans.shape}")
    if not (torch.isfinite(out.color).all() and torch.isfinite(out.trans)
            .all()):
        raise SystemExit("phase main: non-finite output")
    for row in rows:
        row["launches"] = counts[row["name"]]
    log(f"phase main: color mean {out.color.mean().item():.5f}, trans mean "
        f"{out.trans.mean().item():.5f}")

    # per-stage and whole-frame times (CUDA events, steady state)
    mpairs, mrows = main_tracer.max_pairs, main_tracer.max_rows
    state = {}

    def stage_project():
        c = grt._precompute(cloud, camera, cfg)
        state["cols"] = (c.depth, c.m2x, c.m2y, c.qa, c.qb, c.qc,
                         cloud.opacity, c.cr, c.cg, c.cb, c.rx, c.ry,
                         c.alive)

    def stage_binning():
        state["binning"] = tile_binning.build_tile_binning(
            *state["cols"], width=W, height=H, tile_w=cfg.tile_w,
            tile_h=cfg.tile_h, max_pairs=mpairs, max_rows=mrows)

    def stage_blend():
        splat_packed.blend_packed(state["binning"], **blend_kw)

    def frame():
        grt.render_tiled(cloud, camera, cfg, max_pairs=mpairs,
                         max_rows=mrows)

    stage_project()
    stage_binning()
    stages = {"project_sh_extents": time_cuda(stage_project, 10),
              "binning_group_stream": time_cuda(stage_binning, 10),
              "blend": time_cuda(stage_blend, 10)}
    frame_ms = min(time_cuda(frame, FRAMES) for _ in range(3))
    mrays = W * H / (frame_ms * 1e-3) / 1e6
    for k, v in stages.items():
        log(f"phase main: stage {k} {v:.4f} ms")
    log(f"phase main: frame {frame_ms:.4f} ms/frame, {mrays:.2f} Mrays/s; "
        f"{splats_live} splats with pairs, {units} units, {total} pairs; "
        f"max_pairs {mpairs}, max_rows {mrows}")
    # --- small-scene check against the port's oracle ---
    small = RenderConfig(width=256, height=256)
    sc, scam = random_cloud(20_000, seed=1, width=256, height=256,
                            device=DEVICE)
    ref = grt.render_fast(sc, scam, small)
    til = grt.GaussianRayTracer(small, "tiled", device=DEVICE)(sc, scam)
    torch.cuda.synchronize()
    d = (til.color - ref.color).abs().max().item()
    log(f"phase check: 20000 splats 256x256, render_tiled vs render_fast "
        f"max |color diff| {d:.3e} (atol 2e-2)")
    if not d <= 2e-2:
        raise SystemExit(f"phase check: render_tiled differs by {d}")

    del main_tracer, tracer, out, state
    projection = projection_phase(torch, rows)
    tile_bin = tile_bin_phase(torch, rows)
    tiles128_render(torch, cloud, camera, rows)
    # the serving workload's cloud is this one (extent 4.0), seen from an
    # orbit
    serving = serve_phases(torch, cloud, rows)
    del cloud, camera
    train_rows, train = train_phases(torch)
    rows += train_rows
    import tempfile
    # the fit's capture (COLMAP model, targets as PNGs) stays for `cli fit`
    with tempfile.TemporaryDirectory() as capture_dir:
        fit = fit_phase(torch, rows, card, capture_dir)
        t0 = time.perf_counter()
        kbuffer = dict(kbuffer=kbuffer_phase(torch, card),
                       splat_trace=splat_trace_phase(torch, card),
                       mixed=mixed_phase(torch, rows, card),
                       ellipse=ellipse_phase(torch, rows, card))
        log(f"phases kbuffer, splat-trace, mixed, ellipse: "
            f"{time.perf_counter() - t0:.1f} s")
        scenes = scenes_phase(torch, rows, card)
        tri = tri_phases(torch, rows)
        tri["bvh"] = bvh_phase(torch, rows)
        tri["pt_shade"] = pt_shade_phase(torch, rows)
        splat_bvh = splat_bvh_phase(torch, rows)
        front_ends = front_ends_phase(
            torch, rows, capture_dir, scenes["catalog"]["rtiow"].pop("image"),
            serving, mrays, frame_ms)
    multi_device = multi_device_phase(torch, rows)
    log("kernels: " + ", ".join(f"{r['name']} x{r['launches']}"
                                for r in rows))
    log(f"run: {time.perf_counter() - t_run:.1f} s wall")

    print(json.dumps({"kernels": rows, "frame_ms": frame_ms,
                      "mrays_per_s": mrays, "stages_ms": stages,
                      "splats_with_pairs": splats_live, "units": units,
                      "pairs": total, "max_pairs": mpairs,
                      "max_rows": mrows, "projection": projection,
                      "tile_bin": tile_bin,
                      "serving": serving,
                      "train": train, "fit": fit, "kbuffer": kbuffer,
                      "tri": tri, "splat_bvh": splat_bvh, "scenes": scenes,
                      "front_ends": front_ends,
                      "multi_device": multi_device,
                      "wall_s": time.perf_counter() - t_run}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
