"""Command-line interface of the port (counterpart of `gsrt.cli`): the
same subcommands, options and defaults over the port's renderers, plus
`--device` (CUDA unless named; the CLI never picks the CPU by itself).

  python -m gsrt_torch.cli render  --scene 3DGS --width 128 --height 128 --out o.png
  python -m gsrt_torch.cli render  --ply garden.ply --width 1920 --height 1080
  python -m gsrt_torch.cli pt      --scene rtiow --samples 8 --bounces 16
  python -m gsrt_torch.cli bench   --out results.json          # lumibench-style sweep

Nothing is compiled ahead of a call, so each timed render runs once to
warm (kernel libraries, calibration, allocator) and once on the clock,
which is read after the card's queued work has finished. A failed render,
build or launch ends the command with its exception. Images are written
and read by the port's own PNG codec (`gsrt_torch.utils.image`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from gsrt_torch.core.types import resolve_device
from gsrt_torch.utils.image import as_numpy


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device):
    """(result, seconds) of fn's second call; the first warms."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _add_device(p):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the command runs on")


def _add_common(p):
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--samples", type=int, default=1)
    p.add_argument("--bounces", type=int, default=16)
    p.add_argument("--out", type=str, default=None, help="PNG output path")
    p.add_argument("--dump-binary", type=str, default=None,
                   help="reference-style image.binary dump path")
    p.add_argument("--stats", action="store_true")
    _add_device(p)


def cmd_render(args) -> int:
    """Ray-traced 3DGS rendering (the reference's --scene '3DGS' path)."""
    from gsrt_torch.core.config import RenderConfig
    from gsrt_torch.core.types import look_at, make_camera
    from gsrt_torch.models.gaussian_rt import GaussianRayTracer
    from gsrt_torch.scene.catalog import demo_gauss_splat, random_cloud
    from gsrt_torch.utils.image import dump_image_binary, save_png
    from gsrt_torch.utils.stats import RenderStats

    dev = resolve_device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples=args.samples,
                       conic_mode="reference" if args.reference_conic
                       else "standard",
                       use_exp_lut=args.exp_lut, k=args.k,
                       expand_impl=args.expand_impl, payload=args.payload,
                       span_mode=args.span_mode, scan_impl=args.scan_impl)
    if args.ply:
        from gsrt_torch.scene.ply import load_gaussian_ply
        cloud = load_gaussian_ply(args.ply, device=dev)
        means = as_numpy(cloud.means)
        center = means.mean(0)
        eye = center + np.asarray([0, 0, -4.0]) * float(
            np.abs(means - center).max() / 2 + 1)
        if args.camera:
            from gsrt_torch.scene.obj import load_camera_file
            eye, center = load_camera_file(args.camera)
        camera = make_camera(look_at(eye, center), args.fov, args.width,
                             args.height, device=dev)
    elif args.scene == "3DGS":
        cloud, camera = demo_gauss_splat(args.width, args.height,
                                         device=dev)
    elif args.scene.startswith("random"):
        n = int(args.scene[len("random"):] or "100000")
        cloud, camera = random_cloud(n, width=args.width,
                                     height=args.height, device=dev)
    else:
        print(f"unknown gaussian scene {args.scene!r}", file=sys.stderr)
        return 2

    rt = GaussianRayTracer(cfg, mode=args.mode, device=dev)
    out, dt = _timed(lambda: rt(cloud, camera), dev)

    if args.out:
        save_png(args.out, out.color)
        print(f"wrote {args.out}")
    if args.dump_binary:
        dump_image_binary(args.dump_binary, out.color)
    if args.heatmap:
        from gsrt_torch.utils.heatmap import heatmap
        save_png(args.heatmap, heatmap(out.hits))
        print(f"wrote {args.heatmap}")
    if args.stats:
        st = RenderStats(width=args.width, height=args.height,
                         samples=args.samples, n_splats=cloud.n)
        st.from_output(out, hits_granularity=(
            "tile-pairs" if args.mode == "tiled" else "pixel")).finish(dt)
        if out.overflow is not None:
            st.overflow = bool(out.overflow)
        print(st.to_json())
    else:
        print(f"{dt * 1e3:.1f} ms  "
              f"{args.width * args.height / dt / 1e6:.2f} Mrays/s")
    return 0


def _pt_scenes():
    from gsrt_torch.scene import primitives_catalog as cat
    return {"rtiow": cat.ray_tracing_in_one_weekend,
            "cornell": cat.cornell_box,
            "cubes": cat.cube_and_spheres,
            "planets": cat.planets_in_one_weekend,
            "cubesgrid": cat.cubes_and_common_scene,
            "cylinders": cat.cylinder_cubes_common_scene,
            "mandelbulb": cat.mandelbulb_scene,
            "simple": cat.simple_test}


def _light(scene_name: str):
    return (278, 554, -279) if scene_name == "cornell" else (0, 5, 2)


def cmd_pt(args) -> int:
    """Path tracing / shadow / AO workloads (--shader-type analogues)."""
    from gsrt_torch.core.config import RenderConfig
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.utils.image import save_png

    dev = resolve_device(args.device)
    scenes = _pt_scenes()
    if args.scene == "obj":
        from gsrt_torch.core.types import look_at, make_camera
        from gsrt_torch.scene.obj import load_obj
        scene = load_obj(args.obj, device=dev)
        allv = np.concatenate([as_numpy(v) for v in (
            scene.tri_v0, scene.tri_v1, scene.tri_v2)], axis=0)
        lo, hi = allv.min(0), allv.max(0)
        c = 0.5 * (lo + hi)
        eye = c + (hi - lo) * np.asarray([0.0, 0.3, 1.8])
        camera = make_camera(look_at(eye, c), 40.0, args.width, args.height,
                             device=dev)
        extra = dict(aperture=0.0, focus=1.0, has_sky=True, gamma=True)
    elif args.scene in scenes:
        scene, camera, extra = scenes[args.scene](args.width, args.height,
                                                  device=dev)
    else:
        print(f"unknown scene {args.scene!r}; have {list(scenes)} + obj",
              file=sys.stderr)
        return 2

    cfg = RenderConfig(width=args.width, height=args.height,
                       samples=args.samples, bounces=args.bounces,
                       shadow_rays=args.shadowrays, ao_rays=args.aorays,
                       has_sky=extra["has_sky"],
                       gamma_correction=extra["gamma"])
    if args.mips:
        scene = pt.with_texture_mips(scene)
        if scene.tex_mips is None:
            print("note: --mips ignored (scene has no UV textures)",
                  file=sys.stderr)
    pk = {}
    if args.primary == "binned" and int(scene.tri_v0.shape[0]) > 0 and \
            scene.alpha_textures is None and \
            (extra["aperture"] == 0.0 or args.shader_type != "path"):
        pk = dict(primary_impl="binned")
    elif args.primary == "binned":
        print("note: binned primary unavailable for this scene "
              "(no triangles, alpha cutouts, or aperture > 0) — "
              "using the block path", file=sys.stderr)
    tri = {}
    if int(scene.tri_v0.shape[0]) > 0:
        # the binned primary's pair buffer (the "auto" primary bins too):
        # the port's count × 1.1, the slack `calibrate` gives splat pairs
        from gsrt_torch.models.gaussian_rt import pair_bucket
        from gsrt_torch.ops.tri_binning import count_tri_pairs_numpy
        need = count_tri_pairs_numpy(scene.tri_v0, scene.tri_v1,
                                     scene.tri_v2, camera, tile_w=cfg.tile_w,
                                     tile_h=cfg.tile_h)
        tri["tri_max_pairs"] = pair_bucket(int(need * 1.1))
    flags = {}

    def flagged(img, f):
        flags.update({k: bool(v) for k, v in f.items()})
        return img
    if args.shader_type == "path":
        def fn():
            img, info = pt.render_path_traced_calibrated(
                scene, camera, cfg, aperture=extra["aperture"],
                focus=extra["focus"], **pk, **tri)
            return flagged(img, info["flags"])
    elif args.shader_type == "shadow":
        fn = lambda: flagged(*pt.render_shadow_rays(  # noqa: E731
            scene, camera, cfg, light_pos=_light(args.scene),
            return_flags=True, **pk, **tri))
    elif args.shader_type == "ao":
        fn = lambda: flagged(*pt.render_ambient_occlusion(  # noqa: E731
            scene, camera, cfg, return_flags=True, **pk, **tri))
    else:   # "foveated"
        fn = lambda: pt.render_foveated(  # noqa: E731
            scene, camera, cfg, aperture=extra["aperture"],
            focus=extra["focus"], **tri)
    img, dt = _timed(fn, dev)
    rays = args.width * args.height * args.samples
    print(f"{dt * 1e3:.1f} ms  {rays / dt / 1e6:.2f} Mrays/s")
    if flags:
        print("overflow flags: " + json.dumps(flags))
    if args.out:
        save_png(args.out, img)
        print(f"wrote {args.out}")
    return 0


def cmd_bench(args) -> int:
    """lumibench.sh-style sweep: scene × shader-type grid at 128x128
    (lumibench.sh:1-46), emitting one JSON record per run.

    --suite lumibench sweeps the named reference datasets
    (gsrt_torch.scene.reference_scenes) through the packed-cluster table,
    reporting cluster visits and primitive tests per camera ray (the
    rt_avg_nodes_per_ray analogue, gpu-sim.cc:1504-1532)."""
    import functools

    from gsrt_torch.core.config import RenderConfig
    from gsrt_torch.models import path_tracer as pt

    dev = resolve_device(args.device)
    results = []
    if args.suite == "lumibench":
        from gsrt_torch.scene.reference_scenes import (
            REFERENCE_SCENES, reference_data_available)
        if not reference_data_available():
            print("reference Scenes/ data not found", file=sys.stderr)
            return 1
        scenes = {k: functools.partial(f, max_files=args.max_files)
                  for k, f in REFERENCE_SCENES.items()}
    else:
        scenes = {k: v for k, v in _pt_scenes().items()
                  if k in ("rtiow", "cornell", "cubes")}
    if args.scenes:
        keep = set(args.scenes.split(","))
        scenes = {k: v for k, v in scenes.items() if k in keep}
    for sname, factory in scenes.items():
        scene, camera, extra = factory(args.width, args.height, device=dev)
        cfg = RenderConfig(width=args.width, height=args.height,
                           samples=args.samples, bounces=args.bounces,
                           has_sky=extra["has_sky"],
                           gamma_correction=extra["gamma"])
        n_tris = int(scene.tri_v0.shape[0])
        stats = {}
        if args.suite == "lumibench":
            scene = pt.with_tri_table(scene)
            if scene.tri_table is not None:
                # traversal work on the primary bundle: visited
                # super-clusters per block x 128 leaf tris per cluster
                from gsrt_torch.ops.tri_kernel import closest_hit_packed
                gen = torch.Generator(device=dev).manual_seed(0)
                orig, dirn = pt.generate_camera_rays(gen, camera, cfg)
                *_, plan = closest_hit_packed(
                    scene.tri_table, orig, dirn, cfg.t_min, cfg.t_max)
                R = orig.shape[0]
                nb = max(R // 512, 1)
                stats = {"tris": n_tris,
                         "sup_visits_per_block": round(
                             float(plan.total) / nb, 1),
                         "prim_tests_per_ray": round(
                             float(plan.total) * 8 * 128 / R, 1)}
                # executed visits: the front-to-back early exit and the
                # best-t bound stop blocks well short of the plan
                act = float(plan.actual.float().mean())
                stats["sup_visits_actual_per_block"] = round(act, 1)
                stats["prim_tests_per_ray_max"] = round(
                    act * 8 * 128 / 512, 1)
            else:
                scene = pt.with_tri_clusters(scene)
        pk = {}
        if args.primary == "binned" and n_tris > 0 and \
                scene.alpha_textures is None:
            from gsrt_torch.models.gaussian_rt import pair_bucket
            from gsrt_torch.ops.tri_binning import count_tri_pairs_numpy
            exact = args.tri_span == "exact"
            need = count_tri_pairs_numpy(
                scene.tri_v0, scene.tri_v1, scene.tri_v2, camera,
                tile_w=cfg.tile_w, tile_h=cfg.tile_h, span_exact=exact)
            want = pair_bucket(int(need * 1.1))
            if want > args.tri_max_pairs:
                print(f"warning: {sname} needs ~{need} tri pairs but "
                      f"--tri-max-pairs caps at {args.tri_max_pairs}; "
                      "the binned cast will truncate", file=sys.stderr)
            pk = dict(primary_impl="binned", tri_span_exact=exact,
                      tri_max_pairs=min(want, args.tri_max_pairs))
            # candidate work of the binned path: (tile, tri) pairs per
            # pixel — the rasterizer-side rt_avg_nodes_per_ray
            stats["binned_pairs"] = int(need)
            stats["candidates_per_pixel"] = round(
                need / (args.width * args.height), 2)
        for wname, fn in [
            ("PT", lambda: pt.render_path_traced(scene, camera, cfg, **pk)),
            ("SH", lambda: pt.render_shadow_rays(
                scene, camera, cfg, light_pos=_light(sname), **pk)),
            ("AO", lambda: pt.render_ambient_occlusion(scene, camera, cfg,
                                                       **pk)),
        ]:
            _, dt = _timed(fn, dev)
            rec = {"scene": sname, "workload": wname,
                   "width": args.width, "height": args.height,
                   "samples": args.samples, "ms": round(dt * 1e3, 2),
                   "mrays_s": round(args.width * args.height *
                                    args.samples / dt / 1e6, 3), **stats}
            results.append(rec)
            print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


def _cloud_extent(cloud):
    """(centre [3] of the means, their largest |offset| from it)."""
    means = as_numpy(cloud.means)
    center = means.mean(0)
    return center, float(np.abs(means - center).max())


def cmd_orbit(args) -> int:
    """Offline camera-path rendering with temporal-reuse serving — the
    headless analogue of the reference's interactive orbit
    (ModelViewController.cpp) plus the frame-coherent cull of
    gsrt_torch.serving."""
    from gsrt_torch.core.config import RenderConfig
    from gsrt_torch.models.gaussian_rt import GaussianRayTracer
    from gsrt_torch.scene.campath import orbit_path
    from gsrt_torch.scene.catalog import demo_gauss_splat, random_cloud
    from gsrt_torch.serving import ServingRenderer
    from gsrt_torch.utils.image import save_png

    dev = resolve_device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       conic_mode="standard", use_exp_lut=args.exp_lut)
    if args.ply:
        from gsrt_torch.scene.ply import load_gaussian_ply
        cloud = load_gaussian_ply(args.ply, device=dev)
        center, spread = _cloud_extent(cloud)
        radius = args.radius or spread * 1.5 + 1
    else:
        if args.scene.startswith("random"):
            n = int(args.scene[len("random"):] or "100000")
            # bench.py's headline scene parameters (~4-8 px footprints) so
            # orbit throughput is comparable with the bench
            cloud, cam0 = random_cloud(n, width=args.width,
                                       height=args.height,
                                       scale_range=(0.004, 0.03),
                                       device=dev)
        else:
            cloud, cam0 = demo_gauss_splat(args.width, args.height,
                                           device=dev)
        center, _ = _cloud_extent(cloud)
        radius = args.radius or float(np.linalg.norm(
            as_numpy(cam0.position) - center))

    if args.frames < 1:
        print("--frames must be >= 1", file=sys.stderr)
        return 2
    cams = orbit_path(center, radius, args.frames, height=args.elev,
                      fov_y_deg=args.fov, width=args.width,
                      height_px=args.height, degrees=args.degrees,
                      device=dev)

    if args.no_serving:
        rt = GaussianRayTracer(cfg, mode="tiled", device=dev,
                               defer_overflow=4)
        render = lambda cam: rt(cloud, cam)  # noqa: E731
        stats = None
    else:
        srv = ServingRenderer(cfg, margin=args.margin, strict=args.strict,
                              device=dev)
        render = lambda cam: srv(cloud, cam)  # noqa: E731
        stats = srv.stats

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    def retire(j, out, done):
        # waits for frame j: its PNG read, or its end-of-frame event
        if args.out_dir:
            save_png(os.path.join(args.out_dir, f"frame_{j:04d}.png"),
                     out.color)
        elif done is not None:
            done.synchronize()

    frame_ms = []
    inflight: list = []   # (index, out, event): wait `depth` frames behind
    depth = 4             # so the host queues while the card renders
    t0 = time.perf_counter()
    for i, cam in enumerate(cams):
        t1 = time.perf_counter()
        out = render(cam)
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        inflight.append((i, out, done))
        if len(inflight) >= depth:
            retire(*inflight.pop(0))
        frame_ms.append((time.perf_counter() - t1) * 1e3)
    for item in inflight:
        retire(*item)
    if stats is not None:
        srv.finish()
    _sync(dev)
    wall = time.perf_counter() - t0
    rays = args.width * args.height * len(cams)
    # early frames carry the warm-up (libraries, calibration, serving's
    # re-bucketing); steady state = the last half of the path
    tail = frame_ms[len(frame_ms) // 2:] or frame_ms
    rec = dict(frames=len(cams), wall_s=round(wall, 3),
               ms_per_frame=round(wall / len(cams) * 1e3, 2),
               steady_ms=round(sum(tail) / len(tail), 2),
               mrays_per_s=round(rays / wall / 1e6, 2),
               steady_mrays_per_s=round(
                   args.width * args.height / (sum(tail) / len(tail)) / 1e3,
                   2),
               serving=not args.no_serving)
    if stats:
        rec["violations"] = sum(f["violations"] for f in stats)
        rec["full_renders"] = sum(f["full_renders"] for f in stats)
        rec["pairs_first"] = stats[0]["pairs"]
        rec["pairs_last"] = stats[-1]["pairs"]
    print(json.dumps(rec))
    if args.stats_out and stats:
        with open(args.stats_out, "w") as f:
            json.dump(stats, f)
    return 0


def viewer_from_args(args):
    """The ViewerServer `view` serves for these arguments (not started)."""
    from gsrt_torch.core.config import RenderConfig
    from gsrt_torch.core.types import look_at, make_camera
    from gsrt_torch.viewer.server import ViewerServer

    dev = resolve_device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       conic_mode="standard", use_exp_lut=args.exp_lut)
    if args.ply:
        from gsrt_torch.scene.ply import load_gaussian_ply
        cloud = load_gaussian_ply(args.ply, device=dev)
        center, spread = _cloud_extent(cloud)
        eye = center + np.array([0.0, 0.0, -(spread * 1.5 + 1)])
        cam0 = make_camera(look_at(eye, center), args.fov, args.width,
                           args.height, device=dev)
    elif args.scene.startswith("random"):
        from gsrt_torch.scene.catalog import random_cloud
        n = int(args.scene[len("random"):] or "100000")
        cloud, cam0 = random_cloud(n, width=args.width, height=args.height,
                                   scale_range=(0.004, 0.03), device=dev)
    else:
        from gsrt_torch.scene.catalog import demo_gauss_splat
        cloud, cam0 = demo_gauss_splat(args.width, args.height, device=dev)
    return ViewerServer(cloud, cfg, cam0, renderer=args.renderer,
                        fov_y_deg=args.fov, host=args.host, port=args.port,
                        max_fps=args.max_fps, device=dev)


def cmd_view(args) -> int:
    """Interactive browser viewer (ModelViewController + UserInterface
    rebuilt headless — gsrt_torch.viewer): WASD fly, mouse look, live
    fps / Mrays/s overlay, heatmap toggle, served over HTTP."""
    srv = viewer_from_args(args)
    print(f"gsrt_torch viewer: http://{args.host}:{srv.port}/  "
          f"({srv.cloud.n} splats, {args.width}x{args.height}, "
          f"renderer={args.renderer}, {srv.device})")
    srv.serve_forever()
    return 0


def cmd_compare(args) -> int:
    """PSNR/SSIM between two images (the north-star parity check)."""
    from gsrt_torch.utils.image import load_png, psnr, ssim
    a = load_png(args.a)
    b = load_png(args.b)
    if a.shape != b.shape:
        print(f"shape mismatch {a.shape} vs {b.shape}", file=sys.stderr)
        return 2
    p_db = psnr(a, b)
    print(json.dumps({"psnr_db": round(min(p_db, 999.0), 3),  # cap inf
                      "ssim": round(ssim(a, b), 4)}))
    return 0


def _save_ply(path: str, params) -> None:
    from gsrt_torch.scene.ply import save_gaussian_ply
    save_gaussian_ply(path, params.means, params.quats,
                      torch.exp(params.log_scales),
                      torch.sigmoid(params.opacity_logit), params.sh)
    print(f"wrote {path}")


def cmd_train(args) -> int:
    """Fit a Gaussian cloud to a target image (single-camera demo of the
    differentiable renderer, on `render_fast`); saves an INRIA .ply."""
    from gsrt_torch.core.config import RenderConfig
    from gsrt_torch.models.gaussian_rt import render_fast
    from gsrt_torch.models.trainer import (make_optimizer, random_init,
                                           train_step)
    from gsrt_torch.scene.catalog import demo_gauss_splat
    from gsrt_torch.utils.image import load_png, save_png

    dev = resolve_device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       conic_mode="standard")
    if args.target:
        from gsrt_torch.core.types import look_at, make_camera
        target = torch.as_tensor(load_png(args.target), device=dev)
        camera = make_camera(look_at((0, 0, 0), (0, 0, 1)), 60.0,
                             args.width, args.height, device=dev)
    else:  # self-supervised demo: fit the 2-gaussian reference scene
        cloud, camera = demo_gauss_splat(args.width, args.height,
                                         device=dev)
        with torch.no_grad():
            target = render_fast(cloud, camera, cfg).color

    # drawn on the CPU, so every device starts from the same cloud
    params = random_init(torch.Generator().manual_seed(0), args.n_gaussians,
                         extent=2.0, z_offset=4.0, sh_degree=0, device=dev)
    optimizer = make_optimizer(params, lr_means=2e-3, lr_scales=5e-3,
                               lr_opacity=5e-2, lr_sh=1e-2)
    log_every = max(1, args.iters // 10)
    if args.densify_every:
        from gsrt_torch.models.densify import (densify_and_prune,
                                               init_stats,
                                               make_train_step_adaptive)
        stats = init_stats(params.means.shape[0], dev)
        astep = make_train_step_adaptive(cfg, lambda_ssim=args.lambda_ssim)
        for it in range(args.iters):
            stats, loss = astep(params, optimizer, stats, target, camera)
            if (it + 1) % args.densify_every == 0 and \
                    it < args.iters * 3 // 4:
                params, optimizer, stats, rep = densify_and_prune(
                    params, optimizer, stats,
                    grad_threshold=args.densify_grad,
                    scale_threshold=args.densify_scale,
                    max_splats=args.max_gaussians,
                    bucket=max(64, args.n_gaussians), seed=it)
                print(f"iter {it:5d}  densify: {rep.n_before} -> "
                      f"{rep.n_after} live (+{rep.n_cloned} cloned, "
                      f"{rep.n_split} split, -{rep.n_pruned} pruned)")
            if it % log_every == 0:
                print(f"iter {it:5d}  loss {float(loss):.5f}")
    else:
        for it in range(args.iters):
            loss = train_step(params, optimizer, target, camera, cfg,
                              lambda_ssim=args.lambda_ssim)
            if it % log_every == 0:
                print(f"iter {it:5d}  loss {float(loss):.5f}")
    if args.out:
        with torch.no_grad():
            save_png(args.out,
                     render_fast(params.to_cloud(), camera, cfg).color)
        print(f"wrote {args.out}")
    if args.save_ply:
        _save_ply(args.save_ply, params)
    return 0


def cmd_fit(args) -> int:
    """Fit a Gaussian cloud to a posed COLMAP capture (the INRIA
    multi-view pipeline: SfM-point init, adaptive densification, holdout
    PSNR) on the tiled path's kernels. The pair buffer starts at the
    initial cloud's worst view with 10% slack, counted on the device, and
    grows when a view needs more (`make_train_step_mv`; `fit_views` prints
    each growth)."""
    from gsrt_torch.core.config import RenderConfig
    from gsrt_torch.models.gaussian_rt import (count_pairs, pair_bucket,
                                               render_fast)
    from gsrt_torch.models.multiview import fit_views, viewset_from_colmap

    dev = resolve_device(args.device)
    images_dir = args.images or os.path.join(args.colmap, "images")
    vs, params, extent = viewset_from_colmap(
        args.colmap, images_dir, downscale=args.downscale,
        limit=args.limit or None, device=dev)
    print(f"loaded {vs.n_views} views @{vs.width}x{vs.height}, "
          f"{params.means.shape[0]} SfM points, extent {extent:.2f}")
    cfg = RenderConfig(width=vs.width, height=vs.height,
                       conic_mode="standard")
    with torch.no_grad():
        cloud = params.to_cloud()
        worst = int(torch.stack([count_pairs(cloud, vs.camera_at(i), cfg)
                                 for i in range(vs.n_views)]).max())
    params, rep = fit_views(
        vs, params, cfg, iters=args.iters, lambda_ssim=args.lambda_ssim,
        holdout=args.holdout, densify_every=args.densify_every,
        densify_grad=args.densify_grad, scene_scale=extent,
        opacity_reset_every=args.opacity_reset_every,
        max_splats=args.max_gaussians, seed=0,
        log_every=max(1, args.iters // 20),
        max_pairs=pair_bucket(int(worst * 1.1)))
    print(f"fit done: {rep.n_splats} splats, "
          f"train PSNR {rep.train_psnr:.2f} dB, "
          f"test PSNR {rep.test_psnr:.2f} dB")
    if args.out:
        from gsrt_torch.utils.image import save_png
        with torch.no_grad():
            save_png(args.out, render_fast(params.to_cloud(),
                                           vs.camera_at(0), cfg).color)
        print(f"wrote {args.out}")
    if args.save_ply:
        _save_ply(args.save_ply, params)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsrt_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="ray-traced 3DGS")
    _add_common(p)
    p.add_argument("--scene", type=str, default="3DGS")
    p.add_argument("--ply", type=str, default=None)
    p.add_argument("--camera", type=str, default=None,
                   help=".camera file (eye xyz, center xyz)")
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--mode",
                   choices=["tiled", "fast", "reference", "traced"],
                   default="tiled",
                   help="traced = one ray a pixel through a per-ray tree "
                        "over the splats, the k-buffer passes")
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--exp-lut", action="store_true")
    p.add_argument("--reference-conic", action="store_true")
    p.add_argument("--heatmap", type=str, default=None,
                   help="write per-pixel cost heatmap PNG (Heatmap.glsl "
                        "analogue)")
    p.add_argument("--expand-impl", choices=["pallas", "xla", "fused"],
                   default="pallas", help="pair-expansion implementation")
    p.add_argument("--payload", choices=["f32", "compact"], default="f32",
                   help="pair-payload tier (compact = fast, ~1e-3 error)")
    p.add_argument("--span-mode", choices=["rect", "ellipse"],
                   default="rect", help="footprint pair-generation rule")
    p.add_argument("--scan-impl", choices=["roll", "logmm"], default="roll",
                   help="blend-kernel transmittance scan")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("pt", help="path tracing workloads")
    _add_common(p)
    p.add_argument("--scene", type=str, default="rtiow")
    p.add_argument("--obj", type=str, default=None)
    p.add_argument("--shader-type",
                   choices=["path", "shadow", "ao", "foveated"],
                   default="path")
    p.add_argument("--shadowrays", type=int, default=2)
    p.add_argument("--aorays", type=int, default=4)
    p.add_argument("--primary", choices=["block", "binned"],
                   default="block",
                   help="primary-ray path (binned = screen-tile cast)")
    p.add_argument("--mips", action="store_true",
                   help="trilinear mip-mapped texture sampling "
                        "(ray-cone LOD; getTexture txl analogue)")
    p.set_defaults(fn=cmd_pt)

    p = sub.add_parser("bench", help="lumibench-style sweep")
    _add_common(p)
    p.add_argument("--primary", choices=["block", "binned"],
                   default="block",
                   help="primary-ray path: packed-cluster traversal or "
                        "screen-tile binned cast (no-cutout scenes only)")
    p.add_argument("--tri-max-pairs", type=int, default=1 << 20)
    p.add_argument("--tri-span", choices=["rect", "exact"], default="rect",
                   help="binned-cast pair generation (exact = scanline "
                        "clip; fewer pairs, identical image)")
    p.add_argument("--suite", choices=["synthetic", "lumibench"],
                   default="synthetic",
                   help="lumibench = reference Scenes/ datasets")
    p.add_argument("--scenes", type=str, default=None,
                   help="comma-separated scene-name filter")
    p.add_argument("--max-files", type=int, default=None,
                   help="cap OBJ count per directory scene")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("orbit", help="camera-path serving (orbit video)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--scene", type=str, default="random1000000")
    p.add_argument("--ply", type=str, default=None)
    p.add_argument("--frames", type=int, default=24,
                   help="number of path frames (>= 1)")
    p.add_argument("--degrees", type=float, default=90.0)
    p.add_argument("--radius", type=float, default=None)
    p.add_argument("--elev", type=float, default=0.0)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--margin", type=float, default=1.5)
    p.add_argument("--strict", action="store_true",
                   help="re-render frames the cull degraded")
    p.add_argument("--no-serving", action="store_true",
                   help="plain per-frame rendering (baseline)")
    p.add_argument("--exp-lut", action="store_true")
    p.add_argument("--out-dir", type=str, default=None)
    p.add_argument("--stats-out", type=str, default=None)
    _add_device(p)
    p.set_defaults(fn=cmd_orbit)

    p = sub.add_parser("view", help="interactive browser viewer")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--scene", type=str, default="random100000")
    p.add_argument("--ply", type=str, default=None)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--renderer",
                   choices=["serving", "tiled", "fast", "reference"],
                   default="serving")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-fps", type=float, default=30.0)
    p.add_argument("--exp-lut", action="store_true")
    _add_device(p)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("compare", help="PSNR/SSIM between two PNGs")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("train", help="fit gaussians to a target image")
    _add_common(p)
    p.add_argument("--target", type=str, default=None)
    p.add_argument("--n-gaussians", type=int, default=256)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--lambda-ssim", type=float, default=0.2)
    p.add_argument("--save-ply", type=str, default=None)
    p.add_argument("--densify-every", type=int, default=0,
                   help="run adaptive density control every N iters "
                        "(0 = fixed splat budget)")
    p.add_argument("--densify-grad", type=float, default=2e-4,
                   help="mean-gradient threshold for clone/split")
    p.add_argument("--densify-scale", type=float, default=0.05,
                   help="world-space scale split/clone boundary")
    p.add_argument("--max-gaussians", type=int, default=None,
                   help="hard cap on splat count during densification")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("fit", help="multi-view fit from a COLMAP capture")
    p.add_argument("--colmap", type=str, required=True,
                   help="scene root or sparse model dir (text or binary)")
    p.add_argument("--images", type=str, default=None,
                   help="image directory (default <colmap>/images)")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--limit", type=int, default=0,
                   help="use only the first N views (0 = all)")
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--lambda-ssim", type=float, default=0.2)
    p.add_argument("--holdout", type=int, default=8,
                   help="every Nth view is held out for test PSNR (0=off)")
    p.add_argument("--densify-every", type=int, default=100)
    p.add_argument("--densify-grad", type=float, default=2e-4)
    p.add_argument("--opacity-reset-every", type=int, default=0)
    p.add_argument("--max-gaussians", type=int, default=None)
    p.add_argument("--out", type=str, default=None,
                   help="render view 0 to PNG after the fit")
    p.add_argument("--save-ply", type=str, default=None)
    _add_device(p)
    p.set_defaults(fn=cmd_fit)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
