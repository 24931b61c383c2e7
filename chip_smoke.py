#!/usr/bin/env python3
"""Chip smoke test of the gsrt_torch port on one NVIDIA GPU.

    python3 chip_smoke.py            # the headline workload, one card

Phases, in order; any failure exits non-zero and prints no result line:

1. device  — needs CUDA; prints the card's name and power limit
             (nvidia-smi) and torch's view of it;
2. build   — compiles every kernel of the path from gsrt_torch/csrc with
             nvcc (one process per source, in parallel);
3. capture — renders the main path once with recording wrappers around the
             kernel entry points, to take each kernel's real inputs;
4. expand  — the pair-expansion kernel against its plain PyTorch version on
             those inputs, bit for bit, in both modes (level-1 units and
             level-2 payload emit);
5. blend   — the group-stream blend kernel against its plain version on the
             captured payload, every group, atol 2e-3 on color and trans;
6. main    — GaussianRayTracer(cfg, "tiled"): calibrate, then one frame,
             with every launch count set to 0 just before and read just
             after; each kernel of the path must have launched; then
             per-stage and whole-frame times from CUDA events;
7. check   — a small scene through render_tiled (kernels) and render_fast
             (plain PyTorch, the port's oracle), atol 2e-2.

The workload is the JAX package's benchmark: random_cloud(1M, seed=0,
scale_range=(0.004, 0.03)) at 1920x1080, SH degree 3, RenderConfig
defaults. Before the last line it prints one JSON object with a row per
kernel (launches, error against the plain version, times, roofline
bound); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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


class Recorder:
    """Wraps a module function, keeping the arguments of every call."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def wrapped(*args, **kw):
            self.calls.append((args, kw))
            return self.orig(*args, **kw)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("phase device: no CUDA device")
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
               bytes_moved):
    import torch
    out_k = kernel_fn()
    out_p = plain_fn()
    torch.cuda.synchronize()
    if out_k.shape != out_p.shape or not torch.equal(out_k, out_p):
        bad = (out_k != out_p).sum().item() if out_k.shape == out_p.shape \
            else "shape"
        raise SystemExit(f"phase expand: {name} differs from its plain "
                         f"version ({bad} words)")
    row = dict(name=name, route="cuda", source=EXPAND_SRC, replaces=tpu,
               launches=launches, max_abs_err=0.0,
               ms=time_cuda(kernel_fn, 20), plain_ms=time_cuda(plain_fn, 5),
               bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes",
               library_ms=None if library_fn is None
               else time_cuda(library_fn, 5))
    log(f"phase expand: {name} bitwise equal, shape "
        f"{tuple(out_k.shape)}, {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms)")
    return row


def main() -> int:
    phase_device()
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
    cfg = RenderConfig(width=W, height=H, conic_mode="standard")
    t0 = time.perf_counter()
    cloud, camera = random_cloud(SPLATS, seed=SEED, width=W,
                                 height=H, scale_range=(0.004, 0.03),
                                 device=DEVICE)
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

    # --- blend parity on the captured payload, every group ---
    stats = {}
    plain_kw = {k: blend_kw[k] for k in (
        "width", "height", "sub_w", "sub_h", "bs", "g_cutoff",
        "alpha_threshold", "alpha_clamp", "skip_range_check")}
    t0 = time.perf_counter()
    color_p, trans_p = splat_packed.blend_packed_plain(binning, stats=stats,
                                                       **plain_kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    color_k, trans_k = splat_packed.blend_packed(binning, **blend_kw)
    torch.cuda.synchronize()
    err = max((color_k - color_p).abs().max().item(),
              (trans_k - trans_p).abs().max().item())
    ntx, nty = tile_binning.tile_extent(W, H, cfg.tile_w, cfg.tile_h)
    log(f"phase blend: all {ntx * nty} tiles, max |kernel - plain| "
        f"{err:.3e} (atol 2e-3), "
        f"{stats['pairs_blended']} pairs blended of {total}")
    if not err <= 2e-3:
        raise SystemExit(f"phase blend: kernel differs from plain by {err}")
    npx = cfg.tile_w * cfg.tile_h
    blend_ops = BLEND_FLOPS_PER_PAIR_PIXEL * npx * stats["pairs_blended"]
    blend_bytes = 4 * (tile_binning.COMPACT_WIDTH * total
                       + binning.tile_start.numel()) + 16 * W * H
    t_ops, t_bytes = blend_ops / F32_FLOPS, blend_bytes / HBM_BYTES_PER_S
    rows.append(dict(
        name="blend_packed_group", route="cuda", source=BLEND_SRC,
        replaces=BLEND_TPU, launches=0, max_abs_err=err,
        ms=time_cuda(lambda: splat_packed.blend_packed(binning, **blend_kw),
                     10),
        plain_ms=plain_s * 1e3, bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None))
    log(f"phase blend: kernel {rows[-1]['ms']:.4f} ms, plain "
        f"{rows[-1]['plain_ms']:.1f} ms, bound {rows[-1]['bound_ms']:.4f} ms"
        f" ({rows[-1]['bound_by']})")
    del color_p, trans_p, color_k, trans_k

    # --- main path: counts to 0, calibrate + one frame, counts read ---
    main_tracer = grt.GaussianRayTracer(cfg, "tiled", device=DEVICE)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    main_tracer.calibrate(cloud, camera)
    out = main_tracer(cloud, camera)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    log(f"phase main: launches {counts}")
    for k, v in counts.items():
        if v <= 0:
            raise SystemExit(f"phase main: kernel {k} never launched")
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
        depth, mean2d, quad, in_front, colors = grt._precompute(
            cloud, camera, cfg)
        rx, ry = grt.screen_extents_abc(
            quad[:, 0], quad[:, 1], quad[:, 2], cfg.conic_mode,
            cfg.g_cutoff, opacity=cloud.opacity,
            alpha_threshold=cfg.alpha_threshold)
        alive = (in_front & (cloud.opacity > cfg.alpha_threshold)
                 & (depth > cfg.t_min)
                 & (depth < min(cfg.t_max, cfg.init_depth)))
        state["cols"] = (depth, mean2d[:, 0], mean2d[:, 1], quad[:, 0],
                         quad[:, 1], quad[:, 2], cloud.opacity, colors[:, 0],
                         colors[:, 1], colors[:, 2], rx, ry, alive)

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
    log("kernels: " + ", ".join(f"{r['name']} x{r['launches']}"
                                for r in rows))

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

    print(json.dumps({"kernels": rows, "frame_ms": frame_ms,
                      "mrays_per_s": mrays, "stages_ms": stages,
                      "splats_with_pairs": splats_live, "units": units,
                      "pairs": total, "max_pairs": mpairs,
                      "max_rows": mrows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
