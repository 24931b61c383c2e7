"""Training steps: `train_step_tiled` one view a step, over `views`
orbit cameras in an order drawn from the seed, looped, against seeded
low-frequency targets. Set-up builds the parameters and the optimiser
once, drives them through the first `check_steps` steps of that order
with the window's own call, and hands the same objects to the window;
the reference follows those steps."""

from __future__ import annotations

import sys
import time

import torch

from benchmark import compare, counts, port, roofline, scene
from benchmark.frames import seeded_order
from benchmark.reference import train as ref

BETA1 = 0.9
# make_optimizer's keyword for each leaf's learning rate
LR_KEY = dict(means="lr_means", log_scales="lr_scales", quats="lr_quats",
              opacity_logit="lr_opacity", sh="lr_sh")


class Loop:
    SPANS = (("gsrt_torch.ops.splat_grad:blend_backward", "blend_bwd"),)

    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.W, self.H = config["width"], config["height"]
        self.tr = config["train"]
        self.trace_items = 0    # steps of the window the trace sees
        self.traced = 0
        self.marks: list = []   # (set-up phase, host clock at its end)

    def mark(self, label: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.marks.append((label, time.perf_counter()))

    def make_inputs(self) -> None:
        """The parameters, views, order and targets, from the seed."""
        c, a = self.config, self.config["assumed"]
        cl = scene.random_cloud(
            c["splats"], self.seed, self.device, extent=a["extent"],
            scale_range=a["scale_range"], opacity_range=a["opacity_range"],
            sh_degree=c["sh_degree"], scene_seed=a["scene_seed"])
        self.params0 = dict(
            means=cl.means, log_scales=torch.log(cl.scales), quats=cl.quats,
            opacity_logit=torch.log(cl.opacity / (1 - cl.opacity)),
            sh=cl.sh)
        n = int(self.mix["views"])
        self.views = scene.orbit_from_mix(
            self.mix["orbit"], [360.0 * i / n for i in range(n)], self.W,
            self.H)
        self.order = seeded_order(n, self.seed)
        self.targets = scene.lowfreq_targets(
            n, self.W, self.H, self.mix["target_grid"], self.seed,
            self.device)
        self.cloud = cl

    def setup(self) -> None:
        from gsrt_torch.models import trainer
        self.mark("imports")
        self.make_inputs()
        self.mark("inputs")
        cl, c = self.cloud, self.config
        self.cams = [port.camera(v, self.device) for v in self.views]
        cov = scene.cov3d(cl.quats, cl.scales)
        need = max(counts.rect_pairs(cl, cov, v) for v in self.views)
        self.max_pairs = counts.pair_bucket(int(need * self.mix["slack"]))
        self.mark(f"count (max_pairs {self.max_pairs})")
        self.cfg = port.render_config(c)
        self.gp = trainer.GaussianParams(**self.params0, device=self.device)
        self.opt = trainer.make_optimizer(self.gp, **self.tr["lr"])
        self._step_fn = trainer.train_step_tiled
        self.i = 0
        k = int(self.mix["check_steps"])
        self.check_losses = []
        for s in range(k):
            self.check_losses.append(float(self._run()))
            self.mark(f"check step {s + 1}")
            if s == 0:
                # the first gradient as Adam holds it: m1 = (1 − β1)·g
                # (no state: the step recorded no gradient)
                self.grad1 = {}
                for name in ref.LEAVES:
                    leaf = getattr(self.gp, name)
                    m1 = self.opt.state.get(leaf, {}).get("exp_avg")
                    self.grad1[name] = torch.zeros_like(leaf) if m1 is None \
                        else m1.detach() / (1 - BETA1)
        self.params_k = {name: getattr(self.gp, name).detach().clone()
                         for name in ref.LEAVES}
        # buffers for the traced steps' parameters, which their work
        # counts need (the SH leaf is not: the count reads no colour)
        self.snaps = [{k: torch.empty_like(getattr(self.gp, k))
                       for k in ref.SHAPE_LEAVES}
                      for _ in range(self.trace_items)]

    def object_spans(self):
        return ((self.opt, "step", "optim"),)

    def _run(self):
        vi = int(self.order[self.i % len(self.order)])
        self.i += 1
        self.last_view = vi
        return self._step_fn(self.gp, self.opt, self.targets[vi],
                             self.cams[vi], self.cfg, self.max_pairs,
                             lambda_ssim=self.tr["lambda_ssim"])

    def step(self) -> dict:
        vi = int(self.order[self.i % len(self.order)])
        rec = {"view": self.views[vi], "view_index": vi,
               "pixels": self.W * self.H}
        if self.traced < self.trace_items:
            snap = self.snaps[self.traced]
            for k, buf in snap.items():
                buf.copy_(getattr(self.gp, k).detach())
            rec["params"] = snap
            self.traced += 1
        self._run()
        return rec

    def keep(self, index: int, rec: dict) -> None:
        pass

    def release(self) -> None:
        self.gp = self.opt = self.cloud = None

    def check(self, limits: dict) -> dict:
        self.release()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        f32 = self.reference()
        print(f"leaves left out of the gradient and change: "
              f"{compare.left_out(f32[1])}", file=sys.stderr)
        return compare.with_limits(compare.train_numbers(
            (self.check_losses, self.grad1, self.params_k), f32,
            self.params0), limits)

    def reference(self, **kw):
        """The reference's first check_steps steps: (losses, first
        gradients, parameters after them)."""
        k = int(self.mix["check_steps"])
        vs = [int(self.order[i]) for i in range(k)]
        lrs = self.tr["lr"]
        return ref.train(
            self.params0, [self.views[v] for v in vs],
            [self.targets[v] for v in vs],
            {name: lrs[LR_KEY[name]] for name in ref.LEAVES},
            self.tr["lambda_ssim"], k, **kw)

    def least_seconds(self, items) -> float:
        """Least seconds of the backward blend over the traced steps."""
        total = 0.0
        for rec in items:
            if rec.get("latency_s") is None or "params" not in rec:
                continue
            c = ref.counts(rec["params"], rec["view"])
            total += roofline.blend_backward(c, self.W * self.H)
        return total
