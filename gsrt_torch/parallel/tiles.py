"""Sharded rendering over a mesh of devices (counterpart of
`gsrt.parallel.tiles`).

* **Image-slab data parallelism** (`render_data_parallel`): the image is
  cut into row slabs along the mesh's `tiles` axis and the cloud is
  replicated. Each slab renders with a camera whose principal point is
  shifted up by the slab's first row, so the slabs put together are the
  full frame.
* **Depth-slab splat sharding** (`render_splat_sharded`): a cloud sorted
  by camera depth (`shard_cloud_by_depth`) is cut into contiguous slabs
  along the `splats` axis; each shard blends its slab for its row slab
  and the shards' (transmittance, colour) are composited front to back:
      C = Σ_d C_d · Π_{d'<d} T_d'   ,   T = Π_d T_d
  either after gathering every slab ("gather") or by log2(D) pairwise
  exchanges ("butterfly").

The PyTorch idiom of the JAX package's `shard_map`: this process loops
over the shards it owns, each shard's inputs moved to its device; the
all_gather is a stack of the slabs on the row's first device, the
ppermute a pairwise exchange in the same XOR schedule. A device may
repeat in a mesh (`["cuda:0"] * 8` is one card as eight shards; the CPU
tests use `["cpu"] * 8`). The result is the full (trans [H, W], color
[H, W, 3]) on the mesh's first device; on a mesh that spans processes
(`gsrt_torch.parallel.multihost`) it is this process's row slabs
(`RowSlabs`).

With `tiled_render_fn` the shards run the tiled path's kernels
(`render_tiled`); a shard whose view outgrows the pair buffer raises
where the JAX package renders its truncated stream.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import Camera, GaussianCloud


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """A [n_tiles, n_splats] grid of devices, the splat axis innermost.
    `ranks` names the process that owns each shard (None: this process
    owns them all); `rank` is this process's."""

    devices: tuple[tuple[torch.device, ...], ...]
    ranks: Optional[tuple[tuple[int, ...], ...]] = None
    rank: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {"tiles": len(self.devices), "splats": len(self.devices[0])}

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and \
            len({r for row in self.ranks for r in row}) > 1

    def owns(self, i: int, j: int) -> bool:
        return self.ranks is None or self.ranks[i][j] == self.rank


class RowSlabs(NamedTuple):
    """This process's row slabs of a render on a mesh that spans
    processes: each slab's first image row, its trans [h, W] and its
    color [h, W, 3], on the device that rendered it."""
    y0: tuple[int, ...]
    trans: tuple[torch.Tensor, ...]
    color: tuple[torch.Tensor, ...]


def make_render_mesh(n_tiles: int, n_splats: int = 1,
                     devices=None) -> RenderMesh:
    """Mesh over ('tiles', 'splats'): image-slab data parallelism × depth-
    slab splat sharding. `devices` (names or torch.devices, repeats
    allowed) defaults to every visible CUDA device; the first
    n_tiles·n_splats are used, row by row."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_render_mesh takes the CUDA devices by default and no "
                "CUDA device is available; pass devices=['cpu'] * n")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = n_tiles * n_splats
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devs = [torch.device(d) for d in devices[:n]]
    return RenderMesh(tuple(tuple(devs[i * n_splats:(i + 1) * n_splats])
                            for i in range(n_tiles)))


def _slab_camera(camera: Camera, y0: int, slab_h: int) -> Camera:
    """Camera for image rows [y0, y0 + slab_h): the principal point
    shifted up by y0 (in f32), the width unchanged."""
    return dataclasses.replace(camera, cy=camera.cy - float(y0),
                               height=slab_h)


def tiled_render_fn(max_pairs: int, max_rows: int | None = None):
    """A render_fn for the sharded entry points that runs the tiled path
    (`render_tiled`: projection, binning and the blend kernels) on each
    shard. `max_pairs` / `max_rows` size every shard's buffers: bound
    them with `calibrate_sharded`. A slab's tile grid starts at its own
    first row, so where the slab height is no multiple of the tile height
    a tile stops at saturation at another pair than the full frame's, and
    a pair whose alpha at a pixel sits at the threshold (after the
    payload's rounding and the slab camera's) can be taken on one side
    only."""
    from gsrt_torch.models.gaussian_rt import render_tiled

    def fn(cloud, camera, cfg):
        return render_tiled(cloud, camera, cfg, max_pairs=max_pairs,
                            max_rows=max_rows)

    return fn


def _shard(cloud: GaussianCloud, j: int, n_splats: int) -> GaussianCloud:
    per = cloud.n // n_splats
    return GaussianCloud(*(x[j * per:(j + 1) * per] for x in cloud))


def calibrate_sharded(cloud: GaussianCloud, camera: Camera,
                      cfg: RenderConfig, n_tiles: int,
                      n_splats: int = 1) -> int:
    """Pair-buffer size for the sharded tiled path: the largest host-side
    pair count over every (row-slab camera × contiguous splat shard),
    bucketed with 10% slack as the single-device calibration does."""
    from gsrt_torch.models.gaussian_rt import count_pairs_numpy, pair_bucket

    slab_h = camera.height // n_tiles
    worst = 0
    for i in range(n_tiles):
        cam = _slab_camera(camera, i * slab_h, slab_h)
        for j in range(n_splats):
            worst = max(worst, count_pairs_numpy(
                _shard(cloud, j, n_splats), cam, cfg))
    return pair_bucket(int(worst * 1.1))


def _check_overflow(outs) -> None:
    if any(bool(o.overflow) for o in outs if o.overflow is not None):
        raise RuntimeError("a shard's view outgrew max_pairs: size the "
                           "buffers with calibrate_sharded")


def _assemble(mesh: RenderMesh, slabs: list):
    """[(y0, trans, color)] in row order → the full image on the mesh's
    first device, or RowSlabs on a mesh that spans processes."""
    if mesh.spans_processes:
        return RowSlabs(*(tuple(s) for s in zip(*slabs))) if slabs \
            else RowSlabs((), (), ())
    first = mesh.devices[0][0]
    return (torch.cat([t.to(first) for _, t, _ in slabs]),
            torch.cat([c.to(first) for _, _, c in slabs]))


def render_data_parallel(cloud: GaussianCloud, camera: Camera,
                         cfg: RenderConfig, mesh: RenderMesh,
                         render_fn=None):
    """Replicated cloud, row-slab-sharded image: one render_fn call per
    row slab on the row's first device (render_fast by default). Returns
    (trans [H, W], color [H, W, 3]), or RowSlabs on a mesh that spans
    processes."""
    from gsrt_torch.models.gaussian_rt import render_fast
    render_fn = render_fn or render_fast
    n_tiles = mesh.shape["tiles"]
    if camera.height % n_tiles:
        raise ValueError("the image height must divide the tile axis")
    slab_h = camera.height // n_tiles
    slab_cfg = cfg.replace(height=slab_h)
    slabs, outs = [], []
    for i in range(n_tiles):
        if not mesh.owns(i, 0):
            continue
        dev = mesh.devices[i][0]
        out = render_fn(cloud.to(dev),
                        _slab_camera(camera, i * slab_h, slab_h).to(dev),
                        slab_cfg)
        outs.append(out)
        slabs.append((i * slab_h, out.trans, out.color))
    _check_overflow(outs)
    return _assemble(mesh, slabs)


def shard_cloud_by_depth(cloud: GaussianCloud, camera: Camera,
                         n_shards: int) -> GaussianCloud:
    """Sort splats by camera depth (stably) and zero-pad N to a multiple
    of n_shards: shard i of the result owns depth slab i. A padding splat
    has opacity 0 and Σ = 0, so it bins no pair and blends nothing."""
    R = camera.view[:3, :3].to(cloud.device)
    t = camera.view[:3, 3].to(cloud.device)
    m = cloud.means
    # the z row of means @ R.T + t, elementwise (no TF32 matmul)
    depth = m[:, 0] * R[2, 0] + m[:, 1] * R[2, 1] + m[:, 2] * R[2, 2] + t[2]
    order = torch.argsort(depth, stable=True)
    pad = (-cloud.n) % n_shards

    def prep(x):
        x = x[order]
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad \
            else x
    return GaussianCloud(*(prep(x) for x in cloud))


def _composite_gather(slabs: list, dev):
    """Ordered composite of the gathered depth slabs [(trans, color)],
    nearest first: exclusive prefix products of the transmittances."""
    ts = torch.stack([t.to(dev) for t, _ in slabs])
    cs = torch.stack([c.to(dev) for _, c in slabs])
    excl = torch.cat([torch.ones_like(ts[:1]), torch.cumprod(ts, 0)[:-1]])
    return torch.prod(ts, 0), (cs * excl[..., None]).sum(0)


def _composite_butterfly(slabs: list):
    """Ordered depth composite in log2(D) pairwise exchanges. (C, T) ∘
    (C', T') = (C + T·C', T·T') with the nearer block on the left:
    recursive doubling with XOR partners keeps each shard's running value
    an aligned contiguous block of slabs. Every round reads the values of
    the round before it (ppermute is simultaneous). Returns shard 0's
    result, on its device."""
    vals = list(slabs)
    d = 1
    while d < len(vals):
        prev, vals = vals, []
        for j, (t, c) in enumerate(prev):
            pt, pc = (x.to(t.device) for x in prev[j ^ d])
            if j & d == 0:       # my block is nearer the camera
                c = c + t[..., None] * pc
            else:
                c = pc + pt[..., None] * c
            vals.append((t * pt, c))
        d *= 2
    return vals[0]


def render_splat_sharded(cloud: GaussianCloud, camera: Camera,
                         cfg: RenderConfig, mesh: RenderMesh,
                         render_fn=None, composite: str = "gather"):
    """Depth-slab splat sharding × row-slab image sharding.

    `cloud` must be depth-sorted with N divisible by the splat axis (use
    `shard_cloud_by_depth`). Every shard blends its depth slab without
    the background; the background enters once, with the composite's
    transmittance. composite: "gather" stacks every shard's slab on the
    row's first device; "butterfly" (a power-of-two splat axis) combines
    them through log2(D) exchanges. Returns (trans [H, W], color [H, W,
    3]) on the mesh's first device; the mesh must be this process's."""
    from gsrt_torch.models.gaussian_rt import render_fast
    render_fn = render_fn or render_fast
    n_tiles, n_sh = mesh.shape["tiles"], mesh.shape["splats"]
    if camera.height % n_tiles:
        raise ValueError("the image height must divide the tile axis")
    if cloud.n % n_sh:
        raise ValueError("the splat count must divide the splat axis "
                         "(shard_cloud_by_depth pads it)")
    if composite not in ("gather", "butterfly"):
        raise ValueError(f"unknown composite {composite!r}")
    if composite == "butterfly" and n_sh & (n_sh - 1):
        raise ValueError("the butterfly composite needs a power-of-two "
                         "splat axis")
    if mesh.spans_processes:
        raise ValueError("render_splat_sharded runs on a mesh of this "
                         "process's devices")
    slab_h = camera.height // n_tiles
    slab_cfg = cfg.replace(height=slab_h, white_background=False)
    slabs, outs = [], []
    for i in range(n_tiles):
        cam = _slab_camera(camera, i * slab_h, slab_h)
        parts = []
        for j in range(n_sh):
            dev = mesh.devices[i][j]
            out = render_fn(_shard(cloud, j, n_sh).to(dev), cam.to(dev),
                            slab_cfg)
            outs.append(out)
            parts.append((out.trans, out.color))
        trans, color = _composite_butterfly(parts) \
            if composite == "butterfly" \
            else _composite_gather(parts, mesh.devices[i][0])
        if cfg.white_background:
            color = color + trans[..., None]
        slabs.append((i * slab_h, trans, color))
    _check_overflow(outs)
    return _assemble(mesh, slabs)
