"""The path tracer's shading of one bounce wave: per ray the miss colour,
the hit point, the scatter of the hit's material (Lambertian, metal,
glass, isotropic) or its light, the emitted light, the throughput, and
the next origin, direction and liveness.

`shade_wave` launches one CUDA kernel (`csrc/pt_shade.cu`) on CUDA
tensors, after drawing the wave's unit vectors and uniforms from the
path tracer's generator through `models.path_tracer._random_unit` and
`_uniform`, in that order and in `_scatter`'s shapes. On CPU tensors it
runs `models.path_tracer._shade_plain`, the same composition as plain
PyTorch ops, which draws the same numbers through `_scatter`. The kernel
is bit-equal to the plain version on the card.
"""

from __future__ import annotations

import torch

from gsrt_torch import _kernels
from gsrt_torch.core.types import Materials


def _check(name: str, a: torch.Tensor, dtype, shape, dev) -> None:
    if a.device != dev:
        raise ValueError(f"shade_wave: {name} is on {a.device}, the wave on "
                         f"{dev}")
    if a.dtype != dtype:
        raise ValueError(f"shade_wave: {name} must be {dtype}, got {a.dtype}")
    if tuple(a.shape) != shape:
        raise ValueError(f"shade_wave: {name} must have shape {shape}, got "
                         f"{tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"shade_wave: {name} must have contiguous rows")


def _same_device(a: torch.device, b: torch.device) -> bool:
    # a generator made for "cuda" may name no index
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def shade_wave(gen: torch.Generator, mats: Materials, t, n, mat, hit, orig,
               dirn, active, ray_color, out_color, tex_color=None,
               has_sky: bool = False):
    """Shades one wave of R rays hit at t [R] float32 with normals n [R, 3]
    and material ids mat [R] int32 (hit [R] bool): adds the sky (has_sky)
    of the rays that missed and the light of those that hit a light to
    out_color, multiplies the throughput ray_color by the scatter's
    attenuation (the material's diffuse times tex_color [R, 3] where given),
    moves orig and dirn [R, 3] to the hit point and the scattered direction,
    and keeps active [R] bool for the rays that scattered.

    Writes orig, dirn, ray_color, out_color and active in place (every
    [R, 3] and [R] tensor float32 or bool with contiguous rows, on one
    device) and returns them in that order. CUDA tensors take the kernel,
    CPU tensors the plain version; any other device raises."""
    dev = orig.device
    R = orig.shape[0] if orig.dim() == 2 else -1
    for name, a, dtype, shape in (
            ("t", t, torch.float32, (R,)),
            ("n", n, torch.float32, (R, 3)),
            ("mat", mat, torch.int32, (R,)),
            ("hit", hit, torch.bool, (R,)),
            ("orig", orig, torch.float32, (R, 3)),
            ("dirn", dirn, torch.float32, (R, 3)),
            ("active", active, torch.bool, (R,)),
            ("ray_color", ray_color, torch.float32, (R, 3)),
            ("out_color", out_color, torch.float32, (R, 3))) + (
            () if tex_color is None else
            (("tex_color", tex_color, torch.float32, (R, 3)),)):
        _check(name, a, dtype, shape, dev)
    M = mats.model.shape[0]
    if M < 1 or mats.model.dtype not in (torch.int32, torch.int64):
        raise ValueError("shade_wave: the material table needs rows and an "
                         "integer model column")
    for name, a, shape in (("diffuse", mats.diffuse, (M, 3)),
                           ("fuzziness", mats.fuzziness, (M,)),
                           ("refraction_index", mats.refraction_index,
                            (M,))):
        _check(f"materials.{name}", a, torch.float32, shape, dev)
    if mats.model.device != dev or not _same_device(gen.device, dev):
        raise ValueError(f"shade_wave: the materials' model is on "
                         f"{mats.model.device} and the generator on "
                         f"{gen.device}, the wave on {dev}")
    outs = (orig, dirn, ray_color, out_color, active)
    from gsrt_torch.models import path_tracer as pt
    if dev.type == "cpu":
        for dst, src in zip(outs, pt._shade_plain(
                gen, mats, t, n, mat, hit, orig, dirn, active, ray_color,
                out_color, tex_color, has_sky)):
            dst.copy_(src)
        return outs
    if dev.type != "cuda":
        raise ValueError(f"shade_wave runs on CPU or CUDA tensors, not {dev}")
    unit = pt._random_unit(gen, (R, 3)).contiguous()
    uni = pt._uniform(gen, (R,)).contiguous()
    _launch(mats, t, n, mat, hit, orig, dirn, active, ray_color, out_color,
            unit, uni, tex_color, has_sky)
    return outs


def _launch(mats: Materials, t, n, mat, hit, orig, dirn, active, ray_color,
            out_color, unit, uni, tex_color, has_sky: bool) -> None:
    """One launch of the kernel on a wave `shade_wave` has checked, with
    its draws unit [R, 3] and uni [R] (float32, contiguous)."""
    model = mats.model.to(torch.int32).contiguous()
    with torch.cuda.device(orig.device):
        _kernels.PT_SHADE(
            t.data_ptr(), n.data_ptr(), mat.data_ptr(), hit.data_ptr(),
            orig.data_ptr(), dirn.data_ptr(), active.data_ptr(),
            ray_color.data_ptr(), out_color.data_ptr(), unit.data_ptr(),
            uni.data_ptr(),
            None if tex_color is None else tex_color.data_ptr(),
            model.data_ptr(), mats.diffuse.data_ptr(),
            mats.fuzziness.data_ptr(), mats.refraction_index.data_ptr(),
            orig.shape[0], model.shape[0], int(bool(has_sky)),
            _kernels.stream_ptr(orig))
