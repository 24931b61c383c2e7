"""Wavefront OBJ + MTL loading (counterpart of `gsrt.scene.obj`).

v / vt / f with fan triangulation, mtllib / usemtl with Kd, Ke, Ns, Ni and
illum mapped onto the path tracer's four material models, and map_Kd
textures and map_d cutout masks, decoded with PIL where it is installed
(without it a material loads untextured) and resampled into a
[NT, TEX_RES, TEX_RES] atlas. `load_obj_dir` merges a directory's OBJs
into one scene with per-file material overrides. Parsing is host Python;
the scene goes to CUDA unless device="cpu".
"""

from __future__ import annotations

import fnmatch
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gsrt_torch.core.types import Materials, resolve_device
from gsrt_torch.models.path_tracer import PrimitiveScene

TEX_RES = 256

_DEFAULT_MTL = {"kd": (0.7, 0.7, 0.7), "ke": (0, 0, 0), "ns": 0.0,
                "ni": 1.0, "illum": 2, "map_kd": None, "map_d": None}


def _parse_mtl(path: str) -> Dict[str, dict]:
    mats: Dict[str, dict] = {}
    cur: Optional[dict] = None
    if not os.path.exists(path):
        return mats
    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "newmtl":
                cur = mats.setdefault(tok[1], dict(_DEFAULT_MTL))
            elif cur is None:
                continue
            elif tok[0] == "Kd":
                cur["kd"] = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "Ke":
                cur["ke"] = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "Ns":
                cur["ns"] = float(tok[1])
            elif tok[0] == "Ni":
                cur["ni"] = float(tok[1])
            elif tok[0] == "illum":
                cur["illum"] = int(tok[1])
            elif tok[0] == "map_Kd":
                cur["map_kd"] = os.path.join(base, " ".join(tok[1:]))
            elif tok[0] == "map_d":
                cur["map_d"] = os.path.join(base, " ".join(tok[1:]))
    return mats


def _material_model(m: dict):
    """(model, diffuse, fuzz, refraction index) of an MTL entry: emissive →
    light, illum ≥ 7 or refractive → glass, shiny → metal, else
    Lambertian."""
    if any(c > 0 for c in m["ke"]):
        return Materials.DIFFUSE_LIGHT, m["ke"], 0.0, 1.0
    if m["illum"] >= 7 or (m["ni"] > 1.01 and m["illum"] >= 4):
        return Materials.DIELECTRIC, (1, 1, 1), 0.0, m["ni"]
    if m["illum"] >= 3 and m["ns"] > 200:
        fuzz = max(0.0, 1.0 - min(m["ns"], 1000.0) / 1000.0)
        return Materials.METALLIC, m["kd"], fuzz, 1.0
    return Materials.LAMBERTIAN, m["kd"], 0.0, 1.0


class _TextureAtlas:
    """Textures of one size, each (map_Kd, map_d) pair once."""

    def __init__(self):
        self.ids: Dict[str, int] = {}
        self.rgb: List[np.ndarray] = []
        self.alpha: List[np.ndarray] = []

    def add(self, rgb_path: Optional[str], alpha_path: Optional[str]) -> int:
        if rgb_path is None and alpha_path is None:
            return -1
        key = f"{rgb_path}|{alpha_path}"
        if key in self.ids:
            return self.ids[key]
        rgb = _load_image(rgb_path)
        alpha = _load_image(alpha_path, gray=True) \
            if alpha_path is not None else None
        if rgb is None and alpha is None:
            return -1
        if rgb is None:
            rgb = np.ones((TEX_RES, TEX_RES, 3), np.float32)
        if alpha is None:
            alpha = np.ones((TEX_RES, TEX_RES), np.float32)
        self.ids[key] = len(self.rgb)
        self.rgb.append(rgb)
        self.alpha.append(alpha)
        return self.ids[key]

    def arrays(self, device):
        """(textures, cutout masks or None), or (None, None)."""
        if not self.rgb:
            return None, None
        has_alpha = any((a < 1.0).any() for a in self.alpha)
        return (torch.as_tensor(np.stack(self.rgb), device=device),
                torch.as_tensor(np.stack(self.alpha), device=device)
                if has_alpha else None)


def _load_image(path: Optional[str], gray: bool = False):
    """[TEX_RES, TEX_RES(, 3)] f32 in [0, 1], rows bottom-up as OBJ's v
    runs; a grey mask reads the image's alpha channel where it has one.
    None where the file is missing, PIL is absent or decoding fails."""
    if path is None or not os.path.exists(path):
        return None
    try:
        from PIL import Image
        img = Image.open(path)
        if gray:
            img = img.convert("RGBA").getchannel("A") \
                if "A" in img.getbands() else img.convert("L")
        else:
            img = img.convert("RGB")
        img = img.resize((TEX_RES, TEX_RES))
        return (np.asarray(img, np.float32) / 255.0)[::-1]
    except Exception:
        return None


def _parse_obj(path: str, atlas: _TextureAtlas, mat_rows: List[tuple],
               tex_ids: List[int], mat_override: Optional[tuple] = None):
    """One OBJ → (verts, uvs, tris [(i0, i1, i2, t0, t1, t2, mat)]), its
    materials interned into the shared tables. uvs[0] is a (0, 0)
    stand-in for corners without a texcoord."""
    verts: List[tuple] = []
    uvs: List[tuple] = [(0.0, 0.0)]
    tris: List[tuple] = []
    mtl: Dict[str, dict] = {}
    local_ids: Dict[str, int] = {}

    def intern(name: str) -> int:
        if name not in local_ids:
            if mat_override is not None:
                model, kd, fuzz, ni = mat_override
                tid = -1
            else:
                m = mtl.get(name, _DEFAULT_MTL)
                model, kd, fuzz, ni = _material_model(m)
                tid = atlas.add(m.get("map_kd"), m.get("map_d"))
            local_ids[name] = len(mat_rows)
            mat_rows.append((model, kd, fuzz, ni))
            tex_ids.append(tid)
        return local_ids[name]

    cur_mat = intern("__default__")
    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append(tuple(float(x) for x in tok[1:4]))
            elif tok[0] == "vt":
                uvs.append((float(tok[1]),
                            float(tok[2]) if len(tok) > 2 else 0.0))
            elif tok[0] == "mtllib":
                mtl.update(_parse_mtl(os.path.join(base, " ".join(tok[1:]))))
            elif tok[0] == "usemtl":
                # a bare `usemtl` (no name) selects the default material
                cur_mat = intern(tok[1] if len(tok) > 1 else "__default__")
            elif tok[0] == "f":
                vi, ti = [], []
                for t in tok[1:]:
                    parts = t.split("/")
                    i = int(parts[0])
                    vi.append(i - 1 if i > 0 else len(verts) + i)
                    if len(parts) > 1 and parts[1]:
                        j = int(parts[1])
                        ti.append(j if j > 0 else len(uvs) + j)
                    else:
                        ti.append(0)
                for k in range(1, len(vi) - 1):     # fan triangulation
                    tris.append((vi[0], vi[k], vi[k + 1],
                                 ti[0], ti[k], ti[k + 1], cur_mat))
    return verts, uvs, tris


def _assemble(all_parts, mat_rows, tex_ids, atlas, transform, device):
    dev = resolve_device(device)
    v_list, uv_list, t_list = [], [], []
    v_off = uv_off = 0
    # every part's uv list holds its (0, 0) stand-in: real texcoords are
    # a list longer than 1
    any_real_uv = any(len(uvs) > 1 for _, uvs, _ in all_parts)
    for verts, uvs, tris in all_parts:
        v_list.append(np.asarray(verts, np.float32).reshape(-1, 3))
        uv_list.append(np.asarray(uvs, np.float32).reshape(-1, 2))
        t = np.asarray(tris, np.int64).reshape(-1, 7)
        t[:, :3] += v_off
        t[:, 3:6] += uv_off
        t_list.append(t)
        v_off += len(verts)
        uv_off += len(uvs)
    v = np.concatenate(v_list) if v_list else np.zeros((0, 3), np.float32)
    uv = np.concatenate(uv_list) if uv_list else np.zeros((1, 2), np.float32)
    t = np.concatenate(t_list) if t_list else np.zeros((0, 7), np.int64)
    if transform is not None:
        v = v @ np.asarray(transform[:3, :3], np.float32).T + \
            np.asarray(transform[:3, 3], np.float32)

    def dev_t(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    textures, alpha_tex = atlas.arrays(dev)
    textured = any(i >= 0 for i in tex_ids) and textures is not None
    mats = Materials(
        model=dev_t([m[0] for m in mat_rows], np.int32),
        diffuse=dev_t([m[1] for m in mat_rows]).reshape(-1, 3),
        fuzziness=dev_t([m[2] for m in mat_rows]),
        refraction_index=dev_t([m[3] for m in mat_rows]),
        texture_id=dev_t(tex_ids, np.int32) if textured else None)
    empty3 = torch.zeros((0, 3), device=dev)
    empty1 = torch.zeros((0,), device=dev)
    empty_i = torch.zeros((0,), dtype=torch.int32, device=dev)
    has_uv = any_real_uv and len(t) > 0
    uvs3 = [dev_t(uv[t[:, 3 + i]]) for i in range(3)] if has_uv \
        else [None] * 3
    return PrimitiveScene(
        sph_center=empty3, sph_radius=empty1, sph_mat=empty_i,
        box_min=empty3, box_max=empty3, box_mat=empty_i,
        tri_v0=dev_t(v[t[:, 0]]), tri_v1=dev_t(v[t[:, 1]]),
        tri_v2=dev_t(v[t[:, 2]]), tri_mat=dev_t(t[:, 6], np.int32),
        materials=mats,
        textures=textures if textured else None,
        alpha_textures=alpha_tex if textured else None,
        tri_uv0=uvs3[0], tri_uv1=uvs3[1], tri_uv2=uvs3[2])


def load_obj(path: str, transform: Optional[np.ndarray] = None,
             device=None) -> PrimitiveScene:
    """One OBJ file as a triangle scene, with texcoords and map_Kd /
    map_d textures where it has them; `transform` [3+, 4] moves its
    vertices."""
    atlas = _TextureAtlas()
    mat_rows: List[tuple] = []
    tex_ids: List[int] = []
    part = _parse_obj(path, atlas, mat_rows, tex_ids)
    return _assemble([part], mat_rows, tex_ids, atlas, transform, device)


def load_obj_dir(path: str, transform: Optional[np.ndarray] = None,
                 overrides: Sequence[Tuple[str, tuple]] = (),
                 max_files: Optional[int] = None,
                 device=None) -> PrimitiveScene:
    """Every `*.obj` under `path` (sorted, at most max_files) merged into
    one scene. overrides: [(filename glob, (model, kd, fuzz, ni))], the
    first matching rule per file sets all its materials; a rule of None
    skips the file."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".obj"))
    if max_files is not None:
        files = files[:max_files]
    atlas = _TextureAtlas()
    mat_rows: List[tuple] = []
    tex_ids: List[int] = []
    parts = []
    for fn in files:
        ov, skip = None, False
        for pat, mat in overrides:
            if fnmatch.fnmatch(fn, pat) or pat in fn:
                skip, ov = mat is None, mat
                break
        if not skip:
            parts.append(_parse_obj(os.path.join(path, fn), atlas, mat_rows,
                                    tex_ids, mat_override=ov))
    return _assemble(parts, mat_rows, tex_ids, atlas, transform, device)


def load_camera_file(path: str):
    """A `.camera` file's six floats: ((eye xyz), (centre xyz))."""
    with open(path) as f:
        vals = [float(x) for x in f.read().split()[:6]]
    return tuple(vals[:3]), tuple(vals[3:])
