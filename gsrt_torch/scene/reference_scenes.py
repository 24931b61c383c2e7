"""Named scenes of the reference renderer's scene list whose data ships
in its tree (counterpart of `gsrt.scene.reference_scenes`): directory OBJ
scenes with per-file material rules, uniform scales, `.camera` files and
the factories' intrinsics. Every scene reads the tree that the
environment variable GSRT_REFERENCE_ROOT names (`REF_ROOT`;
`reference_data_available()` says whether it is there); nothing is
fetched. Scenes go to CUDA unless device="cpu".
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

from gsrt_torch.core.types import Materials, look_at, make_camera
from gsrt_torch.models.path_tracer import PrimitiveScene
from gsrt_torch.scene.obj import load_camera_file, load_obj, load_obj_dir
from gsrt_torch.scene.primitives_catalog import REF_ROOT


def reference_data_available() -> bool:
    return bool(REF_ROOT) and os.path.isdir(os.path.join(REF_ROOT, "Scenes"))


def _scenes(*parts) -> str:
    return os.path.join(REF_ROOT, "Scenes", *parts)


def _camera_from_dir(path, fov, width, height, fallback, device):
    """The first `.camera` file of the directory (eye, centre), else the
    factory's own look-at."""
    cams = sorted(f for f in os.listdir(path) if f.endswith(".camera"))
    eye, center = (load_camera_file(os.path.join(path, cams[0])) if cams
                   else fallback)
    return make_camera(look_at(eye, center), fov, width, height,
                       device=device)


def _add_ground_sphere(scene: PrimitiveScene, center, radius,
                       rgb) -> PrimitiveScene:
    """One more Lambertian sphere, with its material appended."""
    mats = scene.materials
    dev = scene.device
    nm = mats.model.shape[0]

    def cat(a, row, dtype=torch.float32):
        return torch.cat([a, torch.tensor(row, dtype=dtype, device=dev)])
    new_mats = Materials(
        model=cat(mats.model, [Materials.LAMBERTIAN], torch.int32),
        diffuse=cat(mats.diffuse, [rgb]),
        fuzziness=cat(mats.fuzziness, [0.0]),
        refraction_index=cat(mats.refraction_index, [1.0]),
        texture_id=(cat(mats.texture_id, [-1], torch.int32)
                    if mats.texture_id is not None else None))
    return scene._replace(
        sph_center=cat(scene.sph_center, [center]),
        sph_radius=cat(scene.sph_radius, [radius]),
        sph_mat=cat(scene.sph_mat, [nm], torch.int32), materials=new_mats)


def _dir_scene(dirname, fov, fallback_cam, width, height,
               overrides=(), scale=None, max_files=None,
               ground_sphere=None, device=None):
    path = _scenes(dirname)
    transform = None
    if scale is not None:
        transform = np.diag([scale, scale, scale, 1.0]).astype(np.float32)
    scene = load_obj_dir(path, transform=transform, overrides=overrides,
                         max_files=max_files, device=device)
    if ground_sphere is not None:
        scene = _add_ground_sphere(scene, *ground_sphere)
    camera = _camera_from_dir(path, fov, width, height, fallback_cam,
                              scene.device)
    return scene, camera, dict(aperture=0.0, focus=7.0, has_sky=True,
                               gamma=True)


_LAMB = Materials.LAMBERTIAN
_METAL = Materials.METALLIC
_LIGHT = Materials.DIFFUSE_LIGHT


def trees_and_grass(width=128, height=128, max_files=None, device=None):
    """PARK — SceneList.cpp:600-664: 0.1-scaled directory scene with the
    SetAllMaterial color rules and the RTIOW ground ball; alpha-cutout
    foliage workload data (TraceTree.rahit)."""
    overrides = [
        ("*leaves*", (_LAMB, (124 / 256, 252 / 256, 0.0), 0.0, 1.0)),
        ("*grass*", (_LAMB, (124 / 256, 252 / 256, 0.0), 0.0, 1.0)),
        ("*mountain*", (_LAMB, (136 / 256, 140 / 256, 141 / 256), 0.0, 1.0)),
        ("*ground*", (_LAMB, (155 / 256, 118 / 256, 83 / 256), 0.0, 1.0)),
        ("*tree*", (_LAMB, (114 / 256, 92 / 256, 66 / 256), 0.0, 1.0)),
        ("*human*", (_LAMB, (197 / 256, 140 / 256, 133 / 256), 0.0, 1.0)),
        ("*Benz*", (_METAL, (200 / 256, 200 / 256, 200 / 256), 0.2, 1.0)),
    ]
    scene, camera, opts = _dir_scene(
        "TreesAndGrass", 30.0, ((2, 0.5, 0.75), (0, 0.3, 0)),
        width, height, overrides=overrides, scale=0.1,
        max_files=max_files, device=device,
        ground_sphere=((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5)))
    return scene, camera, opts


def blender_2_77(width=128, height=128, max_files=None, device=None):
    """CAR — SceneList.cpp:666-719 (racing car, .camera)."""
    return _dir_scene("Blender_2.77", 30.0,
                      ((0, 2, 10), (0, 0, 0)), width, height,
                      max_files=max_files, device=device)


def blender_2_78(width=128, height=128, max_files=None, device=None):
    """ROBOT — SceneList.cpp:721-760 (procedural robot)."""
    return _dir_scene("Blender_2.78", 30.0,
                      ((0, 2, 10), (0, 0, 0)), width, height,
                      max_files=max_files, device=device)


def blender_2_80(width=128, height=128, max_files=None, device=None):
    """SPRNG — Spring splash scene (981 OBJs); SetAllMaterial rules and
    the Dirt_grass exclusion per SceneList.cpp:788-830."""
    overrides = [
        ("*Dirt_grass*", None),   # reference skips these files entirely
        ("*spring_body*", (_LAMB, (223 / 256, 175 / 256, 171 / 256), 0.0, 1.0)),
        ("*stitches*", (_LAMB, (92 / 256, 64 / 256, 51 / 256), 0.0, 1.0)),
        ("*spring_jacket*", (_LAMB, (163 / 256, 67 / 256, 42 / 256), 0.0, 1.0)),
        ("*spring_pants*", (_LAMB, (92 / 256, 74 / 256, 101 / 256), 0.0, 1.0)),
        ("*spring_boots*", (_LAMB, (150 / 256, 106 / 256, 86 / 256), 0.0, 1.0)),
        ("*spring_hairband*", (_LAMB, (69 / 256, 23 / 256, 8 / 256), 0.0, 1.0)),
        ("*spring_hair*", (_LAMB, (108 / 256, 86 / 256, 99 / 256), 0.0, 1.0)),
        ("*spring_scarf*", (_LAMB, (114 / 256, 76 / 256, 64 / 256), 0.0, 1.0)),
        ("*spring_pullover*", (_LAMB, (114 / 256, 76 / 256, 64 / 256), 0.0, 1.0)),
    ]
    return _dir_scene("Blender_2.80", 20.0,
                      ((0, 2, 10), (0, 0, 0)), width, height,
                      overrides=overrides, max_files=max_files, device=device)


def blender_2_83(width=128, height=128, max_files=None, device=None):
    """PARTY — PartyTug splash scene."""
    return _dir_scene("Blender_2.83", 20.0,
                      ((-63.88, 4.68, 59.86), (16.75, 7.34, -15.72)),
                      width, height, max_files=max_files, device=device)


def blender_2_90(width=128, height=128, max_files=None, device=None):
    """FOX — Splash Fox."""
    return _dir_scene("Blender_2.90", 30.0,
                      ((0, 2, 10), (0, 0, 0)), width, height,
                      max_files=max_files, device=device)


def blender_2_91(width=128, height=128, max_files=None, device=None):
    """FRST — Red Autumn Forest; SetAllMaterial rules per
    SceneList.cpp:959-1025 (per-slot ForeGround rules approximated
    whole-file; the reference's random bush color draw replaced by its
    middle color — the original is non-deterministic run to run)."""
    overrides = [
        ("*Character2_Shirt*", (_LAMB, (156 / 256, 74 / 256, 61 / 256), 0.0, 1.0)),
        ("*Character_Hair*", (_LAMB, (119 / 256, 74 / 256, 55 / 256), 0.0, 1.0)),
        ("*Character_Pants*", (_LAMB, (131 / 256, 115 / 256, 160 / 256), 0.0, 1.0)),
        ("*Character_hair_2*", (_LAMB, (121 / 256, 74 / 256, 56 / 256), 0.0, 1.0)),
        ("*Character_watch*", (_LAMB, (163 / 256, 73 / 256, 78 / 256), 0.0, 1.0)),
        ("*Character*", (_LAMB, (223 / 256, 187 / 256, 161 / 256), 0.0, 1.0)),
        ("*backpackStraps*", (_LAMB, (104 / 256, 66 / 256, 64 / 256), 0.0, 1.0)),
        ("*BackPackDec*", (_LAMB, (108 / 256, 191 / 256, 210 / 256), 0.0, 1.0)),
        ("*BackPack*", (_LAMB, (97 / 256, 85 / 256, 85 / 256), 0.0, 1.0)),
        ("*ForeGround_terrain*", (_LAMB, (212 / 256, 207 / 256, 207 / 256), 0.0, 1.0)),
        ("*MidGround*", (_LAMB, (232 / 256, 189 / 256, 26 / 256), 0.0, 1.0)),
        ("*FlowerParticles*", (_LAMB, (212 / 256, 207 / 256, 207 / 256), 0.0, 1.0)),
        ("*Mesh*", (_LAMB, (142 / 256, 85 / 256, 47 / 256), 0.0, 1.0)),
        ("*bush*", (_LAMB, (224 / 256, 70 / 256, 45 / 256), 0.0, 1.0)),
    ]
    return _dir_scene("Blender_2.91", 30.0,
                      ((0, 2, 10), (0, 0, 0)), width, height,
                      overrides=overrides, max_files=max_files, device=device)


def blender_3_2(width=128, height=128, max_files=None, device=None):
    """LANDS — White Lands; rules per SceneList.cpp:1074-1086 (metallic
    water, fuzz 0.6)."""
    overrides = [
        ("*boat*", (_LAMB, (150 / 256, 111 / 256, 51 / 256), 0.0, 1.0)),
        ("*water*", (_METAL, (18 / 256, 109 / 256, 105 / 256), 0.6, 1.0)),
        ("*Landscape*", (_LAMB, (250 / 256, 250 / 256, 245 / 256), 0.0, 1.0)),
    ]
    return _dir_scene("Blender_3.2", 25.0,
                      ((0, 2, 10), (0, 0, 0)), width, height,
                      overrides=overrides, max_files=max_files, device=device)


def bathroom(width=128, height=128, max_files=None, device=None):
    """BATH — SceneList.cpp:1319-1390 (blendswap 12584, fov 36, .camera).
    The emit_haut DiffuseLight(15) emitter and the whole-file material
    rules are applied; the reference's PER-SLOT rules on sol.obj / prise /
    poubelle / pese_personne / bouteille need slot-granular overrides the
    loader doesn't model (whole-file here would mislabel e.g. the whole
    floor as an emitter, worse than keeping the MTL materials)."""
    overrides = [
        ("*emit_haut*", (_LIGHT, (15.0, 15.0, 15.0), 0.0, 1.0)),
        ("*Meuble*", (_LAMB, (196 / 256, 137 / 256, 88 / 256), 0.0, 1.0)),
        ("*meuble*", (_LAMB, (196 / 256, 137 / 256, 88 / 256), 0.0, 1.0)),
        ("*baignoire*", (_LAMB, (196 / 256, 137 / 256, 88 / 256), 0.0, 1.0)),
        ("*statu*", (_LAMB, (14 / 256, 6 / 256, 3 / 256), 0.0, 1.0)),
        ("*robinet*", (_METAL, (0.73, 0.73, 0.73), 0.0, 1.0)),
        ("*etend_serviette*", (_METAL, (0.73, 0.73, 0.73), 0.0, 1.0)),
    ]
    return _dir_scene("Bathroom", 36.0,
                      ((1.13, -1.3, 13.29), (-4.44, -2.71, 12.73)),
                      width, height, overrides=overrides,
                      max_files=max_files, device=device)


def ship(width=128, height=128, max_files=None, device=None):
    """SHIP — SceneList.cpp:336-360: karimSchooner.obj with
    translate(172.5, -9, -377.5)·scale(100)·rotate(75°, y)."""
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = (555 - 300 - 165 / 2, -9, -295 - 165 / 2)
    s = np.diag([100.0, 100, 100, 1]).astype(np.float32)
    a = np.radians(75.0)
    r = np.eye(4, dtype=np.float32)
    r[0, 0] = r[2, 2] = np.cos(a)
    r[0, 2] = np.sin(a)
    r[2, 0] = -np.sin(a)
    scene = load_obj(os.path.join(REF_ROOT, "assets/models/karimSchooner.obj"),
                     transform=t @ s @ r, device=device)
    camera = make_camera(look_at((378, 278, 500), (178, 278, 0)), 50.0,
                         width, height, device=scene.device)
    return scene, camera, dict(aperture=0.0, focus=10.0, has_sky=True,
                               gamma=True)


REFERENCE_SCENES: Dict[str, Callable] = {
    "trees_and_grass": trees_and_grass,   # PARK
    "blender_2_77": blender_2_77,         # CAR
    "blender_2_78": blender_2_78,         # ROBOT
    "blender_2_80": blender_2_80,         # SPRNG
    "blender_2_83": blender_2_83,         # PARTY
    "blender_2_90": blender_2_90,         # FOX
    "blender_2_91": blender_2_91,         # FRST
    "blender_3_2": blender_3_2,           # LANDS
    "bathroom": bathroom,                 # BATH
    "ship": ship,                         # SHIP
}
