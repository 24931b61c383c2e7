"""Multi-process rendering on torch.distributed (counterpart of
`gsrt.parallel.multihost`).

One process per rank, all launched with the same program and joined by
`initialize`; `global_render_mesh` then spans every rank's device, each
shard marked with the rank that owns it, and `render_data_parallel`
renders only this process's row slabs. `gather_to_hosts` assembles the
full image on every rank when a caller needs it.

Launch with torchrun (which sets MASTER_ADDR / MASTER_PORT, WORLD_SIZE,
RANK and LOCAL_RANK), one rank per card:

    torchrun --nproc-per-node 4 my_render_job.py

    from gsrt_torch.parallel import multihost, tiled_render_fn
    multihost.initialize(backend="nccl")
    mesh = multihost.global_render_mesh()
    slabs = multihost.render_data_parallel_global(cloud, camera, cfg, mesh)
    trans, color = multihost.gather_to_hosts(slabs)   # NumPy, every rank

The backend is the caller's choice and nothing switches it: "nccl" where
each rank has a card of its own (initialize makes LOCAL_RANK's card the
current one), "gloo" for CPU tensors and for ranks that share a card
(NCCL refuses two ranks on one card). Gloo all-gathers host tensors only,
so under it `gather_to_hosts` gathers host copies.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import Camera, GaussianCloud, resolve_device
from gsrt_torch.parallel.tiles import (RenderMesh, RowSlabs,
                                       make_render_mesh, render_data_parallel)


def _env_int(name: str, given) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"pass it or set {name} (torchrun sets it)")
    return int(os.environ[name])


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """`torch.distributed.init_process_group` over TCP at
    coordinator_address ("host:port"), num_processes ranks, this one
    process_id; each None is read from torchrun's environment
    (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK). `backend` ("nccl" or
    "gloo") must be named. Idempotent."""
    if dist.is_initialized():
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
            raise ValueError("pass coordinator_address or set MASTER_ADDR "
                             "and MASTER_PORT (torchrun sets them)")
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    world = _env_int("WORLD_SIZE", num_processes)
    rank = _env_int("RANK", process_id)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def global_render_mesh(n_splats: int = 1, device=None) -> RenderMesh:
    """('tiles', 'splats') mesh over one device of every rank, in rank
    order, the splat axis innermost; each shard is marked with its rank.
    This rank's device is `device` (CUDA's current device by default)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    if world % n_splats:
        raise ValueError(f"{world} ranks do not divide into splat shards "
                         f"of {n_splats}")
    names = [None] * world
    dist.all_gather_object(names, str(dev))
    mesh = make_render_mesh(world // n_splats, n_splats, names)
    ranks = tuple(tuple(range(i * n_splats, (i + 1) * n_splats))
                  for i in range(world // n_splats))
    return dataclasses.replace(mesh, ranks=ranks, rank=dist.get_rank())


def render_data_parallel_global(cloud: GaussianCloud, camera: Camera,
                                cfg: RenderConfig, mesh: RenderMesh):
    """Image-slab data parallelism over the global mesh through
    render_fast: this rank's row slabs (RowSlabs)."""
    return render_data_parallel(cloud, camera, cfg, mesh)


def gather_to_hosts(slabs: RowSlabs):
    """Every rank's row slabs put together: (trans [H, W], color [H, W,
    3]) as NumPy on every rank. A collective: every rank calls it."""
    h, width = slabs.trans[0].shape if slabs.y0 else (0, 0)
    meta = [None] * dist.get_world_size()
    dist.all_gather_object(meta, (slabs.y0, h, width))
    h = max(m[1] for m in meta)
    width = max(m[2] for m in meta)
    most = max(len(m[0]) for m in meta)
    dev = torch.device("cpu") if dist.get_backend() == "gloo" \
        else torch.device("cuda", torch.cuda.current_device())
    packed = torch.zeros((most * h, width, 4), device=dev)
    for k, (t, c) in enumerate(zip(slabs.trans, slabs.color)):
        packed[k * h:(k + 1) * h] = torch.cat([t[..., None], c], -1).to(dev)
    parts = [torch.empty_like(packed) for _ in meta]
    dist.all_gather(parts, packed)
    full = np.zeros((sum(len(m[0]) for m in meta) * h, width, 4),
                    np.float32)
    for (y0s, *_), part in zip(meta, parts):
        part = part.cpu().numpy()
        for k, y0 in enumerate(y0s):
            full[y0:y0 + h] = part[k * h:(k + 1) * h]
    return full[..., 0].copy(), full[..., 1:].copy()


def sync_hosts() -> None:
    """Barrier across ranks (e.g. before and after checkpoint IO)."""
    dist.barrier()
