"""Device meshes on `torch.distributed`.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model"); the
"pod" axis is pure data parallelism across pods.
Host mesh:  1 x 1, axes ("data", "model"): the sharded paths on one card
(NCCL) or, when the caller asks for "cpu", on one CPU process (gloo).

Functions, so that importing this module starts no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The 16 x 16 (or 2 x 16 x 16) mesh over an initialised world of 256
    (512) ranks; any other world raises.  The dry-run builds it with
    `device="cpu"` over a fake group of that size (`launch.dryrun`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} mesh needs a "
                           f"process group of {need} ranks, not {world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(device=None):
    """A 1 x 1 mesh ("data", "model") on `device` (None: the CUDA card,
    through NCCL; "cpu": gloo).  Without a process group it starts one of
    world size 1 on an in-process store (no file, no TCP port); with one,
    the world must hold one rank."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":            # NCCL binds the current device
            torch.cuda.set_device(torch.cuda.current_device()
                                  if dev.index is None else dev.index)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"the host mesh is 1 x 1: the process group has "
                           f"{dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
