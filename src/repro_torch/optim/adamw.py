"""AdamW with global-norm clipping, in the JAX package's formula and order
(`repro/optim/adamw.py`).

The gradients arrive in the compute dtype (bf16 under mixed precision)
and are clipped and applied in float32 against the float32 masters.  The
state is a dict `{"step": int32 [], "m": tree, "v": tree}` of tensors on
the parameters' device, `m` and `v` float32 trees shaped like the
parameters.  Every update runs on flat lists of leaves through
`torch._foreach_*`: a few multi-tensor launches for all leaves, where a
Python loop would issue a dozen launches per leaf.  `adamw_update`
changes the parameters, `m`, `v` and the step count in place, and never
reads a value back to the host.  Not `torch.optim.AdamW`: its clipping
and its step count are not the reference's.

On a mesh the parameters are DTensors (`Model(cfg, ctx)`): `adamw_init`
lays `m` and `v` out as the parameters, and the update runs on each
rank's local blocks.  The global norm sums each block's float64 squares
over the whole mesh, each divided by the number of ranks that hold the
same block (the product of the axes the leaf is not split on), so a
replicated element counts once.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import tree as T
from ..models import sharding as SH


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> dict:
    """{step, m, v}: m and v float32 zeros laid out as `params` (DTensors
    for DTensor parameters)."""
    z = T.tree_map(lambda p: torch.zeros_like(p.detach(),
                                              dtype=torch.float32), params)
    step = torch.zeros((), dtype=torch.int32,
                       device=SH.local_block(T.leaves(params)[0]).device)
    return {"step": step, "m": z, "v": T.tree_map(torch.clone, z)}


def _spread(params: list):
    """(mesh, [1 / the ranks holding each leaf's block]) when the leaves
    are DTensors, else None."""
    from torch.distributed.tensor import DTensor
    dts = [p for p in params if isinstance(p, DTensor)]
    if not dts:
        return None
    mesh = dts[0].device_mesh
    world = mesh.size()
    weights = []
    for p in params:
        split = 1
        if isinstance(p, DTensor):
            for n, pl in zip(mesh.shape, p.placements):
                split *= int(n) if pl.is_shard() else 1
        weights.append(split / world)
    return mesh, weights


def _clip(grads: list, max_norm: float, spread=None):
    """(float32 copies of `grads` scaled to global norm <= max_norm, the
    norm before clipping, float32); `grads` are left as they are.  Each
    leaf's norm accumulates in float64: the CPU's float32 norm drifts by
    4e-4 over 1e7 elements (a vocab-sized embedding has 3e8).  With
    `spread` (`_spread`), `grads` are local blocks and their weighted
    squares are summed over every axis of the mesh."""
    g32 = [g.float() for g in grads]
    g32 = [c.clone() if c is g else c for c, g in zip(g32, grads)]
    norms = torch._foreach_norm(g32, 2, dtype=torch.float64)
    if spread is None:
        gn = torch.linalg.vector_norm(torch.stack(norms)).float()
    else:
        # the unsharded norm's formula per group of leaves held by as many
        # ranks, weighted by a Python number (no host-to-card copy), then
        # squared for the sum over the mesh: sqrt(x * x) == x in IEEE
        # arithmetic, so one rank holding every leaf whole gets the
        # unsharded norm bit for bit
        mesh, weights = spread
        parts = [torch.linalg.vector_norm(torch.stack(
            [n for n, w in zip(norms, weights) if w == wg])) * math.sqrt(wg)
            for wg in sorted(set(weights))]
        part = torch.linalg.vector_norm(torch.stack(parts))
        gn = SH.all_reduce(part * part, mesh,
                           mesh.mesh_dim_names).sqrt().float()
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    torch._foreach_mul_(g32, scale)
    return g32, gn


def clip_by_global_norm(grads, max_norm: float):
    """(float32 tree of the clipped grads, global norm before clipping)."""
    g32, gn = _clip(T.leaves(grads), max_norm)
    return T.unflatten(grads, g32), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: dict,
                 lr_scale=1.0):
    """One AdamW step on `params` (a tree; its leaves change in place) from
    `grads` (the same tree shape, any float dtype).  Returns (params,
    state, global grad norm before clipping) -- the same objects, updated,
    as the reference returns its new ones.  DTensor parameters (and `m`,
    `v`, `grads` as DTensors or as local blocks) are updated on their
    local blocks, with the norm of the whole gradient."""
    p_dt = T.leaves(params)
    p_flat = [SH.local_block(p) for p in p_dt]
    g32, gnorm = _clip([SH.local_block(g) for g in T.leaves(grads)], cfg.clip_norm,
                       _spread(p_dt))
    m = [SH.local_block(x) for x in T.leaves(state["m"])]
    v = [SH.local_block(x) for x in T.leaves(state["v"])]
    state["step"] += 1
    step = state["step"].float()
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=step.device)

    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, g32, alpha=1 - cfg.b1)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_addcmul_(v, g32, g32, value=1 - cfg.b2)
    del g32
    p32 = [p if p.dtype == torch.float32 else p.float() for p in p_flat]
    # p - lr * (mh / (sqrt(vh) + eps) + wd * p), two float32 temporaries
    denom = torch._foreach_div(v, b2c)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(m, b1c)
    torch._foreach_div_(upd, denom)
    del denom
    torch._foreach_add_(upd, p32, alpha=cfg.weight_decay)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(p32, upd)
    for p, q in zip(p_flat, p32):
        if q is not p:
            p.copy_(q)
    return params, state, gnorm
