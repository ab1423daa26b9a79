"""Step builders + input/parameter/cache specs for training and serving.

`make_train_step` is the JAX package's step (`repro/launch/steps.py`),
on one device or on a mesh: the float32 masters are cast to the compute
dtype once per step, the loss is differentiated with respect to those
copies (the gradients are the compute-dtype copies' gradients,
accumulated in float32 across microbatches), and AdamW applies them to
the masters in place.  On a mesh (`Model(cfg, ctx)`) the masters are
DTensors, their casts and gradients are laid out as they are, and AdamW
updates each rank's blocks with the norm of the whole gradient.

The spec helpers work on shapes alone (meta tensors), so they give the
layout of a production mesh without allocating anything, and with
`ParallelCtx.mesh` a name -> size mapping, without any rank: `build_ctx`,
`param_shapes_and_axes`, `param_shardings`, `batch_specs` and
`cache_specs`.  Their trees are the port's (layers in true order, no
stacked "layers" axis); each leaf's spec is the reference's without that
leading None.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import tree as T
from ..models import Model
from ..models import layers as L
from ..models import sharding as SH
from ..models.model import DecodeDims, ModelConfig, param_axes
from ..optim import AdamWConfig, adamw_update
from ..optim.schedule import warmup_cosine


def build_ctx(mesh) -> SH.ParallelCtx:
    """The ctx of a mesh (a DeviceMesh, or {axis name: size}): the batch
    over "pod" and "data", tensor axes over "model", weights' "embed"
    over "data"."""
    names = tuple(SH.mesh_shape(mesh))
    batch_axes = tuple(n for n in names if n in ("pod", "data"))
    return SH.ParallelCtx(mesh=mesh, batch_axes=batch_axes,
                          model_axis="model", fsdp_axes=("data",))


# ---------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------

def param_shapes_and_axes(model: Model):
    """(tree of meta tensors, tree of logical-axis tuples), shaped like
    `model.param_tree()`; nothing is allocated."""
    shapes = Model(model.cfg)._draw(L.META).param_tree()
    return shapes, param_axes(shapes, model.cfg)


def param_shardings(model: Model, ctx: SH.ParallelCtx,
                    serving_mode: str = "train"):
    """(shapes, tree of `sharding.Sharding`) of the parameters."""
    shapes, axes = param_shapes_and_axes(model)
    if serving_mode == "decode":
        # weight-stationary serving: no FSDP (embed unsharded over data);
        # instead the *output* dims (mlp/d_ff) shard over "data", and MoE
        # experts match moe_ep_stationary's (model, data) layout.
        ctx = dataclasses.replace(ctx, extra_rules={"embed": (),
                                                    "mlp": ("data",)})
    elif model.cfg.seq_parallel:
        # sequence-parallel archs keep activations seq-sharded on the
        # model axis; the (small) MLP weights are replicated over "model"
        # and stay FSDP-sharded over "data".
        ctx = dataclasses.replace(ctx, extra_rules={"mlp": ()})
    return shapes, SH.tree_shardings(axes, shapes, ctx, for_weights=True)


def batch_specs(cfg: ModelConfig, shape: dict, ctx: SH.ParallelCtx | None):
    """(meta tensors of a step's inputs, {name: Sharding} or None)."""
    b, t = shape["global_batch"], shape["seq_len"]
    mode = shape["mode"]

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if mode == "train":
        batch = {"tokens": sds((b, t), torch.int32),
                 "labels": sds((b, t), torch.int32)}
        if cfg.arch_kind == "encdec":
            batch["frames"] = sds((b, t, cfg.d_model), torch.float32)
    elif mode == "prefill":
        batch = {"tokens": sds((b, t), torch.int32)}
        if cfg.arch_kind == "encdec":
            batch["frames"] = sds((b, t, cfg.d_model), torch.float32)
    else:                          # decode
        batch = {"tokens": sds((b, 1), torch.int32)}
    if ctx is None:
        return batch, None
    return batch, {k: SH.Sharding(ctx.mesh, SH.batch_spec(ctx, b, v.ndim))
                   for k, v in batch.items()}


def cache_specs(model: Model, dims: DecodeDims, ctx: SH.ParallelCtx | None):
    """(meta tensors of `init_cache(dims)`, tree of Sharding or None).
    kv-head sharding is preferred; when the arch's kv heads cannot tile
    the model axis, the sequence is sharded (the distributed decode
    attention)."""
    shapes = model.cache_shapes(dims)
    if ctx is None:
        return shapes, None
    return shapes, SH.tree_shardings(model.cache_logical_axes(dims), shapes,
                                     SH.cache_ctx(model.cfg, ctx),
                                     for_weights=False)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    total_steps: int = 10000
    warmup_steps: int = 100


def make_train_step(model: Model, tcfg: TrainConfig):
    """(opt_state, batch) -> (loss, grad_norm), both float32 tensors on the
    model's device; the model's parameters and `opt_state` are updated in
    place.  The same for a sharded model: `opt_state` from `adamw_init`
    of its DTensor parameters, `batch` global (the same on every rank).

    With microbatches > 1, the batch is split along dim 0 and gradients
    are accumulated in float32 over the parts, then divided by their
    count; the loss is the parts' mean."""
    def grads_of(leaves, tree, batch):
        loss = model.loss_fn(tree, batch)
        # a DTensor's gradient arrives in its layout: keep the local block
        return loss.detach(), [SH.local_block(g) for g in
                               torch.autograd.grad(loss, leaves)]

    def train_step(opt_state, batch):
        k = tcfg.microbatches
        cd = model.cfg.compute_dtype
        masters = model.param_tree()
        # Cast the fp32 masters ONCE per step, before any use, and
        # differentiate with respect to the casts: the gradients are those
        # of the compute-dtype copies (standard mixed precision), as in
        # the reference.
        leaves = [p.detach().to(cd).requires_grad_()
                  if p.dtype == torch.float32 else p.detach().requires_grad_()
                  for p in T.leaves(masters)]
        tree = T.unflatten(masters, leaves)
        if k > 1:
            b = next(iter(batch.values())).shape[0]
            if b % k:
                raise ValueError(f"batch {b} does not split into {k} "
                                 f"microbatches")
            parts = [{key: x[i * (b // k):(i + 1) * (b // k)]
                      for key, x in batch.items()} for i in range(k)]
            losses, grads = [], None
            for part in parts:
                loss, g = grads_of(leaves, tree, part)
                losses.append(loss)
                if grads is None:
                    grads = [x.float() for x in g]
                else:
                    torch._foreach_add_(grads, g)
            torch._foreach_div_(grads, float(k))
            loss = torch.stack(losses).mean()
        else:
            loss, grads = grads_of(leaves, tree, batch)
        del leaves, tree      # free the casts before the update's temporaries
        lr_scale = warmup_cosine(opt_state["step"] + 1,
                                 warmup=tcfg.warmup_steps,
                                 total=tcfg.total_steps)
        _, _, gnorm = adamw_update(tcfg.opt, masters,
                                   T.unflatten(masters, list(grads)),
                                   opt_state, lr_scale)
        model.drop_compute_copy()
        return loss, gnorm

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(batch):
        return model.prefill(batch["tokens"], batch.get("frames"))
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(caches, tokens, pos):
        return model.decode_step(caches, tokens, pos)
    return decode_step
