"""Step builders for training and serving.

`make_train_step` is the JAX package's step (`repro/launch/steps.py`)
on one device: the float32 masters are cast to the compute dtype once per
step, the loss is differentiated with respect to those copies (the
gradients are the compute-dtype copies' gradients, accumulated in
float32 across microbatches), and AdamW applies them to the masters in
place.  The mesh helpers of the reference (`build_ctx`,
`param_shardings`, `batch_specs`, `cache_specs`) wait for the port's
sharded paths.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import tree as T
from ..models import Model
from ..optim import AdamWConfig, adamw_update
from ..optim.schedule import warmup_cosine


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    total_steps: int = 10000
    warmup_steps: int = 100


def make_train_step(model: Model, tcfg: TrainConfig):
    """(opt_state, batch) -> (loss, grad_norm), both float32 tensors on the
    model's device; the model's parameters and `opt_state` are updated in
    place.

    With microbatches > 1, the batch is split along dim 0 and gradients
    are accumulated in float32 over the parts, then divided by their
    count; the loss is the parts' mean."""
    def grads_of(leaves, tree, batch):
        loss = model.loss_fn(tree, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

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
