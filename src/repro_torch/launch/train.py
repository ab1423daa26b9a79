"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ck \
        [--device cpu]

The JAX package's driver (`repro/launch/train.py`) with the same flags,
plus `--device`: synthetic data pipeline (and an encoder-decoder's
frames, drawn per step as the reference draws them), AdamW with
warmup-cosine, microbatch accumulation, async checkpointing with
resume, step watchdog (straggler flagging) and heartbeat.  It runs on the CUDA card unless
`--device cpu` is given (without a card and without it, it raises).
`--smoke` selects the reduced config.  The model is built from
`get_config` as the config has it (bf16 compute, `remat="full"`, the
flash and SSD kernels off: they have no backward), with parameters from
`Model.init` and a `torch.Generator` seeded by `--seed` on the run's
device.

`run(args, model=Model(cfg, ctx))` trains a sharded model on its mesh
with the same loop: every rank feeds the same global batch, a
checkpoint holds whole leaves (gathered by every rank, written by rank
0, which alone keeps the heartbeat), and a resume lays them out on the
model's mesh, which may differ from the one that saved.

A checkpoint named step N holds the state after N updates, so a resumed
run takes the same steps as one that was never stopped.  (The
reference's loop saves the state after update N + 1 under step N, and a
run resumed from such a mid-run checkpoint repeats a step.)
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .. import tree as T
from ..checkpoint import (AsyncCheckpointer, is_writer, latest_step,
                          restore_checkpoint)
from ..configs import get_config
from ..data import SyntheticLMData
from ..device import resolve_device
from ..models import Model
from ..optim import AdamWConfig, adamw_init
from ..runtime import Heartbeat, StepWatchdog
from . import steps as St


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M-param variant)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_model(args) -> Model:
    """The model `args` describe, drawn on its device."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    over = {}
    if args.d_model:
        over.update(d_model=args.d_model,
                    d_ff=args.d_model * 4,
                    head_dim=args.d_model // cfg.n_heads)
    if args.layers:
        over.update(n_layers=args.layers)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return Model(cfg).init(torch.Generator(device=dev).manual_seed(args.seed))


def frames(cfg, args, step: int) -> torch.Tensor:
    """An encoder-decoder's frame embeddings for `step`: normal(0, 0.02)
    [batch, seq, d_model] float32 from a numpy generator seeded by the
    step, as the JAX package's driver draws them."""
    rng = np.random.default_rng(step)
    return torch.from_numpy(rng.normal(
        0, 0.02, (args.batch, args.seq, cfg.d_model)).astype(np.float32))


def run(args, model: Model | None = None) -> list:
    """Train as `args` say, on `model` when one is given (else
    `build_model(args)`).  Returns one record per step taken: {step,
    loss, grad_norm, seconds, straggler}; a step's seconds end when its
    loss is read back."""
    model = model if model is not None else build_model(args)
    cfg, dev = model.cfg, model.device
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq} device={dev}")

    tcfg = St.TrainConfig(
        opt=AdamWConfig(lr=args.lr),
        microbatches=args.microbatches,
        total_steps=args.steps, warmup_steps=max(args.steps // 20, 5))
    step_fn = St.make_train_step(model, tcfg)
    opt_state = adamw_init(model.param_tree())

    start = 0
    ck = None
    if args.ckpt_dir:
        ck = AsyncCheckpointer(args.ckpt_dir)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            target = {"params": model.param_tree(), "opt": opt_state}
            placements = None
            if model.ctx is not None:
                _, shardings = St.param_shardings(model, model.ctx)
                placements = {"params": shardings, "opt": {
                    "step": None, "m": shardings, "v": shardings}}
            state = restore_checkpoint(args.ckpt_dir, last, target,
                                       device=dev, placements=placements)
            with torch.no_grad():
                for p, q in zip(T.leaves(model.param_tree()),
                                T.leaves(state["params"])):
                    p.copy_(q)
            model.drop_compute_copy()
            opt_state = state["opt"]
            start = last
            print(f"[train] resumed from step {start}")

    data = SyntheticLMData(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)
    wd = StepWatchdog()
    hb = Heartbeat(os.path.join(args.ckpt_dir, "heartbeat.json"),
                   interval_s=30).start() \
        if args.ckpt_dir and is_writer() else None

    records = []
    try:
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(step).items()}
            if cfg.arch_kind == "encdec":
                batch["frames"] = frames(cfg, args, step).to(dev)
            t0 = time.perf_counter()
            loss, gnorm = step_fn(opt_state, batch)
            loss = float(loss)
            dt = time.perf_counter() - t0
            slow = wd.observe(dt)
            records.append(dict(step=step, loss=loss, grad_norm=float(gnorm),
                                seconds=dt, straggler=slow))
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step={step:5d} loss={loss:.4f} "
                      f"gnorm={records[-1]['grad_norm']:.3f} "
                      f"dt={dt*1e3:.0f}ms{' STRAGGLER' if slow else ''}")
            if ck and (step + 1) % args.ckpt_every == 0 \
                    and step + 1 < args.steps:
                ck.save(step + 1, {"params": model.param_tree(),
                                   "opt": opt_state})
        if ck:
            ck.save(args.steps, {"params": model.param_tree(),
                                 "opt": opt_state})
            ck.wait()
    finally:
        if hb:
            hb.stop()
    losses = [r["loss"] for r in records]
    if losses:
        print(f"[train] done: first-10 avg {np.mean(losses[:10]):.4f} -> "
              f"last-10 avg {np.mean(losses[-10:]):.4f}")
    return records


def main(argv=None):
    """Run the driver; returns the list of losses, one per step taken."""
    return [r["loss"] for r in run(parse_args(argv))]


if __name__ == "__main__":
    main()
