"""Batched serving driver: prefill a batch of prompts, then decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]

`--arch` names any of the ten archs (`configs.ARCHS`): dense GQA, MLA,
MoE, Mamba2, the attention:SSM hybrid and the encoder-decoder, each held
against the JAX package by the CPU tests.  Runs on the CUDA card unless
`--device cpu` is given (without a card and without it, it raises).
The flash-attention and SSD-scan kernels are switched on, so on the
card prefill goes through both where a layer dispatches to them; on the
CPU their wrappers compute the plain versions.  Parameters come from
`Model.init` with a `torch.Generator` seeded by `--seed` on the run's
device; prompts, and an encoder-decoder's frames (normal(0, 0.02)
[batch, prompt, d_model], drawn right after the prompts from the same
generator), come from numpy, as in the JAX package's driver, so they
are the same on every device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import Model


def load_model(arch: str, *, smoke: bool = False, seed: int = 0,
               device=None) -> Model:
    """The arch's model with both kernels switched on, drawn from a
    generator seeded by `seed` on `device` (None: the CUDA card)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config(arch, smoke=smoke),
                              use_flash_kernel=True, use_ssd_kernel=True)
    return Model(cfg).init(torch.Generator(device=dev).manual_seed(seed))


def inputs(cfg, batch: int, prompt_len: int, seed: int):
    """(prompts [batch, prompt_len] int64, frames [batch, prompt_len,
    d_model] float32 for an encoder-decoder, else None), drawn as the
    JAX package's driver draws them."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int64)
    frames = None
    if cfg.arch_kind == "encdec":
        frames = rng.normal(0, 0.02, (batch, prompt_len, cfg.d_model)
                            ).astype(np.float32)
    return tokens, frames


def prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    return inputs(cfg, batch, prompt_len, seed)[0]


def generate(model: Model, tokens: torch.Tensor, gen: int, frames=None):
    """Prefill `tokens` [B, T] (and an encoder-decoder's `frames` [B, T,
    D]), then decode `gen` tokens greedily.  Returns (tokens [B, gen + 1]
    int32 on the CPU, stats) where stats holds the prefill and decode
    wall seconds, each ending in a device synchronisation."""
    dev = model.device
    t = tokens.shape[1]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    logits, caches = model.prefill(tokens, frames)
    sync()
    prefill_s = time.perf_counter() - t0

    # Decode uses ring-buffer caches: generating past the prompt length
    # overwrites the oldest prompt entries (sliding-window semantics for
    # attention caches; SSM state is exact regardless).
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen):
        logits, caches = model.decode_step(caches, tok, t + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    sync()
    decode_s = time.perf_counter() - t0
    toks = torch.cat(out, dim=1).to(torch.int32).cpu()
    return toks, dict(prefill_s=prefill_s, decode_s=decode_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = load_model(args.arch, smoke=args.smoke, seed=args.seed,
                       device=args.device)
    b, t = args.batch, args.prompt_len
    tokens, frames = inputs(model.cfg, b, t, args.seed)
    tokens = torch.from_numpy(tokens).to(model.device)
    if frames is not None:
        frames = torch.from_numpy(frames).to(model.device)
    toks, stats = generate(model, tokens, args.gen, frames)
    dt = stats["decode_s"]
    print(f"[serve] {model.cfg.name} on {model.device}: prefill {b}x{t}: "
          f"{stats['prefill_s'] * 1e3:.0f}ms")
    print(f"[serve] decoded {args.gen} tokens/seq x {b} seqs in "
          f"{dt * 1e3:.0f}ms ({args.gen * b / max(dt, 1e-9):.1f} tok/s)")
    print("[serve] sample:", toks[0][:16].tolist())
    return toks


if __name__ == "__main__":
    main()
