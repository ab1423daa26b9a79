"""Batched serving driver: prefill a batch of prompts, then decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]

`--arch` names any decoder arch `Model` builds: the serving path is
held against the JAX package for qwen3-1.7b, gemma3-1b (hd 256, 5 local
: 1 global sliding-window layers) and mamba2-1.3b; MoE, MLA and
encoder-decoder archs raise.  Runs on the CUDA card unless `--device
cpu` is given (without a card and without it, it raises).  The flash-attention and SSD-scan kernels are
switched on, so on the card prefill goes through both; on the CPU their
wrappers compute the plain versions.  Parameters come from `Model.init`
with a `torch.Generator` seeded by `--seed` on the run's device; prompts
come from numpy, as in the JAX package's driver, so they are the same
on every device.
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


def prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int64)


def generate(model: Model, tokens: torch.Tensor, gen: int):
    """Prefill `tokens` [B, T], then decode `gen` tokens greedily.
    Returns (tokens [B, gen + 1] int32 on the CPU, stats) where stats
    holds the prefill and decode wall seconds, each ending in a device
    synchronisation."""
    dev = model.device
    t = tokens.shape[1]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    logits, caches = model.prefill(tokens)
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
    tokens = torch.from_numpy(prompts(model.cfg, b, t, args.seed)).to(
        model.device)
    toks, stats = generate(model, tokens, args.gen)
    dt = stats["decode_s"]
    print(f"[serve] {model.cfg.name} on {model.device}: prefill {b}x{t}: "
          f"{stats['prefill_s'] * 1e3:.0f}ms")
    print(f"[serve] decoded {args.gen} tokens/seq x {b} seqs in "
          f"{dt * 1e3:.0f}ms ({args.gen * b / max(dt, 1e-9):.1f} tok/s)")
    print("[serve] sample:", toks[0][:16].tolist())
    return toks


if __name__ == "__main__":
    main()
