"""Architecture registry of the port: 10 archs x 4 input shapes.

Each arch module defines CONFIG (the published configuration, field for
field as in the JAX package, with torch dtypes) and SMOKE (a reduced
config of the same family for CPU tests).  Every arch's config is here
as data: the collective workloads size their traffic from any of them.
`Model` builds the dense GQA and Mamba2 decoders (qwen3-1.7b,
gemma3-1b, starcoder2-3b, chameleon-34b, mamba2-1.3b); MoE, MLA and the
encoder-decoder raise (ROADMAP Queue 1).  Shapes follow the assignment:

    train_4k     seq 4096,   global_batch 256   (train_step)
    prefill_32k  seq 32768,  global_batch 32    (serve prefill)
    decode_32k   seq 32768,  global_batch 128   (serve_step, 1 new token)
    long_500k    seq 524288, global_batch 1     (long-context decode;
                 only sub-quadratic archs — see DESIGN.md)
"""
from __future__ import annotations

import importlib

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, mode="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, mode="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, mode="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, mode="decode"),
}

ARCHS = [
    "qwen3_1_7b",
    "gemma3_1b",
    "starcoder2_3b",
    "minicpm3_4b",
    "seamless_m4t_medium",
    "qwen3_moe_235b_a22b",
    "grok_1_314b",
    "chameleon_34b",
    "jamba_v0_1_52b",
    "mamba2_1_3b",
]

# archs that can run 524288-token decode sub-quadratically (SSM / hybrid /
# mostly-local attention).  Pure full-attention archs skip long_500k.
LONG_CONTEXT_OK = {"mamba2_1_3b", "jamba_v0_1_52b", "gemma3_1b"}


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(arch: str, smoke: bool = False):
    mod = importlib.import_module(f"{__name__}.{canon(arch)}")
    return mod.SMOKE if smoke else mod.CONFIG


def cells():
    """All runnable (arch, shape) dry-run cells."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_CONTEXT_OK:
                continue
            out.append((a, s))
    return out
