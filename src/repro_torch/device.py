"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU by
name.  Without a card and without an explicit `device="cpu"` they raise:
a run never quietly moves to the CPU, so a time taken through an entry
point is always a time on the device it names.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device (raises if there is none);
    anything else is taken as named ("cpu", "cuda", "cuda:1", a
    `torch.device`), and a CUDA name without a card raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
