"""LR schedules."""
import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10000,
                  floor: float = 0.1):
    """Linear warm-up to 1 over `warmup` steps, then a cosine down to
    `floor` at `total`: a float32 tensor on `step`'s device (a Python
    number gives a CPU tensor)."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
