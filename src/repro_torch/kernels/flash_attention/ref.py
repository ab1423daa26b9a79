"""Plain PyTorch version of the flash-attention kernel."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=None):
    """q: [BH, Tq, hd], k/v: [BH, Tk, hd] — exact softmax attention in
    float32, output in q's dtype."""
    _, tq, hd = q.shape
    tk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(hd)
    qp = torch.arange(tq, device=q.device)[:, None]
    kp = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    s = s.masked_fill(~mask[None], -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
