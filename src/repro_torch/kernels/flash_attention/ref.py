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


def attention_tiles_ref(q, k, v, *, causal=True, window=None, tile=64):
    """The arithmetic of `csrc/flash_attention_bf16.cu` on [BH, T, hd]: per
    64-row q tile, the k tiles [lo, hi) of the Pallas kernel, an online
    softmax in float32 over 64-key tiles, and the softmax weights P rounded
    to bf16 as the operand of P V (l sums them unrounded).  Output in q's
    dtype."""
    _, tq, hd = q.shape
    tk = k.shape[1]
    n_k = tk // tile
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty_like(q)
    kp_all = torch.arange(tk, device=q.device)
    for qt in range(tq // tile):
        q0 = qt * tile
        qp = torch.arange(q0, q0 + tile, device=q.device)[:, None]
        hi = min(qt + 1, n_k) if causal else n_k
        lo = max((q0 - window) // tile, 0) if window is not None else 0
        m = torch.full(qf.shape[:1] + (tile,), -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qf.shape[:1] + (tile, hd), device=q.device)
        for kt in range(lo, hi):
            ks = slice(kt * tile, (kt + 1) * tile)
            s = torch.einsum("bqd,bkd->bqk", qf[:, q0:q0 + tile],
                             kf[:, ks]) / math.sqrt(hd)
            kp = kp_all[ks][None, :]
            mask = torch.ones((tile, tile), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qp >= kp
            if window is not None:
                mask &= (qp - kp) < window
            s = s.masked_fill(~mask[None], -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqk,bkd->bqd", p.to(torch.bfloat16).float(), vf[:, ks])
            m = m_new
        out[:, q0:q0 + tile] = (acc / l.clamp_min(1e-30)[..., None]).to(
            q.dtype)
    return out
