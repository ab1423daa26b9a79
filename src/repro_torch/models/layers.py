"""Model layers of the port: norm, rope, GQA attention (train / prefill /
decode, optional qk-norm and sliding window) and the SwiGLU MLP.

Each layer is a function of a parameter mapping (name -> tensor) with
the JAX package's names and layouts (`wq [d,h,hd]`, `wo [h,hd,d]`, ...),
so the products read as they do there.  Every `init_*` returns such a
mapping, drawn from a `torch.Generator` on the generator's device.  MLA
and MoE are not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as fops


def _norm(gen, shape, scale=0.02, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------

def init_rmsnorm(gen, d, dtype=torch.float32):
    return {"w": torch.ones((d,), dtype=dtype, device=gen.device)}


def rms_norm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * params["w"].float()).to(dt)


# ---------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------

def rope(x, positions, theta=1e4):
    """x: [..., T, H, hd]; positions: [..., T] int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    # ang: [..., T, 1, half]
    ang = positions[..., :, None, None].float() * freqs[None, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------
# Attention (GQA, optional qk-norm / sliding window; decode cache)
# ---------------------------------------------------------------------

def init_attention(gen, cfg, dtype=torch.float32):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _norm(gen, (d, h, hd), dtype=dtype),
        "wk": _norm(gen, (d, kv, hd), dtype=dtype),
        "wv": _norm(gen, (d, kv, hd), dtype=dtype),
        "wo": _norm(gen, (h, hd, d), dtype=dtype),
    }
    if cfg.qk_norm:
        p["qnorm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["knorm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def _head_rms(x, w, eps=1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


def _sdpa(q, k, v, mask, use_flash=False, window=None, causal=True):
    """q: [B,Tq,H,hd] k,v: [B,Tk,KV,hd]; mask [1,Tq,Tk] bool or None
    (every key valid).  KV heads are repeated to the q heads at use; the
    KV cache itself stays kv-sized.  When `use_flash` is set and shapes
    allow, dispatches to the flash-attention kernel."""
    b, tq, h, hd = q.shape
    g = h // k.shape[2]
    if use_flash and tq > 1 and tq % 128 == 0 and k.shape[1] % 128 == 0:
        return fops.flash_attention(q, k, v, causal=causal, window=window)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    # scores in float32 (the reference's preferred_element_type)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, :, :], -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def attention(params, x, cfg, *, positions, cache=None, cache_pos=None,
              window=None, causal=True, use_flash=False, build_cache=False):
    """Returns (out [B,T,D], new_cache).

    * training: cache=None, full sequence.
    * prefill: build_cache=True — returns the rope'd (k, v) (clipped to
      the sliding window for local layers) as the decode cache.
    * decode: x is [B,1,D]; cache = (k,v) with [B,S,KV,hd]; the new token
      is written into the cache ring at `cache_pos % S` **in place** (the
      reference returns an updated copy), then attends to all S entries.
    """
    b, t, d = x.shape
    h, kvh, hd = params["wq"].shape[1], params["wk"].shape[1], \
        params["wq"].shape[2]
    q = (x @ params["wq"].reshape(d, h * hd)).view(b, t, h, hd)
    k = (x @ params["wk"].reshape(d, kvh * hd)).view(b, t, kvh, hd)
    v = (x @ params["wv"].reshape(d, kvh * hd)).view(b, t, kvh, hd)
    if cfg.qk_norm:
        q = _head_rms(q, params["qnorm"])
        k = _head_rms(k, params["knorm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if build_cache:
        w = window or k.shape[1]
        new_cache = (k[:, -w:], v[:, -w:])
    if cache is not None:
        ck, cv = cache
        s = ck.shape[1]
        pos = cache_pos % s
        ck[:, pos:pos + t] = k.to(ck.dtype)
        cv[:, pos:pos + t] = v.to(cv.dtype)
        new_cache = (ck, cv)
        k, v = ck, cv
        # decode: every cache slot is valid — local layers pass a cache
        # pre-sized to their window, so no extra masking is needed
        mask = None
    else:
        # positions are identical across the batch in train/prefill
        qpos = positions[:1, :, None]
        kpos = positions[:1, None, :]
        if causal:
            mask = qpos >= kpos
            if window is not None:
                mask = mask & (qpos - kpos < window)
        else:
            mask = None

    out = _sdpa(q, k, v, mask, use_flash=use_flash, window=window,
                causal=causal and cache is None)
    out = out.reshape(b, t, h * hd) @ params["wo"].reshape(h * hd, d)
    return out, new_cache


# ---------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------

def init_mlp(gen, d, f, dtype=torch.float32):
    return {
        "wi": _norm(gen, (d, f), dtype=dtype),
        "wg": _norm(gen, (d, f), dtype=dtype),
        "wo": _norm(gen, (f, d), dtype=dtype),
    }


def mlp(params, x):
    h = x @ params["wi"]
    g = x @ params["wg"]
    return (F.silu(g) * h) @ params["wo"]
