"""Model layers of the port: norm, rope, GQA attention (train / prefill /
decode, optional qk-norm and sliding window, cross attention), MLA with
its compressed cache, the SwiGLU MLP and the dropless top-k MoE.

Each layer is a function of a parameter mapping (name -> tensor) with
the JAX package's names and layouts (`wq [d,h,hd]`, `wo [h,hd,d]`, ...),
so the products read as they do there.  Every `init_*` returns such a
mapping, drawn from a `torch.Generator` on the generator's device.  The
sharded MoE paths (expert parallelism) wait for the port's `ParallelCtx`.
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


def project_kv(params, x):
    """(k, v) [B, T, KV, hd] of `x` [B, T, D] through `wk`, `wv`."""
    b, t, d = x.shape
    kvh, hd = params["wk"].shape[1], params["wk"].shape[2]
    return ((x @ params["wk"].reshape(d, kvh * hd)).view(b, t, kvh, hd),
            (x @ params["wv"].reshape(d, kvh * hd)).view(b, t, kvh, hd))


def attention(params, x, cfg, *, positions, cache=None, cache_pos=None,
              window=None, cross_kv=None, causal=True, use_flash=False,
              build_cache=False):
    """Returns (out [B,T,D], new_cache).

    * training: cache=None, full sequence.
    * prefill: build_cache=True — returns the rope'd (k, v) (clipped to
      the sliding window for local layers) as the decode cache.
    * decode: x is [B,1,D]; cache = (k,v) with [B,S,KV,hd]; the new token
      is written into the cache ring at `cache_pos % S` **in place** (the
      reference returns an updated copy), then attends to all S entries.
    * cross attention: cross_kv = (k, v) precomputed from the encoder:
      no rope, qk-norm on q only, every key valid, never the flash
      kernel, no cache written.
    """
    b, t, d = x.shape
    h, hd = params["wq"].shape[1], params["wq"].shape[2]
    q = (x @ params["wq"].reshape(d, h * hd)).view(b, t, h, hd)
    k, v = project_kv(params, x) if cross_kv is None else cross_kv
    if cfg.qk_norm:
        q = _head_rms(q, params["qnorm"])
        if cross_kv is None:
            k = _head_rms(k, params["knorm"])
    if cross_kv is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    else:
        causal, use_flash = False, False

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
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek style)
# ---------------------------------------------------------------------

def init_mla(gen, cfg, dtype=torch.float32):
    d, h = cfg.d_model, cfg.n_heads
    dn, dr = cfg.mla_nope_dim, cfg.mla_rope_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dev = gen.device
    return {
        "wdq": _norm(gen, (d, qr), dtype=dtype),
        "wuq": _norm(gen, (qr, h, dn + dr), dtype=dtype),
        "wdkv": _norm(gen, (d, kvr), dtype=dtype),
        "wukv": _norm(gen, (kvr, h, dn + dn), dtype=dtype),
        "wkr": _norm(gen, (d, dr), dtype=dtype),
        "wo": _norm(gen, (h, dn, d), dtype=dtype),
        "qnorm": torch.ones((qr,), dtype=dtype, device=dev),
        "kvnorm": torch.ones((kvr,), dtype=dtype, device=dev),
    }


def mla_attention(params, x, cfg, *, positions, cache=None, cache_pos=None,
                  build_cache=False):
    """MLA with the compressed-KV cache (c_kv + one k_rope head shared by
    all heads): cache = (c_kv [B,S,kv_lora], k_rope [B,S,rope_dim]).

    Decode writes the new token's entries into the ring at
    `cache_pos % S` in place and attends to all S slots without a mask.
    The scores are the nope and rope products summed in float32, scaled
    by 1/sqrt(nope + rope) (not the head dim of `cfg.hd`), so MLA never
    goes through `_sdpa` or the flash kernel."""
    b, t, d = x.shape
    h, dn, dr = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_rope_dim
    qr, kvr = params["wdq"].shape[1], params["wdkv"].shape[1]

    cq = _head_rms(x @ params["wdq"], params["qnorm"])
    q = (cq @ params["wuq"].reshape(qr, h * (dn + dr))).view(b, t, h,
                                                               dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv = _head_rms(x @ params["wdkv"], params["kvnorm"])
    krope = rope((x @ params["wkr"])[:, :, None, :], positions,
                 cfg.rope_theta)[:, :, 0, :]

    new_cache = None
    if build_cache:
        new_cache = (ckv, krope)
    if cache is not None:
        c_ckv, c_kr = cache
        pos = cache_pos % c_ckv.shape[1]
        c_ckv[:, pos:pos + t] = ckv.to(c_ckv.dtype)
        c_kr[:, pos:pos + t] = krope.to(c_kr.dtype)
        new_cache = (c_ckv, c_kr)
        ckv, krope = c_ckv, c_kr

    s = ckv.shape[1]
    kv = (ckv @ params["wukv"].reshape(kvr, h * 2 * dn)).view(b, s, h,
                                                              2 * dn)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    # float32 scores (the reference's preferred_element_type)
    scores = (torch.einsum("bthk,bshk->bhts", q_nope.float(),
                           k_nope.float()) +
              torch.einsum("bthk,bsk->bhts", q_rope.float(), krope.float()))
    scores = scores / math.sqrt(dn + dr)
    if cache is None:
        mask = positions[:1, None, :, None] >= positions[:1, None, None, :]
        scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhts,bshk->bthk", w, v)
    out = out.reshape(b, t, h * dn) @ params["wo"].reshape(h * dn, d)
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


# ---------------------------------------------------------------------
# MoE: top-k routing, dropless (sort by expert, grouped products)
# ---------------------------------------------------------------------

def init_moe(gen, cfg, dtype=torch.float32):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": _norm(gen, (d, e)),            # float32, as the reference
        "wi": _norm(gen, (e, d, f), dtype=dtype),
        "wg": _norm(gen, (e, d, f), dtype=dtype),
        "wo": _norm(gen, (e, f, d), dtype=dtype),
    }


def _router(params, x, cfg):
    """(top_p [B,T,k] renormalised, top_e [B,T,k], aux) from float32
    router logits.  Ties go to the lower expert index, as
    `jax.lax.top_k` breaks them (a stable descending sort); aux is the
    Switch load-balancing loss E * sum(me * ce)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))
    flat = top_e.reshape(-1)
    ce = torch.zeros_like(me).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / flat.numel(),
                            device=flat.device))
    return top_p, top_e, e * torch.sum(me * ce)


def _segment_ends(counts) -> list:
    """The loop route's groups: each group's end row, read on the host."""
    return torch.cumsum(counts, 0).tolist()


def _segments_mm(x, w, ends):
    """The plain grouped product: rows of `x` [N, K] sorted by group, group
    i (rows `ends[i-1]:ends[i]`, one contiguous segment) times `w[i]`
    [K, M]."""
    starts = [0] + ends[:-1]
    return torch.cat([x[s:e] @ w[i] for i, (s, e) in
                      enumerate(zip(starts, ends))])


def _group_offsets(counts):
    """The grouped route's groups: the end rows as int32 on the device."""
    return torch.cumsum(counts, 0, dtype=torch.int32)


def _grouped_mm(x, w, offs):
    """The same product in one `torch._grouped_mm` call (no host read)."""
    return torch._grouped_mm(x, w, offs=offs)


# route -> (groups from the per-expert counts, grouped product)
MOE_ROUTES = {"loop": (_segment_ends, _segments_mm),
              "grouped": (_group_offsets, _grouped_mm)}


def moe_route(x) -> str:
    """The grouped product's route for `x`: bfloat16 on the card takes
    `torch._grouped_mm` (CUTLASS grouped GEMM on sm_90); every other
    device and dtype the per-expert loop.  Chosen by device and dtype,
    never by a failure."""
    return ("grouped" if x.device.type == "cuda" and
            x.dtype == torch.bfloat16 else "loop")


def moe_ragged(params, x, cfg, route=None):
    """Dropless top-k MoE (the reference's `moe_ragged`): the B*T*k
    (token, expert) pairs sorted by expert (stable), three grouped
    products, unsorted and combined weighted by `top_p` in x's dtype.
    The loop route reads the group ends on the host once per call.
    `route` ("loop" or "grouped") overrides `moe_route(x)`.  Returns
    (y [B,T,D], aux)."""
    b, t, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    groups_of, mm = MOE_ROUTES[route or moe_route(x)]
    top_p, top_e, aux = _router(params, x, cfg)
    xt = x.reshape(b * t, d)
    flat_e = top_e.reshape(-1)                         # [b*t*k]
    order = torch.argsort(flat_e, stable=True)
    xr = xt[order // k]                                # repeat, then sort
    groups = groups_of(torch.zeros(e, dtype=torch.int64, device=x.device)
                       .index_add_(0, flat_e, torch.ones_like(flat_e)))
    h = mm(xr, params["wi"], groups)
    g = mm(xr, params["wg"], groups)
    y = mm((F.silu(g) * h).to(x.dtype), params["wo"], groups)
    # unsort, weight, combine
    y = y[torch.argsort(order)].reshape(b * t, k, d)
    y = (y * top_p.reshape(b * t, k, 1).to(y.dtype)).sum(1)
    return y.reshape(b, t, d), aux
