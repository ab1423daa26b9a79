"""Model layers of the port: norm, rope, GQA attention (train / prefill /
decode, optional qk-norm and sliding window, cross attention), MLA with
its compressed cache, the SwiGLU MLP and the top-k MoE, dropless and
expert-parallel.

Each layer is a function of a parameter mapping (name -> tensor) with
the JAX package's names and layouts (`wq [d,h,hd]`, `wo [h,hd,d]`, ...),
so the products read as they do there.  Every `init_*` returns such a
mapping, drawn from a `torch.Generator` on the generator's device (or,
from `META`, shaped tensors on the meta device and nothing drawn), and
each has a table of the logical axes of its leaves (`*_AXES`, the
reference's `Boxed(..., axes)` annotations), which `models/sharding`
maps onto a mesh.  Logical axis vocabulary:
    "embed"  d_model        "mlp"     d_ff           "vocab"  vocabulary
    "heads"  q heads        "kv"      kv heads       "qkv"    per-head dim
    "experts" MoE experts   "layers"  stacked layers  None     replicated

The sharded bodies (`decode_attention_dist`, `moe_ep_local`,
`moe_ep_stationary`: the reference's `shard_map` bodies) take each
rank's local blocks and issue their collectives explicitly on the
mesh's process groups (`models/sharding`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as fops
from . import sharding as SH


class _Meta:
    """Stands in for a generator: `init_*` then returns tensors of the
    right shapes and dtypes on the meta device, drawing nothing."""
    device = torch.device("meta")


META = _Meta()


def _norm(gen, shape, scale=0.02, dtype=torch.float32):
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------

RMSNORM_AXES = {"w": ("embed",)}


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

ATTENTION_AXES = {
    "wq": ("embed", "heads", "qkv"), "wk": ("embed", "kv", "qkv"),
    "wv": ("embed", "kv", "qkv"), "wo": ("heads", "qkv", "embed"),
    "qnorm": (None,), "knorm": (None,)}


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


def _flash_shapes(tq, tk) -> bool:
    """The shapes `_sdpa` hands to the flash kernel."""
    return tq > 1 and tq % 128 == 0 and tk % 128 == 0


def _sdpa(q, k, v, mask, use_flash=False, window=None, causal=True,
          grouped=False):
    """q: [B,Tq,H,hd] k,v: [B,Tk,KV,hd]; mask [1,Tq,Tk] bool or None
    (every key valid).

    Default (head-sharded mode): KV heads are repeated to the q heads at
    use; the KV cache itself stays kv-sized.  grouped=True (sequence-
    parallel mode): the grouped [b, kv, g, q, s] layout, with no g-fold
    KV copy.  When `use_flash` is set and shapes allow, dispatches to the
    flash-attention kernel."""
    b, tq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if use_flash and _flash_shapes(tq, k.shape[1]):
        return fops.flash_attention(q, k, v, causal=causal, window=window)
    if grouped and g > 1:
        qg = q.reshape(b, tq, kvh, g, hd)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
        scores = scores / math.sqrt(hd)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
        return out.reshape(b, tq, h, hd)
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
              build_cache=False, ctx=None, seq=None):
    """Returns (out [B,T,D], new_cache).

    * training: cache=None, full sequence.
    * prefill: build_cache=True — returns the rope'd (k, v) (clipped to
      the sliding window for local layers) as the decode cache.
    * decode: x is [B,1,D]; cache = (k,v) with [B,S,KV,hd]; the new token
      is written into the cache ring at `cache_pos % S` **in place** (the
      reference returns an updated copy), then attends to all S entries.
      With `ctx`, the cache is this rank's block of a cache sharded over
      the model axis: along its kv heads (`sharding.kv_split`), decode
      runs on the rank's heads and sums the output projection over the
      axis; along its sequence, `decode_attention_dist`.
    * cross attention: cross_kv = (k, v) precomputed from the encoder:
      no rope, qk-norm on q only, every key valid, never the flash
      kernel, no cache written.
    * sequence parallel (`seq`, a `sharding.SeqShard`): x and positions
      are this rank's block of the sequence; k and v (and the key
      positions) are all-gathered, the scores keep the local queries.
      The flash kernel's causal mask starts q and k at 0, so with it the
      queries are gathered too and the output cut back to the block.
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
    kpositions = positions
    if seq is not None:
        k, v, kpositions = seq.gather(k), seq.gather(v), seq.gather(positions)

    new_cache = None
    if build_cache:
        w = window or k.shape[1]
        new_cache = (k[:, -w:], v[:, -w:])
    if cache is not None and ctx is not None and t == 1 \
            and cross_kv is None:
        if SH.kv_split(cfg, ctx):
            # kv-head-sharded cache: this rank's kv heads and the query
            # heads of their groups (the cache stays put, the output
            # projection's partial sums are reduced)
            ck, cv = cache
            kvl, m = ck.shape[2], ctx.mesh_shape[ctx.model_axis]
            g = h // k.shape[2]
            i = ctx.mesh.get_local_rank(ctx.model_axis)
            pos = cache_pos % ck.shape[1]
            ck[:, pos:pos + 1] = k[:, :, i * kvl:(i + 1) * kvl].to(ck.dtype)
            cv[:, pos:pos + 1] = v[:, :, i * kvl:(i + 1) * kvl].to(cv.dtype)
            hs = slice(i * kvl * g, (i + 1) * kvl * g)
            out = _sdpa(q[:, :, hs], ck, cv, None, grouped=cfg.seq_parallel)
            out = out.reshape(b, t, -1) @ params["wo"][hs].reshape(-1, d)
            if m > 1:
                SH.all_reduce(out, ctx.mesh, ctx.model_axis)
            return out, (ck, cv)
        # seq-sharded cache: distributed decode attention (the cache
        # stays put, the softmax statistics are reduced)
        out, new_cache = decode_attention_dist(params, q, k, v, cache,
                                               cache_pos, cfg, ctx)
        out = out.reshape(b, t, h * hd) @ params["wo"].reshape(h * hd, d)
        return out, new_cache
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
        kpos = kpositions[:1, None, :]
        if causal:
            mask = qpos >= kpos
            if window is not None:
                mask = mask & (qpos - kpos < window)
        else:
            mask = None

    causal = causal and cache is None
    if seq is not None and use_flash and _flash_shapes(k.shape[1],
                                                       k.shape[1]):
        out = seq.local(_sdpa(seq.gather(q), k, v, None, use_flash=True,
                              window=window, causal=causal))
    else:
        out = _sdpa(q, k, v, mask, use_flash=use_flash, window=window,
                    causal=causal, grouped=cfg.seq_parallel)
    out = out.reshape(b, t, h * hd) @ params["wo"].reshape(h * hd, d)
    return out, new_cache


def decode_attention_dist(params, q, k_new, v_new, cache, pos, cfg, ctx):
    """Distributed decode attention over a sequence-sharded KV cache (the
    reference's `shard_map` body, on this rank's blocks).

    When the kv heads do not tile the model axis, the cache is sharded
    along its sequence over "model".  The cache stays where it is: each
    model rank scores its slice, only the online-softmax statistics (a
    max-reduce of the scores' maximum, sum-reduces of the denominator
    and of the float32 output) cross the ranks, and the fresh token's k
    / v is written, in place, by the rank that owns its ring slot.

    q: [b,1,H,hd]; k_new/v_new: [b,1,KV,hd]; cache=(ck,cv) [b,S/m,KV,hd],
    all this rank's blocks (the batch as the activations lie).  `pos` is
    the token's absolute position (a host integer).  Returns (out
    [b,1,H,hd], (ck, cv)).
    """
    mesh, maxis = ctx.mesh, ctx.model_axis
    i = mesh.get_local_rank(maxis)
    m = ctx.mesh_shape[maxis]
    ck, cv = cache
    hd = q.shape[-1]
    s_loc = ck.shape[1]
    loc = pos % (s_loc * m)
    if loc // s_loc == i:                        # this rank owns the slot
        ck[:, loc % s_loc] = k_new[:, 0].to(ck.dtype)
        cv[:, loc % s_loc] = v_new[:, 0].to(cv.dtype)
    bq, _, h, _ = q.shape
    kvh = ck.shape[2]
    g = h // kvh
    qg = q.reshape(bq, 1, kvh, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                     ck.float()) / math.sqrt(hd)
    mx = SH.all_reduce(s.amax(dim=-1, keepdim=True), mesh, maxis, "max")
    p = torch.exp(s - mx)
    denom = SH.all_reduce(p.sum(dim=-1, keepdim=True), mesh, maxis)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype), cv)
    o = SH.all_reduce(o.float(), mesh, maxis)
    dn = denom[:, :, :, 0, 0]                    # [b, kv, g]
    o = (o / dn[:, None, :, :, None]).to(q.dtype)
    return o.reshape(bq, 1, h, hd), (ck, cv)


# ---------------------------------------------------------------------
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek style)
# ---------------------------------------------------------------------

MLA_AXES = {
    "wdq": ("embed", None), "wuq": (None, "heads", "qkv"),
    "wdkv": ("embed", None), "wukv": (None, "heads", "qkv"),
    "wkr": ("embed", None), "wo": ("heads", "qkv", "embed"),
    "qnorm": (None,), "kvnorm": (None,)}


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
                  build_cache=False, seq=None, ctx=None):
    """MLA with the compressed-KV cache (c_kv + one k_rope head shared by
    all heads): cache = (c_kv [B,S,kv_lora], k_rope [B,S,rope_dim]).

    Decode writes the new token's entries into the ring at
    `cache_pos % S` in place and attends to all S slots without a mask.
    The scores are the nope and rope products summed in float32, scaled
    by 1/sqrt(nope + rope) (not the head dim of `cfg.hd`), so MLA never
    goes through `_sdpa` or the flash kernel.  With `seq` (sequence
    parallel), x and positions are this rank's block of the sequence and
    the compressed cache entries are all-gathered, as `attention` does.
    With `ctx` (decode), the cache is this rank's block of a cache
    sequence-sharded over the model axis and stays put, as in
    `decode_attention_dist`: the rank that owns the ring slot writes it,
    and the softmax's max, denominator and float32 output are reduced
    over the axis."""
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
    kpositions = positions
    if seq is not None:
        ckv, krope = seq.gather(ckv), seq.gather(krope)
        kpositions = seq.gather(positions)

    new_cache = None
    if build_cache:
        new_cache = (ckv, krope)
    dist = cache is not None and ctx is not None and t == 1
    if cache is not None:
        c_ckv, c_kr = cache
        s_loc = c_ckv.shape[1]
        pos, own = cache_pos % s_loc, True
        if dist:
            m = ctx.mesh_shape[ctx.model_axis]
            loc = cache_pos % (s_loc * m)
            pos = loc % s_loc
            own = loc // s_loc == ctx.mesh.get_local_rank(ctx.model_axis)
        if own:
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
        mask = positions[:1, None, :, None] >= kpositions[:1, None, None, :]
        scores = scores.masked_fill(~mask, -1e30)
    if dist:
        mesh, maxis = ctx.mesh, ctx.model_axis
        mx = SH.all_reduce(scores.amax(dim=-1, keepdim=True), mesh, maxis,
                           "max")
        p = torch.exp(scores - mx)
        denom = SH.all_reduce(p.sum(dim=-1, keepdim=True), mesh, maxis)
        out = torch.einsum("bhts,bshk->bthk", p.to(x.dtype), v)
        out = SH.all_reduce(out.float(), mesh, maxis)
        out = (out / denom[:, :, :, 0, None].transpose(1, 2)).to(x.dtype)
    else:
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhts,bshk->bthk", w, v)
    out = out.reshape(b, t, h * dn) @ params["wo"].reshape(h * dn, d)
    return out, new_cache


# ---------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------

MLP_AXES = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
            "wo": ("mlp", "embed")}


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
# MoE: top-k routing.
#   * dropless: sort by expert, grouped products (`moe_ragged`)
#   * expert parallel: capacity-based selection per expert on each model
#     rank and a sum-reduce combine (`moe_ep_local`, `moe_ep_stationary`)
# ---------------------------------------------------------------------

MOE_AXES = {"router": ("embed", None), "wi": ("experts", "embed", "mlp"),
            "wg": ("experts", "embed", "mlp"),
            "wo": ("experts", "mlp", "embed")}

def init_moe(gen, cfg, dtype=torch.float32):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": _norm(gen, (d, e)),            # float32, as the reference
        "wi": _norm(gen, (e, d, f), dtype=dtype),
        "wg": _norm(gen, (e, d, f), dtype=dtype),
        "wo": _norm(gen, (e, f, d), dtype=dtype),
    }


def _route(params, x, cfg):
    """(top_p [B,T,k] renormalised, top_e [B,T,k], me [E], ce [E]) from
    float32 router logits.  Ties go to the lower expert index, as
    `jax.lax.top_k` breaks them (a stable descending sort); me is the
    mean router probability and ce the share of the (token, expert)
    pairs of each expert, the Switch load-balancing loss's factors."""
    k = cfg.top_k
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
    return top_p, top_e, me, ce


def _router(params, x, cfg):
    """(top_p, top_e, aux) with aux the Switch load-balancing loss
    E * sum(me * ce) (`_route`)."""
    top_p, top_e, me, ce = _route(params, x, cfg)
    return top_p, top_e, cfg.n_experts * torch.sum(me * ce)


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


def moe_capacity(tokens: int, cfg) -> int:
    """Tokens each expert takes in the expert-parallel paths, on the host
    as the reference computes it (Python's `round`, half to even), so the
    selection keeps a static shape."""
    return int(min(tokens, max(1, round(tokens * cfg.top_k *
                                        cfg.capacity_factor /
                                        cfg.n_experts))))


def _ep_experts(params, xt, pe, pp, cfg, e0: int, cap: int, dtype):
    """The per-expert loop of both expert-parallel bodies: for each local
    (virtual) expert `e0 + le`, the `cap` tokens with the largest gate
    weight (ties to the lower token index, as `jax.lax.top_k`; untouched
    tokens score -1), its SwiGLU on them, and the gated output summed in
    float32 into a [N, D] buffer."""
    s = cfg.moe_virtual_split
    outs = torch.zeros(xt.shape, dtype=torch.float32, device=xt.device)
    for le in range(params["wi"].shape[0]):
        eid = (e0 + le) // s                          # real expert id
        w = torch.where(pe == eid, pp, 0.0).sum(-1)   # [N] gate weight
        score = torch.where(w > 0, w, -1.0)
        sel = torch.sort(score, descending=True, stable=True)[1][:cap]
        xe = xt[sel]                                  # [cap, d]
        h = xe @ params["wi"][le]
        g = xe @ params["wg"][le]
        ye = (F.silu(g) * h).to(dtype) @ params["wo"][le]
        outs.index_add_(0, sel, ye.float() * w[sel][:, None])
    return outs


def moe_ep_local(params, x, cfg, mesh, axis_name, e_par, f_par,
                 stats_axes=()):
    """Expert parallelism over `axis_name` (the reference's `shard_map`
    body, on this rank's blocks).

    Each rank owns E_virt / e_par *virtual* experts (an expert split
    `moe_virtual_split` ways along d_ff when E < the model axis), params
    `wi`/`wg` [e_loc, D, F/s] and `wo` [e_loc, F/s, D] its block and the
    router whole; x [b, t, D] is this rank's batch, whole over the axis.
    Each expert takes `moe_capacity(b*t)` tokens (the rest are dropped),
    and a sum-reduce over the axis combines the experts' contributions
    and the d_ff partials.  The aux loss's factors are averaged over
    `stats_axes` (the mesh axes the batch is split over), so it is the
    whole batch's, as the unsharded model's.  Returns (y [b, t, D], aux).

    Differentiable (`sharding.full`'s rule): the sum over the axis passes
    its gradient through, and the tokens and gates entering the local
    experts are `fan_out`, so x's gradient is whole on every rank.  The
    caller takes the router and the expert blocks with their gradients
    summed over `stats_axes` (`make_moe_apply`).
    """
    b, t, d = x.shape
    e_loc = params["wi"].shape[0]
    cap = moe_capacity(b * t, cfg)
    top_p, top_e, me, ce = _route(params, x, cfg)
    if stats_axes:
        both = SH.all_reduce(torch.stack([me, ce]), mesh, stats_axes)
        me, ce = both / math.prod(SH.mesh_shape(mesh)[a]
                                  for a in stats_axes)
    aux = cfg.n_experts * torch.sum(me * ce)
    idx = mesh.get_local_rank(axis_name)
    my_e0 = (idx // f_par) * e_loc
    # the tokens and gates, the same on every rank of the axis, enter its
    # ranks' own experts: under autograd their gradients are summed there
    outs = _ep_experts(params, SH.fan_out(x.reshape(b * t, d), mesh,
                                          axis_name),
                       top_e.reshape(b * t, -1),
                       SH.fan_out(top_p.reshape(b * t, -1), mesh, axis_name),
                       cfg, my_e0, cap, x.dtype)
    outs = SH.all_reduce(outs, mesh, axis_name)
    return outs.reshape(b, t, d).to(x.dtype), aux


def moe_ep_stationary(params, x, cfg, ctx, batch=None):
    """Weight-stationary MoE for serving (few tokens, large experts).

    Experts shard over the model axis AND their d_ff over "data" (`wi`,
    `wg` (model, None, data), `wo` (model, data, None)); the token
    activations are all-gathered over "data", each rank computes its
    (expert, d_ff slice) contribution, and a sum-reduce over "model" and
    a reduce-scatter over "data" (a sum-reduce when the batch does not
    lie on "data") reassemble this rank's batch.  params: DTensors, or
    full tensors that every rank holds; x [b, t, D] this rank's batch
    block of a global batch of `batch` rows (default b).  Returns (y [b,
    t, D], aux).

    Differentiable (`sharding.full`'s rule): the gathered tokens are the
    same on every rank of "data", so each keeps its block of their
    gradient; the tokens and gates entering the (expert, d_ff slice) of
    each rank are `fan_out` over both axes; the router and the expert
    blocks' gradients are summed over the batch axes the tokens were not
    gathered over (the "pod" axis of a multi-pod mesh)."""
    mesh, maxis, daxis = ctx.mesh, ctx.model_axis, "data"
    bl, t, d = x.shape
    bspec = SH.batch_spec(ctx, bl if batch is None else batch, 3)
    batch_on_data = daxis in SH.entry_axes(bspec[0])
    split = tuple(a for a in SH.entry_axes(bspec[0]) if a != daxis)
    xg = SH.gather_dim(x, mesh, daxis, 0, same=True) if batch_on_data \
        else x
    bg = xg.shape[0]
    cap = moe_capacity(bg * t, cfg)
    lp = {"router": SH.full(params["router"], split)}
    for nm, spec in (("wi", (maxis, None, daxis)),
                     ("wg", (maxis, None, daxis)),
                     ("wo", (maxis, daxis, None))):
        lp[nm] = SH.to_local(params[nm], mesh, SH.Spec(spec), split)
    top_p, top_e, aux = _router(lp, xg, cfg)
    my_e0 = mesh.get_local_rank(maxis) * lp["wi"].shape[0]
    outs = _ep_experts(lp, SH.fan_out(xg.reshape(bg * t, d), mesh,
                                      (maxis, daxis)),
                       top_e.reshape(bg * t, -1),
                       SH.fan_out(top_p.reshape(bg * t, -1), mesh,
                                  (maxis, daxis)),
                       cfg, my_e0, cap, x.dtype)
    outs = SH.all_reduce(outs, mesh, maxis)
    if batch_on_data:
        outs = SH.reduce_scatter_dim(outs, mesh, daxis, 0)
    else:
        outs = SH.all_reduce(outs, mesh, daxis)
    return outs.reshape(bl, t, d).to(x.dtype), aux
