"""Mamba2 / SSD (state-space duality) blocks — arXiv:2405.21060.

The chunked, matmul-dominant SSD form: a within-chunk attention-like
term plus an inter-chunk state recurrence.  Used by `mamba2-1.3b` (pure
SSM) and `jamba-v0.1-52b` (hybrid).  The chunked core can be dispatched
to the SSD scan kernel (`kernels/ssd_scan`).  `MAMBA2_AXES` gives each
parameter's logical axes (the reference's `Boxed` annotations).

Decode keeps the recurrent state S [B, H, N, P] plus a depthwise-conv
cache; one step is O(H*P*N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ops as sops
from ..kernels.ssd_scan.ref import ssd_chunked_core
from .layers import _norm


MAMBA2_AXES = {
    "in_z": ("embed", "mlp"), "in_x": ("embed", "mlp"),
    "in_b": ("embed", None), "in_c": ("embed", None),
    "in_dt": ("embed", "heads"), "conv_w": (None, "mlp"), "conv_b": ("mlp",),
    "a_log": ("heads",), "d_skip": ("heads",), "dt_bias": ("heads",),
    "norm_w": ("mlp",), "out_proj": ("mlp", "embed")}


def init_mamba2(gen, cfg, dtype=torch.float32):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    h = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_in + 2 * n                     # x, B, C share the conv
    dev = gen.device
    return {
        "in_z": _norm(gen, (d, d_in), dtype=dtype),
        "in_x": _norm(gen, (d, d_in), dtype=dtype),
        "in_b": _norm(gen, (d, n), dtype=dtype),
        "in_c": _norm(gen, (d, n), dtype=dtype),
        "in_dt": _norm(gen, (d, h), dtype=dtype),
        "conv_w": _norm(gen, (cfg.ssm_conv, conv_dim), 0.2, dtype=dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)
                           ).to(dtype),
        "d_skip": torch.ones((h,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((h,), dtype=dtype, device=dev),
        "norm_w": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": _norm(gen, (d_in, d), dtype=dtype),
    }


def _gated_norm(y, z, w, eps=1e-6):
    y = y * F.silu(z.float())
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + eps)
    return y * w.float()


def mamba2_block(params, x, cfg, *, state=None, conv_cache=None,
                 use_kernel=False, build_cache=False):
    """Full Mamba2 block.

    * train/prefill: state=None — chunked SSD over the sequence.
    * decode: x [B,1,D]; state [B,H,N,P] and conv_cache [B,K-1,conv_dim]
      give the new state and cache (returned, the inputs are not changed).
    Returns (out, (new_state, new_conv_cache)).
    """
    bsz, t, d = x.shape
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    hp = cfg.ssm_head_dim
    h = d_in // hp
    kc = cfg.ssm_conv

    z = x @ params["in_z"]
    xin = x @ params["in_x"]
    bin_ = x @ params["in_b"]
    cin = x @ params["in_c"]
    dt = x @ params["in_dt"]
    xc = torch.cat([xin, bin_, cin], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())

    if state is None:
        # causal depthwise conv along T: shifted products summed in the
        # compute dtype, in the reference's order
        pad = F.pad(xc, (0, 0, kc - 1, 0))
        conv = sum(pad[:, i:i + t] * params["conv_w"][i][None, None, :]
                   for i in range(kc)) + params["conv_b"]
        conv = F.silu(conv)
        xs = conv[..., :d_in].reshape(bsz, t, h, hp)
        bm = conv[..., d_in:d_in + n]
        cm = conv[..., d_in + n:]
        if use_kernel and t % cfg.ssm_chunk == 0:
            # xs, bm and cm are views into conv; the kernel reads dense rows
            y, s_final = sops.ssd_scan(xs.contiguous(), dt, a,
                                       bm.contiguous(), cm.contiguous(),
                                       chunk=cfg.ssm_chunk)
        else:
            chunk = min(cfg.ssm_chunk, t)
            if t % chunk != 0:
                chunk = t
            y, s_final = ssd_chunked_core(xs, dt, a, bm, cm, chunk)
        if build_cache:
            pad_t = max(kc - 1 - t, 0)
            tail_xc = xc[:, max(t - (kc - 1), 0):]
            new_conv_cache = F.pad(tail_xc, (0, 0, pad_t, 0))
        else:
            new_conv_cache = None
    else:
        # single-token recurrence
        cc = torch.cat([conv_cache, xc], dim=1)           # [B,K,convdim]
        conv = (torch.einsum("bkc,kc->bc", cc, params["conv_w"])
                + params["conv_b"])[:, None, :]
        conv = F.silu(conv)
        xs = conv[..., :d_in].reshape(bsz, 1, h, hp)
        bm = conv[..., d_in:d_in + n]
        cm = conv[..., d_in + n:]
        da = torch.exp(dt[:, 0] * a[None, :])             # [B,H]
        s = state.float()
        upd = torch.einsum("bn,bhp,bh->bhnp", bm[:, 0].float(),
                           xs[:, 0].float(), dt[:, 0])
        s_final = s * da[:, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", cm[:, 0].float(),
                         s_final)[:, None]                # [B,1,H,P]
        new_conv_cache = cc[:, 1:]

    y = y + xs.float() * params["d_skip"].float()[None, None, :, None]
    y = y.reshape(bsz, t, d_in)
    y = _gated_norm(y, z, params["norm_w"]).to(x.dtype)
    out = y @ params["out_proj"]
    return out, (s_final, new_conv_cache)

