"""Plain PyTorch versions of the SSD scan kernel: the chunked core (the
kernel's oracle, also the model's path when the kernel is off) and the
per-token recurrence that defines it."""
from __future__ import annotations

import torch


def ssd_chunked_core(x, dt, a, b_mat, c_mat, chunk: int,
                     initial_state=None):
    """The SSD algorithm over chunks.

    x:  [B, T, H, P]  inputs (already conv'd / activated)
    dt: [B, T, H]     positive step sizes
    a:  [H]           negative decay rates
    b_mat, c_mat: [B, T, N]
    Returns (y [B,T,H,P] in x's dtype, final_state [B,H,N,P] float32).
    Float64 inputs are computed (and the state returned) in float64: a
    precision reference for the float32 paths.
    """
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    q = chunk
    nc = t // q
    wt = torch.float64 if x.dtype == torch.float64 else torch.float32
    if t % q:
        raise ValueError(f"T={t} must be a multiple of chunk={q}")

    xr = x.reshape(bsz, nc, q, h, p)
    dtr = dt.reshape(bsz, nc, q, h)
    br = b_mat.reshape(bsz, nc, q, n)
    cr = c_mat.reshape(bsz, nc, q, n)

    da = dtr * a[None, None, None, :]                   # [B,nc,Q,H] (<=0)
    cum = torch.cumsum(da, dim=2)                       # within chunk
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # exp(seg) above the diagonal may be inf: mask before the exp, never
    # after it (a product with 0 is NaN, and so is the gradient of a select
    # of inf), so exp(-inf) = 0 there and its gradient is 0 too
    l_mat = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))

    # within-chunk (quadratic in Q, matmul-dominant)
    cb = torch.einsum("bcqn,bckn->bcqk", cr.to(wt), br.to(wt))
    xdt = xr * dtr[..., None]
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", cb[..., None] * l_mat,
                          xdt.to(wt))

    # chunk summary states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j
    decay_tail = torch.exp(cum[:, :, -1:, :] - cum)     # [B,nc,Q,H]
    states = torch.einsum("bckn,bckhp->bchnp", br.to(wt),
                          (decay_tail * dtr)[..., None] * xr.to(wt))
    chunk_decay = torch.exp(cum[:, :, -1, :])           # [B,nc,H]

    # inter-chunk recurrence (a loop over chunks)
    s = (torch.zeros((bsz, h, n, p), dtype=wt, device=x.device)
         if initial_state is None else initial_state.to(wt))
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_in = torch.stack(s_in, dim=1)                     # [B,nc,H,N,P]

    y_inter = torch.einsum("bcqn,bchnp->bcqhp", cr.to(wt), s_in)
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_diag + y_inter).reshape(bsz, t, h, p)
    return y.to(x.dtype), s


def ssd_ref(x, dt, a, b_mat, c_mat, chunk):
    return ssd_chunked_core(x, dt, a, b_mat, c_mat, chunk)


def ssd_naive(x, dt, a, b_mat, c_mat):
    """Per-token recurrence (the mathematical definition), in float32, or
    in float64 for float64 inputs."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    wt = torch.float64 if x.dtype == torch.float64 else torch.float32
    s = torch.zeros((bsz, h, n, p), dtype=wt, device=x.device)
    ys = []
    for i in range(t):
        xt, dtt = x[:, i].to(wt), dt[:, i].to(wt)
        bt, ct = b_mat[:, i].to(wt), c_mat[:, i].to(wt)
        da = torch.exp(dtt * a[None, :])                 # [B,H]
        upd = torch.einsum("bn,bhp,bh->bhnp", bt, xt, dtt)
        s = s * da[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", ct, s))
    return torch.stack(ys, dim=1).to(x.dtype), s


def ssd_decomposed(x, dt, a, b_mat, c_mat, chunk: int, *, tile: int = 64):
    """The SSD scan pass for pass as `csrc/ssd_scan_bf16.cu` computes it:
    chunk cumsum; C Bᵀ once per (batch, chunk); the chunks' states passed
    in order, S = exp(cum_last) S + Bᵀ W; and the output per 64-row q
    tile with m = cum at its first row,
        y = exp(cum_q - m) [exp(m) C S_in + (C Bᵀ)(exp(m - cum_k) dt x)]
            + (C Bᵀ ∘ L)(dt x),
    the first sum over the k tiles below the q tile, the second over its
    diagonal tile, L = exp(cum_q - cum_k) only where k <= q (a select).
    The kernel's products take bf16 C and B (exact) and split every f32
    operand into two TF32 values, about 21 bits per product: float32
    here.
    Returns (y in x's dtype, final state float32)."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    q = chunk
    nc = t // q
    if t % q:
        raise ValueError(f"T={t} must be a multiple of chunk={q}")
    xr = x.reshape(bsz, nc, q, h, p).float()
    dtr = dt.reshape(bsz, nc, q, h)
    br = b_mat.reshape(bsz, nc, q, n)
    cr = c_mat.reshape(bsz, nc, q, n)
    br, cr = br.float(), cr.float()

    # 1. cumsum of dt * a per (b, chunk, head)
    cum = torch.cumsum(dtr * a[None, None, None, :], dim=2)   # [B,nc,Q,H]
    # 2. C Bᵀ once per (b, chunk)
    cb = torch.einsum("bcqn,bckn->bcqk", cr, br)
    # 3. the chunks in order: S_in(c) = S, S = exp(cum_last) S + Bᵀ W
    last = cum[:, :, -1:, :]
    w = (torch.exp(last - cum) * dtr)[..., None] * xr
    s = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(last[:, c, 0])[:, :, None, None] + torch.einsum(
            "bkn,bkhp->bhnp", br[:, c], w[:, c])
    s_in = torch.stack(s_in, dim=1)                          # [B,nc,H,N,P]
    # 4. the output, one q tile at a time
    dtx = dtr[..., None] * xr                                # [B,nc,Q,H,P]
    ys = []
    for q0 in range(0, q, tile):
        q1 = min(q0 + tile, q)
        m = cum[:, :, q0:q0 + 1, :]                          # [B,nc,1,H]
        cq = cum[:, :, q0:q1, :]
        yt = torch.einsum("bcqn,bchnp->bcqhp", cr[:, :, q0:q1], s_in) * \
            torch.exp(m)[..., None]
        if q0:
            below = torch.exp(m - cum[:, :, :q0])[..., None] * dtx[:, :, :q0]
            yt = yt + torch.einsum("bcqk,bckhp->bcqhp",
                                   cb[:, :, q0:q1, :q0], below)
        yt = yt * torch.exp(cq - m)[..., None]
        qp = torch.arange(q0, q1, device=x.device)[:, None]
        keep = (torch.arange(q0, q1, device=x.device)[None, :] <= qp)
        keep = keep[None, None, :, :, None]                  # [1,1,q,k,1]
        seg = cq[:, :, :, None, :] - cum[:, :, None, q0:q1, :]
        g = torch.where(keep, cb[:, :, q0:q1, q0:q1, None] *
                        torch.exp(torch.where(keep, seg, 0.0)),
                        torch.zeros((), device=x.device))
        yt = yt + torch.einsum("bcqkh,bckhp->bcqhp", g, dtx[:, :, q0:q1])
        ys.append(yt)
    y = torch.cat(ys, dim=2)
    return y.reshape(bsz, t, h, p).to(x.dtype), s
