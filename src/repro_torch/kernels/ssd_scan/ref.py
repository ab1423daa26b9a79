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
    """
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    q = chunk
    nc = t // q
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
    # a select, never a product: exp(seg) above the diagonal may be inf
    l_mat = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), device=x.device))

    # within-chunk (quadratic in Q, matmul-dominant)
    cb = torch.einsum("bcqn,bckn->bcqk", cr.float(), br.float())
    xdt = xr * dtr[..., None]
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", cb[..., None] * l_mat,
                          xdt.float())

    # chunk summary states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j
    decay_tail = torch.exp(cum[:, :, -1:, :] - cum)     # [B,nc,Q,H]
    states = torch.einsum("bckn,bckhp->bchnp", br.float(),
                          (decay_tail * dtr)[..., None] * xr.float())
    chunk_decay = torch.exp(cum[:, :, -1, :])           # [B,nc,H]

    # inter-chunk recurrence (a loop over chunks)
    s = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_in = torch.stack(s_in, dim=1)                     # [B,nc,H,N,P]

    y_inter = torch.einsum("bcqn,bchnp->bcqhp", cr.float(), s_in)
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_diag + y_inter).reshape(bsz, t, h, p)
    return y.to(x.dtype), s


def ssd_ref(x, dt, a, b_mat, c_mat, chunk):
    return ssd_chunked_core(x, dt, a, b_mat, c_mat, chunk)


def ssd_naive(x, dt, a, b_mat, c_mat):
    """Per-token recurrence (the mathematical definition)."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    s = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        xt, dtt = x[:, i].float(), dt[:, i].float()
        bt, ct = b_mat[:, i].float(), c_mat[:, i].float()
        da = torch.exp(dtt * a[None, :])                 # [B,H]
        upd = torch.einsum("bn,bhp,bh->bhnp", bt, xt, dtt)
        s = s * da[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", ct, s))
    return torch.stack(ys, dim=1).to(x.dtype), s
