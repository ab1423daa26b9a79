"""Plain PyTorch version of the `netstep` switch allocator.

Same arithmetic as `repro.core.simulator._alloc_jnp` (the oracle of the
TPU kernel), with the batch written out: the JAX package vmaps one
router grid over (spec, rate), the port carries a leading row axis B
and one rotating-priority pair (rr_vc, rr_port) per row.  It is the CPU
path of `ops.netstep`, the simulator's `alloc="torch"`, and the version
the CUDA kernel is held against bit for bit on the card.
"""
from __future__ import annotations

import torch

INF = 2 ** 30


def netstep_ref(op_slot: torch.Tensor, eligible: torch.Tensor,
                rr_vc: torch.Tensor, rr_port: torch.Tensor):
    """Two-phase separable allocation.

    op_slot [B, N, PI, V] int32 (requested out slot, negative: none),
    eligible [B, N, PI, V] bool, rr_vc / rr_port [B] int32.  Returns
    (win_mask [B, N, PI, V] bool, vc_choice [B, N, PI] int32,
    out_req [B, N, PI] int32 in [0, PI) or -1).
    """
    B, N, PI, V = op_slot.shape
    dev = op_slot.device
    rr_vc = rr_vc.view(B, 1, 1, 1)
    rr_port = rr_port.view(B, 1)

    # phase a: each input port picks one eligible VC (rotating priority);
    # torch's % is floor-mod like jnp's.  Eligible scores are distinct,
    # so only an all-INF port ties, and it picks VC 0 as jnp.argmin does
    vcs = torch.arange(V, device=dev, dtype=torch.int32)
    vc_score = torch.where(eligible, (vcs - rr_vc) % V, INF)
    best, vc_choice = vc_score.min(dim=3)
    port_ok = best < INF
    vc_choice = torch.where(port_ok, vc_choice, 0).to(torch.int32)
    out_req = torch.where(
        port_ok,
        torch.gather(op_slot, 3, vc_choice.long().unsqueeze(3)).squeeze(3),
        -1)                                          # [B, N, PI]

    # phase b: each output slot picks one requesting input port; a
    # request outside [0, PI) names no slot (the reference's one_hot
    # drops it)
    ports = torch.arange(PI, device=dev, dtype=torch.int32)
    p_score = (ports - rr_port) % PI                 # [B, PI]
    req_1h = out_req.unsqueeze(3) == ports           # [B, N, in, out]
    scores = torch.where(req_1h, p_score.view(B, 1, PI, 1), INF)
    m, win_p = scores.min(dim=2)                     # [B, N, out]
    win_ok = m < INF
    port_wins = ((win_p.unsqueeze(2) == ports.view(PI, 1))
                 & win_ok.unsqueeze(2)).any(dim=3) & port_ok
    win_mask = (torch.nn.functional.one_hot(vc_choice.long(), V).bool()
                & eligible & port_wins.unsqueeze(3))
    return win_mask, vc_choice, out_req.to(torch.int32)
