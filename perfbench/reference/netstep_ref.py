"""Plain PyTorch version of the `netstep` switch allocator.

Same arithmetic as `repro.core.simulator._alloc_jnp` (the oracle of the
TPU kernel), with the batch written out: the JAX package vmaps one
router grid over (spec, rate), the port carries a leading row axis B
and one rotating-priority pair (rr_vc, rr_port) per row.  It is the CPU
path of `ops.netstep`, the simulator's `alloc="torch"`, and the version
the CUDA kernel is held against bit for bit on the card.

`netstep_lanes` computes the same allocation lane by lane, as the CUDA
kernel's warps do; the CPU tests hold it against `netstep_ref`, and
nothing else calls it.
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
    # one-hot of the chosen VC by comparison: `one_hot` checks its range
    # with a device-to-host read every call (runner_hazards, JX004)
    win_mask = ((vc_choice.unsqueeze(3) == vcs) & eligible
                & port_wins.unsqueeze(3))
    return win_mask, vc_choice, out_req.to(torch.int32)


def _ffs(x: torch.Tensor) -> torch.Tensor:
    """CUDA's __ffs on int64 lane masks below 2^32: the 1-based index of
    the least set bit, 0 for 0."""
    low = x & -x
    return torch.where(x != 0, torch.log2(low.double()).long() + 1, 0)


def netstep_lanes(op_slot: torch.Tensor, eligible: torch.Tensor,
                  rr_vc: torch.Tensor, rr_port: torch.Tensor):
    """The allocation computed the way the CUDA kernel computes it, lane by
    lane, in plain torch: a rehearsal of `csrc/netstep.cu`'s warp layout
    for the CPU tests.  Same arguments and results as `netstep_ref`.

    R = 32 // PI routers share a warp of 32 lanes; lane l < R * PI takes
    router slot l // PI and port l % PI of router warp * R + l // PI, whose
    row gives the lane its rr pair.  The other lanes, and those past the
    last router, request nothing and take keys of their own.  Phase b
    groups lanes by the key slot * 32 + out slot (`__match_any_sync`),
    shifts the group's lane mask down to the router's first lane, and
    grants the first rival port at or after rr_port mod PI, else the first
    rival port (shifts and `__ffs`).
    """
    B, N, PI, V = op_slot.shape
    dev = op_slot.device
    per_warp = 32 // PI
    n_routers = B * N
    warps = -(-n_routers // per_warp)
    lane = torch.arange(32, device=dev)
    slot, port = lane // PI, lane % PI
    router = torch.arange(warps, device=dev).view(-1, 1) * per_warp + slot
    active = (slot < per_warp) & (router < n_routers)         # [W, 32]
    p = torch.where(active, router * PI + port, 0)
    row = torch.where(active, router // N, 0)
    rv = rr_vc.long()[row]
    rp = rr_port.long()[row]
    slots = op_slot.reshape(-1, V)[p]                           # [W, 32, V]
    el = eligible.reshape(-1, V)[p] & active.unsqueeze(2)

    # phase a: the kernel's scan over the VCs, strict < on the score
    best = torch.full_like(p, V)
    choice = torch.zeros_like(p)
    req = torch.full_like(p, -1)
    for c in range(V):
        s = (c - rv) % V
        take = el[..., c] & (s < best)
        best = torch.where(take, s, best)
        choice = torch.where(take, c, choice)
        req = torch.where(take, slots[..., c].long(), req)
    found = best < V

    # phase b: match by key, then the first rival at or after rr_port
    requests = found & (req >= 0) & (req < PI)
    key = torch.where(requests, slot * 32 + req, 1024 + lane)
    same = key.unsqueeze(2) == key.unsqueeze(1)                 # [W, 32, 32]
    group = (same.long() << lane).sum(2)                        # lane masks
    rivals = group >> (lane - port)
    rpm = rp % PI
    after = rivals >> rpm
    first = torch.where(after != 0, rpm + _ffs(after) - 1, _ffs(rivals) - 1)
    wins = requests & (first == port)

    n_ports = n_routers * PI
    win = torch.zeros((n_ports, V), dtype=torch.bool, device=dev)
    vc = torch.zeros(n_ports, dtype=torch.int32, device=dev)
    out_req = torch.zeros(n_ports, dtype=torch.int32, device=dev)
    at = p[active]
    win[at] = (torch.nn.functional.one_hot(choice[active], V).bool()
               & wins[active].unsqueeze(1))
    vc[at] = choice[active].to(torch.int32)
    out_req[at] = req[active].to(torch.int32)
    return (win.view(B, N, PI, V), vc.view(B, N, PI),
            out_req.view(B, N, PI))
