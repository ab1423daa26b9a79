"""Plain PyTorch version of the fused cycle kernels (`csrc/cycle.cu`).

`cycle_route` (§1-§4) and `cycle_move` (§5) compute, on the state the
kernels keep (int32, `core.simulator._FUSED_STATE`), what the PyTorch
body (`core.simulator._torch_body`) computes on its own state, bit for
bit: each input port pulls the flit of its upstream channel and each
output port the credits of its channel, as the kernels' lanes do, where
the body scatters from the channels.  `draw_ref` is the destination draw as the body counts it.
These are the CPU path of `ops.cycle_route` / `ops.cycle_move`, which no
run takes by itself (`core.simulator._fused` holds only on the card):
they exist so that the CPU tests can run the fused path's arguments
(`_fused_args`), body and chunk loop without a card, against the PyTorch
body.  On the card the kernels are held against the PyTorch body (the
card tests, `chip_smoke.py`), and `chip_smoke.py` also holds them
against these, cycle by cycle, at the main path's shape and times these
as their plain version.  They read the cycle back to the host, so unlike
the kernels they cannot be graphed.
"""
from __future__ import annotations

import torch

EJECT = -2        # core.routing.Routing.EJECT
BITS_CHUNK = 256  # core.simulator._BITS_CHUNK
LAT_HIST_BINS = 16  # core.simulator.LAT_HIST_BINS


def draw_ref(cum: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """cum [..., N] float32, u [...] float32 -> int32 [...]: the count of
    entries of each row below u, at most N - 1."""
    n = cum.shape[-1]
    return (cum < u.unsqueeze(-1)).sum(-1).clamp(0, n - 1).to(torch.int32)


def _dims(a: dict):
    B, N, PI, V, Bd = a["buf_dst"].shape
    _, C, D = a["link_dst"].shape
    return B, N, PI - 1, PI, V, Bd, C, D


def _grid(B, N, P, dev):
    return (torch.arange(B, device=dev).view(B, 1, 1),
            torch.arange(N, device=dev).view(1, N, 1),
            torch.arange(P, device=dev).view(1, 1, P))


def _window(a: dict, T: int) -> int:
    """The recorder's window of measured cycle T: ((T - warmup) * W) //
    meas, clamped to [0, W - 1]; 0 without windows."""
    w = a["windows"]
    if not w:
        return 0
    return min(max((T - a["warmup"]) * w // a["meas"], 0), w - 1)


def _add(x: torch.Tensor, index: torch.Tensor, n=None) -> None:
    """x.view(-1)[index] += n (1 where not given), duplicate indices each
    adding."""
    src = torch.ones(index.shape, dtype=x.dtype, device=x.device) \
        if n is None else n.to(x.dtype)
    x.view(-1).index_add_(0, index.reshape(-1), src.reshape(-1))


def cycle_route_ref(a: dict, measuring: bool) -> None:
    """§1-§4 of cycle `a["t"]` on the state of `a`, in place: deliveries,
    credit returns, injection (and, measuring, the offered and accepted
    counters), then the allocator's arguments `op_slot`, `eligible`,
    `rr_vc`, `rr_port` and, adaptive, `dvc`.  With the recorder,
    measuring adds each channel's occupancy, each node's injections and
    each channel's credit-starved head flits."""
    B, N, P, PI, V, Bd, C, D = _dims(a)
    dev = a["cnt"].device
    T = int(a["t"][0])
    slot, k = T % D, T % BITS_CHUNK
    record = measuring and a["tel_busy"] is not None
    w = _window(a, T) if record else 0
    head, cnt = a["head"].view(-1), a["cnt"].view(-1)
    buf_dst, buf_t = a["buf_dst"].view(-1), a["buf_t"].view(-1)
    b, node, port = _grid(B, N, P, dev)

    # §1: every in-port pulls slot t % D of its upstream channel
    uc = a["up_ch"].long()
    li = (b * C + uc.clamp(min=0)) * D + slot                # [B, N, P]
    dst = a["link_dst"].view(-1)[li]
    arr = (uc >= 0) & (dst >= 0)
    q = (((b * N + node) * PI + port) * V
         + a["link_vc"].view(-1)[li].long())[arr]
    li = li[arr]
    pos = (head[q] + cnt[q]) % Bd
    buf_dst[q * Bd + pos] = dst[arr]
    buf_t[q * Bd + pos] = a["link_t"].view(-1)[li]
    cnt[q] += 1
    a["link_dst"].view(-1)[li] = -1
    if record:
        # the occupancy snapshot (post-arrival, pre-pop): each in-port
        # adds its VCs' counts under its upstream channel
        up = uc >= 0
        occ = ((w * B + b.expand(B, N, P)[up]) * (C + 1) + uc[up]) * V
        _add(a["tel_occ"], occ.unsqueeze(1) + torch.arange(V, device=dev),
             a["cnt"][:, :, :P][up])

    # §2: every out-port pulls the credits at slot t % D of its channel
    oc = a["out_ch"].long()
    real = (oc >= 0).unsqueeze(3)
    pipe = a["credit_pipe"].view(-1, V)
    ci = (b * C + oc.clamp(min=0)) * D + slot                # [B, N, P]
    a["credits"] += torch.where(real, pipe[ci], 0)
    pipe[ci[real.squeeze(3)]] = 0

    # §3: injection at port P
    u = a["u_inj"][k]                                        # [N]
    if a["rate_t"] is None:
        s = a["srow"].long()
        rate = a["rate"]
    else:
        s = a["kidx_row"][T]
        rate = a["rate_t"][T]
    want = u < rate.view(B, 1) * a["inj_w"][s]               # [B, N]
    dsts = draw_ref(a["cum"][s], a["u_dst"][k].view(1, N))   # [B, N]
    want &= dsts != torch.arange(N, device=dev)
    qi = ((b.view(B, 1) * N + node.view(1, N)) * PI + P) * V + a["vcs"][k]
    inj = want & (cnt[qi] < Bd)
    qi, dsts = qi[inj], dsts[inj]
    pos = (head[qi] + cnt[qi]) % Bd
    buf_dst[qi * Bd + pos] = dsts
    buf_t[qi * Bd + pos] = T
    cnt[qi] += 1
    if record:
        a["tel_inj"][w] += inj.int()
    if measuring:
        i32 = torch.int32
        n_want, n_inj = want.sum(1, dtype=i32), inj.sum(1, dtype=i32)
        a["offered"] += n_want
        a["accepted"] += n_inj
        if a["rate_t"] is not None:
            bk = a["bk"][T]
            a["offered_ph"].index_add_(0, bk, n_want)
            a["accepted_ph"].index_add_(0, bk, n_inj)

    # §4: each VC's head flit against the table and its credit
    c4 = a["cnt"]
    valid = c4 > 0
    hd = a["buf_dst"].gather(4, a["head"].long().unsqueeze(4)).squeeze(4)
    s4, b4 = a["srow"].long().view(B, 1, 1, 1), b.view(B, 1, 1, 1)
    dst4, node4 = torch.where(valid, hd, 0).long(), node.view(1, N, 1, 1)
    op = a["table"][s4, dst4, node4,
                    torch.arange(PI, device=dev).view(1, 1, PI, 1)].int()
    op = torch.where(valid, op, -3)
    is_eject = op == EJECT
    op_slot = torch.where(is_eject, P, op)
    credits = a["credits"]
    if a["prod"] is None:
        credit = credits[b4, node4, op_slot.clamp(0, P - 1).long(),
                         torch.arange(V, device=dev).view(1, 1, 1, V)] > 0
        eligible = valid & (op_slot >= 0) & (credit | is_eject)
        starved = valid & (op_slot >= 0) & ~is_eject & ~credit
    else:
        # adaptive (DESIGN.md §15): VC 0 escapes on the table; VCs >= 1
        # take the productive port with the most adaptive credit (the
        # first on ties) where one has any
        esc = op_slot
        esc_credit = credits[b4, node4, esc.clamp(0, P - 1).long(), 0] > 0
        bits = a["prod"][s4, dst4, node4]                    # [B, N, PI, V]
        cand = (bits.unsqueeze(4) >> torch.arange(P, device=dev)) & 1 > 0
        cred_ad = credits[..., 1:].sum(3).view(B, N, 1, 1, P)
        best, ad_port = torch.where(cand & (cred_ad > 0), cred_ad,
                                    -1).max(4)
        ad_vc = 1 + credits[b4, node4, ad_port, 1:].argmax(4)
        use_ad = valid & ~is_eject & (best > 0)
        op_slot = torch.where(use_ad, ad_port.int(), esc)
        eligible = valid & (op_slot >= 0) & \
            (use_ad | is_eject | ((esc >= 0) & esc_credit))
        starved = valid & ~is_eject & (esc >= 0) & ~eligible
        a["dvc"].copy_(torch.where(use_ad, ad_vc, 0))
    if record:
        # credit starvation, charged to the requested out channel
        st = a["out_ch"].long()[b4, node4, op_slot.clamp(0, P - 1).long()]
        st = st.expand(B, N, PI, V)[starved]
        st_b = b4.expand(B, N, PI, V)[starved]
        go = st >= 0
        _add(a["tel_stall"], (w * B + st_b[go]) * (C + 1) + st[go])
    a["op_slot"].copy_(op_slot)
    a["eligible"].copy_(eligible)
    a["rr_vc"].copy_(a["rr"] % V)
    a["rr_port"].copy_(a["rr"] % a["pi"])


def cycle_move_ref(a: dict, win: torch.Tensor, vc: torch.Tensor,
                   req: torch.Tensor, measuring: bool) -> None:
    """§5 of cycle `a["t"]` given the allocation (win [B, N, PI, V] bool,
    vc / req [B, N, PI] int32), in place: pops, upstream credits,
    ejections (and, measuring, the delivered and latency counters),
    traversals to the downstream VC (`dvc` of the winner, adaptive; its
    own VC, static), the rotating priority, then the cycle's advance.
    With the recorder, measuring adds each traversal to its channel, each
    ejection to its node and its latency bin."""
    B, N, P, PI, V, Bd, C, D = _dims(a)
    dev = a["cnt"].device
    T = int(a["t"][0])
    record = measuring and a["tel_busy"] is not None
    w = _window(a, T) if record else 0
    head, cnt = a["head"].view(-1), a["cnt"].view(-1)
    b, node, port = _grid(B, N, PI, dev)
    wins = win.any(3)
    b, n, p = (x.expand(B, N, PI)[wins] for x in (b, node, port))
    wvc, rq = vc.long()[wins], req.long()[wins]

    # pop the winning VC's head flit
    q = ((b * N + n) * PI + p) * V + wvc
    h = head[q].long()
    w_dst = a["buf_dst"].view(-1)[q * Bd + h]
    w_t = a["buf_t"].view(-1)[q * Bd + h]
    head[q] = ((h + 1) % Bd).int()
    cnt[q] -= 1

    # the freed slot's credit, back up the channel it came in on
    bnp = (b * N + n) * P + p.clamp(max=P - 1)
    uc = a["up_ch"].view(-1)[bnp].long()
    up = (p < P) & (uc >= 0)
    ret = (b * C + uc) * D + (a["up_delay"].view(-1)[bnp] + T) % D
    a["credit_pipe"].view(-1).index_add_(
        0, (ret * V + wvc)[up], torch.ones_like(wvc[up], dtype=torch.int32))

    eject = rq == P
    if measuring:
        i32 = torch.int32
        lat = (T - w_t)[eject]
        ones = torch.ones_like(lat)
        a["delivered"].index_add_(0, b[eject], ones)
        a["lat_node"].view(-1).index_add_(0, (b * N + n)[eject], lat)
        if a["rate_t"] is not None:
            bk = a["bk"][T][b[eject]]
            a["delivered_ph"].index_add_(0, bk, ones.to(i32))
            a["lat_ph"].view(-1).index_add_(0, bk * N + n[eject], lat)
        if record:
            _add(a["tel_eject"], (w * B + b[eject]) * N + n[eject])
            edges = 2 ** torch.arange(LAT_HIST_BINS - 1, device=dev)
            _add(a["tel_hist"], b[eject] * LAT_HIST_BINS
                 + torch.bucketize(lat.long(), edges, right=True))

    trav = (rq >= 0) & (rq < P)
    bo = (b * N + n) * P + rq.clamp(0, P - 1)
    oc = a["out_ch"].view(-1)[bo].long()
    go = trav & (oc >= 0)
    li = ((b * C + oc) * D + (a["out_delay"].view(-1)[bo] + T) % D)[go]
    dvc = wvc if a["dvc"] is None else a["dvc"].view(-1)[q].long()
    a["link_dst"].view(-1)[li] = w_dst[go]
    a["link_t"].view(-1)[li] = w_t[go]
    a["link_vc"].view(-1)[li] = dvc[go].int()
    a["credits"].view(-1)[(bo * V + dvc)[trav]] -= 1
    if record:
        _add(a["tel_busy"], ((w * B + b) * (C + 1) + oc)[go])

    a["rr"].copy_((a["rr"] + 1) % (V * a["pi"]))
    a["t"] += 1
