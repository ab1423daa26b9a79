"""Cycle-based ICI network simulator in PyTorch (paper §V-B).

The port of `repro.core.simulator`: the same BookSim semantics and the
same counters, bit for bit —

  * input-queued routers, V virtual channels x B-flit buffers per input
    port (paper: 4 x 4),
  * credit-based flow control with wire-delayed credit return,
  * two-phase separable switch allocation (rotating priority; an input
    port forwards at most one flit per cycle, an output port accepts at
    most one) — the `netstep` kernel,
  * per-channel link pipelines whose depth is the Table-IV hop latency,
  * one injection queue and one ejection port per chiplet.

Where the JAX package `vmap`s one router grid over specs x rates and
`lax.scan`s over cycles, the port carries an explicit leading row axis
B = S*R (row b simulates spec `b // R` at rate `b % R`, every spec leaf
gathered by the row's spec index) and steps one cycle body over the
cycles.  The body reads the cycle from a device counter and updates all
state in place, so on a CUDA device each body (warm-up, measured) runs
once eagerly, is captured as a CUDA graph, and every later cycle is one
graph launch; on the CPU and under an op trace (`trace_batch`) the same
body runs eagerly every cycle.  The loop makes no host
synchronisation: no `.item()`, no branch on a tensor — only on the
host's copy of the cycle counter.

Two bodies compute a cycle, bit for bit alike.  Every run on the card
with the `netstep` kernel (`_fused`) runs the fused one, in every mode:
two hand-written kernels (`kernels.cycle`: §1-§4 deliveries, credit
returns, injection and the static or adaptive route lookup; §5 pops,
credits, ejections, traversals, the counters and the flight recorder's)
around `netstep`, three launches a cycle on int32 state.  The PyTorch
body, 166-236 stock ops a cycle, serves the CPU, `alloc="torch"` and
op traces; it is also the fused body's oracle in the card tests.

Padding invariance rests on the reference's three ingredients, kept
as they are: a counter-based hash of (seed, cycle, node, stream) for
injection randomness; scatters that are unique, pure integer adds
(`index_add_` on the flattened state: the accumulating `index_put_`
reads its indices' range back to the host on the card, a wait every
call), or routed to a *sacrificial* row
or slot (buffer slot B, channel row C) that is never read back; and
the rotating-priority counter advancing modulo the spec's own
V*(P_spec+1).

Phase schedules (time-varying workloads, DESIGN.md §9) follow the
reference's phase pointer: `t_eff = t % total`, phase = #{ends <=
t_eff}, ON window `(t_eff - start) % period < on`.  These depend only
on the schedule and the cycle, never on the rate row, so the runner
computes them once per run on the host as tables over [cycles, rows]
(the phase, the effective rate `rate * gain` in float32, the flat
phase index) and each cycle only indexes them with `t`.

All three modes of the reference run here: static up*/down* routing,
minimal-adaptive routing with escape VCs (`routing="adaptive"`,
DESIGN.md §15), and the flight recorder (`telemetry=True`, aggregate and
binned into `telemetry_windows` time windows, DESIGN.md §13, §16).  The
defaults (`routing="static"`, `telemetry=False`) issue no op of either
mode; the measuring gate chooses the body (the graph), and the
recorder's window index is computed on the device from the cycle.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.cycle.ops import cycle_move, cycle_route
from ..kernels.netstep.ops import netstep
from ..kernels.netstep.ref import netstep_ref
from ..obs.metrics import metrics
from ..obs.profile import profiling_enabled
from ..obs.trace import trace as _span, tracing_enabled
from . import linkmodel as lm
from .routing import Routing, productive_ports

INF = 2 ** 30
_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_MIX_T = 0x85EBCA6B
_MIX_N = 0xC2B2AE3D

#: cycles of injection randomness drawn per device call (a chunk of the
#: hash table [cycles, N] is made at once, outside the per-cycle work);
#: also the cycles of one `sim.cycles` span
_BITS_CHUNK = 256

#: flight-recorder latency-histogram bins: bin h counts ejections with
#: latency in [2^(h-1), 2^h) cycles (bin 0 stays 0: latency < 1 is
#: impossible; the last bin is open-ended)
LAT_HIST_BINS = 16

#: per-spec result keys added by `SimConfig(telemetry=True)`; every one
#: has a leading rate axis R (DESIGN.md §13).  `link_occ_escape` /
#: `link_occ_adaptive` split the per-VC occupancy sums into the escape
#: class (VC 0) and the adaptive class (VCs 1..V-1), on the host.
TELEMETRY_KEYS = ("link_busy", "link_stall", "link_occ_sum", "link_util",
                  "link_occ_escape", "link_occ_adaptive",
                  "inj_node", "eject_node", "lat_hist")

#: additional per-spec result keys when `SimConfig(telemetry_windows=W)`
#: bins the flight recorder over time (DESIGN.md §16): each counter gains
#: a window axis W after the rate axis and sums over W to its aggregate
#: exactly; `window_cycles` [W] is the host-side normalizer.
TELEMETRY_WINDOW_KEYS = ("link_busy_w", "link_stall_w", "link_occ_w",
                         "link_util_w", "inj_node_w", "eject_node_w",
                         "window_cycles")

#: rate-grid headroom above the static analytic bound (DESIGN.md §15)
STATIC_HEADROOM = 2.0
ADAPTIVE_HEADROOM = 3.0


class SimConfig(NamedTuple):
    n_vcs: int = 4
    buf_depth: int = 4
    cycles: int = 3000
    warmup: int = 1000
    seed: int = 0
    alloc: str = "auto"     # "auto" | "torch" | "cuda"
    telemetry: bool = False  # flight recorder (DESIGN.md §13)
    routing: str = "static"  # "static" | "adaptive" (DESIGN.md §15)
    telemetry_windows: int = 0  # W > 0 bins the recorder into W windows
    #                             of the measured cycles (DESIGN.md §16);
    #                             needs telemetry=True


@dataclasses.dataclass
class SimSpec:
    """Static simulator inputs derived from a Routing + traffic matrix."""
    n: int
    p: int                  # max real ports
    c: int                  # directed channels
    d: int                  # link pipeline ring depth
    table: np.ndarray       # [N_dst, N, P+1] -> out port, EJECT=-2
    out_ch: np.ndarray      # [N, P]
    in_ch: np.ndarray       # [N, P]
    ch_dst: np.ndarray      # [C]
    ch_in_port: np.ndarray  # [C]
    ch_src: np.ndarray
    ch_out_port: np.ndarray
    ch_depth: np.ndarray    # [C] pipeline depth (cycles per hop)
    traffic_cum: np.ndarray  # [N, N] cumulative traffic rows
    inj_weight: np.ndarray   # [N] relative injection rate per node
    # productive-ports mask [N_dst, N, P] (DESIGN.md §15); read only by
    # the adaptive runner
    prod: np.ndarray = None


def _traffic_arrays(traffic: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(cumulative rows, injection weights) for one traffic matrix."""
    rows = traffic.sum(axis=1)
    inj_weight = rows / max(rows.max(), 1e-12)
    cum = np.cumsum(traffic, axis=1)
    cum = cum / np.maximum(cum[:, -1:], 1e-12)
    cum[rows <= 0] = 1.0   # inert sources: any draw maps to dst 0, gated off
    return cum, inj_weight


def make_spec(routing: Routing, traffic: np.ndarray) -> SimSpec:
    depth = lm.hop_latency_cycles(routing.ch_len_mm, routing.topo.substrate)
    depth = np.maximum(np.asarray(depth, np.int32), 1)
    d = int(depth.max()) + 1
    cum, inj_weight = _traffic_arrays(traffic)
    return SimSpec(
        n=routing.topo.n, p=routing.max_ports, c=routing.n_channels, d=d,
        table=routing.table, out_ch=routing.out_ch, in_ch=routing.in_ch,
        ch_dst=routing.ch_dst, ch_in_port=routing.ch_in_port,
        ch_src=routing.ch_src, ch_out_port=routing.ch_out_port,
        ch_depth=depth, traffic_cum=cum, inj_weight=inj_weight,
        prod=productive_ports(routing))


# =====================================================================
# phase schedules (time-varying workloads, DESIGN.md §9)
# =====================================================================

@dataclasses.dataclass
class SchedSpec:
    """Compiled phase schedule for one spec (numpy, [K, ...] leaves).

    A workload is a sequence of K phases; phase k is active for cycles
    [start[k], end[k]) of the schedule, which replays cyclically
    (`t_eff = t % total`).  During a phase, injection draws destinations
    from that phase's cumulative traffic rows and offers
    `rate * gain * inj_w[node]` flits/cycle, where the gain is
    `gain_on[k]` inside the ON window of the phase's ON/OFF burst
    modulation and 0 inside the OFF window (no modulation: always ON,
    `gain_on == intensity`).
    """
    k: int
    n: int
    cum: np.ndarray       # [K, N, N] cumulative traffic rows per phase
    inj_w: np.ndarray     # [K, N] relative injection weight per phase
    gain_on: np.ndarray   # [K] float32 rate gain inside the ON window
    start: np.ndarray     # [K] int32 cumulative phase start (cycles)
    end: np.ndarray       # [K] int32 cumulative phase end (cycles)
    on: np.ndarray        # [K] int32 ON window length
    period: np.ndarray    # [K] int32 ON+OFF period (>= 1)
    total: int            # schedule length in cycles


def make_sched_spec(phases) -> SchedSpec:
    """Compile (traffic, intensity, duration[, burst_on, burst_off])
    tuples into a `SchedSpec`.

    intensity scales the offered rate for the whole phase; burst_on/off
    add ON/OFF modulation *within* the phase: during ON the gain is
    intensity * period/on, during OFF it is 0, which preserves the
    phase's mean offered load exactly when the phase duration is a
    multiple of the period.  burst_on or burst_off <= 0 disables
    modulation (gain_on == intensity exactly, so an unmodulated
    unit-intensity phase multiplies the rate by exactly 1.0f).
    """
    if not phases:
        raise ValueError("schedule needs at least one phase")
    cums, injs, gains, ons, periods, durs = [], [], [], [], [], []
    n = np.asarray(phases[0][0]).shape[0]
    for ph in phases:
        traffic, intensity, duration = ph[0], float(ph[1]), int(ph[2])
        burst_on = int(ph[3]) if len(ph) > 3 else 0
        burst_off = int(ph[4]) if len(ph) > 4 else 0
        traffic = np.asarray(traffic, np.float64)
        if traffic.shape != (n, n):
            raise ValueError(f"phase traffic shape {traffic.shape} != "
                             f"({n}, {n})")
        if duration < 1:
            raise ValueError("phase duration must be >= 1 cycle")
        cum, inj = _traffic_arrays(traffic)
        cums.append(cum), injs.append(inj), durs.append(duration)
        if burst_on > 0 and burst_off > 0:
            ons.append(burst_on)
            periods.append(burst_on + burst_off)
            gains.append(intensity * (burst_on + burst_off) / burst_on)
        else:
            ons.append(1), periods.append(1)
            gains.append(intensity)
    end = np.cumsum(np.asarray(durs, np.int64)).astype(np.int32)
    start = np.concatenate([[0], end[:-1]]).astype(np.int32)
    return SchedSpec(
        k=len(phases), n=n, cum=np.stack(cums), inj_w=np.stack(injs),
        gain_on=np.asarray(gains, np.float32), start=start, end=end,
        on=np.asarray(ons, np.int32), period=np.asarray(periods, np.int32),
        total=int(end[-1]))


def telemetry_window_cycles(cfg: SimConfig) -> np.ndarray:
    """[W] measured cycles falling in each telemetry window — the
    normalizer for per-window utilization.  Mirrors the runner's window
    index exactly: cycle t (warmup <= t < cycles) lands in window
    ((t - warmup) * W) // meas, so windows partition the measured
    cycles and differ by at most one cycle."""
    w = cfg.telemetry_windows
    if w <= 0:
        raise ValueError("telemetry_windows must be > 0 for a window "
                         "grid")
    meas = cfg.cycles - cfg.warmup
    return np.bincount((np.arange(meas, dtype=np.int64) * w) // meas,
                       minlength=w).astype(np.int64)


def phase_measured_cycles(sched: SchedSpec, cfg: SimConfig) -> np.ndarray:
    """[K] measured (post-warmup) cycles spent in each phase — the
    normalizer for per-phase throughput.  Mirrors the runner's phase
    pointer exactly: t_eff = t % total, phase = #{ends <= t_eff}."""
    t_eff = np.arange(cfg.warmup, cfg.cycles) % sched.total
    ph = (sched.end[None, :] <= t_eff[:, None]).sum(axis=1)
    return np.bincount(ph, minlength=sched.k).astype(np.int64)


def _phase_tables(sb, srow: np.ndarray, rate: np.ndarray,
                  cycles: int) -> dict:
    """Per-cycle phase tables of a padded `SchedBatch` (host numpy).

    srow [B] is each row's spec, rate [B] its float32 rate.  Returns
    `rate` [cycles, B] float32 — `rate * gain` with the gain
    `gain_on[ph]` inside the ON window and 0.0 outside, multiplied in
    float32 in the reference's order, so `rate_eff * inj_w` rounds as
    there; `kidx_spec` [cycles, S] and `kidx_row` [cycles, B], the flat
    index `spec * K + ph` into the [S*K, ...] phase leaves; and `bk`
    [cycles, B], the flat index `row * K + ph` into the [B*K, ...]
    per-phase counters."""
    S, K = sb.end.shape
    s = np.arange(S)[None, :]
    t_eff = (np.arange(cycles, dtype=np.int64)[:, None]
             % sb.total.astype(np.int64)[None, :])       # [T, S]
    ph = (sb.end[None, :, :] <= t_eff[:, :, None]).sum(2)  # [T, S]
    in_on = (t_eff - sb.start[s, ph]) % sb.period[s, ph] < sb.on[s, ph]
    gain = np.where(in_on, sb.gain_on[s, ph], np.float32(0.0))
    kidx = s * K + ph
    return dict(rate=rate[None, :] * gain[:, srow],
                kidx_spec=kidx, kidx_row=kidx[:, srow],
                bk=np.arange(len(srow))[None, :] * K + ph[:, srow])


# =====================================================================
# padding-invariant injection randomness
# =====================================================================
# The reference hashes in wrapping uint32.  torch has no >> or % on
# uint32, so the port hashes in int64 holding values in [0, 2^32).  A
# product of two such values can pass 2^63, and signed overflow is
# undefined in the device code, so each multiply is split into 16-bit
# halves of the constant: every partial product stays below 2^48.

def _mul32(h, m: int):
    """(h * m) mod 2^32 for h in [0, 2^32): an int64 tensor or an int."""
    return (h * (m & 0xFFFF) + (((h * (m >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(h):
    """splitmix-style avalanche on values in [0, 2^32)."""
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    return h ^ (h >> 16)


def _node_bits(seed: int, t, node_idx, stream: int):
    """Per-node 32 bits depending only on (seed, cycle, node, stream) —
    bitwise invariant to the node-axis padding.  `t` and `node_idx`
    are int64 tensors (broadcast together) or ints."""
    h = _mix32((seed & _M32) ^ _mul32(stream, _GOLD))
    h = _mix32(h ^ _mul32(t, _MIX_T))
    return _mix32(h ^ _mul32(node_idx, _MIX_N))


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """[0, 2^32) -> float32 in [0, 1) using the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


# =====================================================================
# route lookup + allocation
# =====================================================================

def _route_lookup(table, srow, credits, head_dst, cnt, p: int,
                  starved: bool = False):
    """Table lookup + credit check for every (row, node, in-port, VC)
    head flit.  Returns op_slot [B, N, PI, V] int64 (requested output
    slot, ejection = P, negative = no request) and eligible [B, N, PI,
    V] bool.  `table` is the [S, N, N, P+1] stack, indexed through the
    row's spec `srow`.  starved=True (the flight recorder) also returns
    the credit-starved mask: a valid head flit routed to a real output
    port whose downstream VC has no credit."""
    B, N, PI, V = head_dst.shape
    dev = head_dst.device
    node = torch.arange(N, device=dev).view(1, N, 1, 1)
    port = torch.arange(PI, device=dev).view(1, 1, PI, 1)
    vcs = torch.arange(V, device=dev).view(1, 1, 1, V)
    b = torch.arange(B, device=dev).view(B, 1, 1, 1)

    valid = cnt > 0
    dst = torch.where(valid, head_dst, 0)
    op = table[srow.view(B, 1, 1, 1), dst, node, port].long()
    op = torch.where(valid, op, -3)
    is_eject = op == Routing.EJECT
    op_slot = torch.where(is_eject, p, op)
    # the ejection slot P always has credit (the reference pads the
    # credit tensor with INF there), so only ports [0, P) are looked up
    have_credit = credits[b, node, op_slot.clamp(0, p - 1), vcs] > 0
    eligible = valid & (op_slot >= 0) & (have_credit | is_eject)
    if not starved:
        return op_slot, eligible
    return (op_slot, eligible,
            valid & (op_slot >= 0) & ~is_eject & ~have_credit)


def _route_lookup_adaptive(table, prod, srow, credits, head_dst, cnt,
                           p: int):
    """Minimal-adaptive route selection with escape fallback (§15).

    The Duato-style VC partition: VC 0 is the escape class, following
    the static up*/down* table (indexed by the arrival in-port); VCs
    1..V-1 are the adaptive class, free to take any *productive* port
    (`prod` [S, N, N, P], a minimal escape-safe next hop), chosen by the
    downstream adaptive-class credit summed over its VCs, first maximum
    on ties.  A head flit takes an adaptive hop whenever some productive
    port has adaptive credit; otherwise it falls back to the escape
    route, gated on VC-0 credit.  Ejection is always eligible.

    Returns op_slot, eligible and starved [B, N, PI, V], shaped like
    `_route_lookup`'s, plus dvc [B, N, PI, V] int64, the downstream VC
    of each choice (>= 1 adaptive, 0 escape).
    """
    B, N, PI, V = head_dst.shape
    dev = head_dst.device
    node = torch.arange(N, device=dev).view(1, N, 1, 1)
    port = torch.arange(PI, device=dev).view(1, 1, PI, 1)
    b = torch.arange(B, device=dev).view(B, 1, 1, 1)
    s = srow.view(B, 1, 1, 1)

    valid = cnt > 0
    dst = torch.where(valid, head_dst, 0)
    # escape route: the static table, arrival-in-port indexed (the
    # ejection slot P has credit by definition, so only ports [0, P)
    # are looked up; an ejecting flit is eligible without it)
    op = table[s, dst, node, port].long()
    op = torch.where(valid, op, -3)
    is_eject = op == Routing.EJECT
    esc_slot = torch.where(is_eject, p, op)
    esc_credit = credits[b, node, esc_slot.clamp(0, p - 1), 0] > 0

    # adaptive candidates: productive ports scored by the summed
    # downstream adaptive-class credit (first maximum on ties, as
    # jnp.argmax)
    cand = prod[s, dst, node]                            # [B, N, PI, V, P]
    cred_ad = credits[..., 1:].sum(3).view(B, N, 1, 1, p)
    score = torch.where(cand & (cred_ad > 0), cred_ad, -1)
    best, ad_port = score.max(4)
    # downstream adaptive VC with the most credit at the chosen port
    dvc_ad = 1 + credits[b, node, ad_port, 1:].argmax(4)

    use_ad = valid & ~is_eject & (best > 0)
    op_slot = torch.where(use_ad, ad_port, esc_slot)
    eligible = valid & (op_slot >= 0) & \
        (use_ad | is_eject | ((esc_slot >= 0) & esc_credit))
    starved = valid & ~is_eject & (esc_slot >= 0) & ~eligible
    return op_slot, eligible, starved, torch.where(use_ad, dvc_ad, 0)


def resolve_alloc(alloc: str, device) -> str:
    """Map SimConfig.alloc to an implementation for this device:
    "auto" is the CUDA kernel on a CUDA device and the plain version
    on the CPU; "torch" is the plain version anywhere; "cuda" is the
    kernel and needs a CUDA device."""
    dev = torch.device(device)
    if alloc == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if alloc not in ("torch", "cuda"):
        raise ValueError(f"unknown alloc impl {alloc!r}; choose 'auto', "
                         f"'torch' or 'cuda'")
    if alloc == "cuda" and dev.type != "cuda":
        raise ValueError(f"alloc='cuda' needs a CUDA device, got {dev}")
    return alloc


def _check_config(cfg: SimConfig) -> None:
    """The reference runner's checks of a SimConfig, with its messages."""
    if cfg.routing not in ("static", "adaptive"):
        raise ValueError(f"unknown routing mode {cfg.routing!r}; "
                         f"choose 'static' or 'adaptive'")
    if cfg.routing == "adaptive" and cfg.n_vcs < 2:
        raise ValueError(
            f"adaptive routing needs n_vcs >= 2 (VC 0 escape + at least "
            f"one adaptive VC), got n_vcs={cfg.n_vcs}")
    w = cfg.telemetry_windows
    if w < 0:
        raise ValueError(f"telemetry_windows must be >= 0, got {w}")
    if w and not cfg.telemetry:
        raise ValueError(
            "telemetry_windows requires telemetry=True — the windowed "
            "counters bin the flight recorder, they cannot replace it")
    meas = cfg.cycles - cfg.warmup
    if w > meas:
        raise ValueError(
            f"telemetry_windows={w} exceeds the measured window "
            f"({meas} cycles) — some windows would be empty")


# =====================================================================
# batched runner
# =====================================================================

def _graphed(device, probe: dict | None) -> bool:
    """Whether the cycle loop replays its cycles from CUDA graphs: on a
    CUDA device, unless an op trace follows the loop (a probe holding
    `cycle`), which needs every op of every cycle issued from Python."""
    return torch.device(device).type == "cuda" and \
        not (probe is not None and "cycle" in probe)


def _fused(device, cfg: SimConfig, probe: dict | None) -> bool:
    """Whether each cycle runs as the fused kernels (`kernels.cycle`)
    around the `netstep` kernel: on a CUDA device with the kernel
    allocator and no op trace, in every mode (static or adaptive routing,
    with or without the flight recorder).  Every other run keeps the
    PyTorch body: the CPU, `alloc="torch"` and `trace_batch`."""
    return torch.device(device).type == "cuda" and \
        resolve_alloc(cfg.alloc, device) == "cuda" and \
        not (probe is not None and "cycle" in probe)


#: the fused kernels' state carried across cycles (`_fused_args`' keys)
_FUSED_STATE = ("buf_dst", "buf_t", "head", "cnt", "credits", "link_dst",
                "link_t", "link_vc", "credit_pipe", "rr", "delivered",
                "offered", "accepted", "lat_node")
#: the tensors `_simulate_rows` keeps for both bodies (named as the fused
#: kernels' arguments): the cycle, the chunk's injection bits, the
#: rotating priority and the counters; workload runs add _PHASE_COUNTERS
_SHARED = ("t", "u_inj", "u_dst", "vcs", "rr", "delivered", "offered",
           "accepted", "lat_node")
_PHASE_COUNTERS = ("delivered_ph", "offered_ph", "accepted_ph", "lat_ph")
#: the flight recorder's counters (DESIGN.md §13, §16), kept for both
#: bodies with the recorder on (`_recorder_counters`): busy, stall [nw, B,
#: C+1], occupancy [nw, B, C+1, V], injections, ejections [nw, B, N] and
#: the latency histogram [B, LAT_HIST_BINS], nw = max(W, 1) windows
_RECORDER = ("tel_busy", "tel_stall", "tel_occ", "tel_inj", "tel_eject",
             "tel_hist")


def _recorder_counters(cfg: SimConfig, B: int, n: int, c: int,
                       dev) -> dict:
    """The recorder's counters, int32 zeros, each with a leading window
    axis (one window when W = 0): each measured cycle adds into one
    window, so the aggregates are the window sums, formed once after the
    loop (`_recorder_outputs`).  Row C is sacrificial.  All None without
    the recorder."""
    if not cfg.telemetry:
        return dict.fromkeys(_RECORDER)
    nw, V = max(cfg.telemetry_windows, 1), cfg.n_vcs

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    return dict(tel_busy=zeros(nw, B, c + 1), tel_stall=zeros(nw, B, c + 1),
                tel_occ=zeros(nw, B, c + 1, V), tel_inj=zeros(nw, B, n),
                tel_eject=zeros(nw, B, n),
                tel_hist=zeros(B, LAT_HIST_BINS))


def _recorder_outputs(tel: dict, cfg: SimConfig) -> tuple:
    """The recorder's outputs: the window sums of its counters and the
    latency histogram, then, with W windows, the counters by window;
    none without the recorder."""
    if not cfg.telemetry:
        return ()
    wins = [tel[k] for k in _RECORDER[:5]]
    out = tuple(x.sum(0, dtype=torch.int32) for x in wins) + (
        tel["tel_hist"],)
    if cfg.telemetry_windows:
        out += tuple(x.transpose(0, 1) for x in wins)
    return out


def _fused_args(lv: dict, srow, rate, sched: dict | None, n: int, p: int,
                c: int, d: int, cfg: SimConfig) -> dict:
    """The arguments of the fused kernels (`kernels.cycle.ops.ARGS`) but
    the ones the loop keeps for both bodies (`_SHARED`, and in workload
    runs `_PHASE_COUNTERS`): per-row spec leaves, the injection tables and
    the state, int32 (every value fits: cycles, node ids, counts <= Bd)
    and without the body's sacrificial slots and channel row (the
    recorder's counters, kept for both bodies, keep theirs).  Adaptive
    runs add `prod`, the productive-ports leaf packed to P bits a (spec,
    dst, node), and `dvc`; `windows`, `warmup` and `meas` place each
    measured cycle in the recorder's windows."""
    B, dev = srow.shape[0], srow.device
    V, Bd, PI = cfg.n_vcs, cfg.buf_depth, p + 1
    i32 = torch.int32
    depth = lv["ch_depth"][srow].long()                      # [B, C]

    def zeros(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def delay(ch):
        """The pipeline depth of each (row, node, port)'s channel."""
        return depth.gather(1, ch.long().clamp(min=0).view(B, -1)).view(
            ch.shape).to(i32)

    up_ch, out_ch = lv["in_ch"][srow], lv["out_ch"][srow]    # [B, N, P]
    a = dict(up_ch=up_ch, up_delay=delay(up_ch), out_ch=out_ch,
             out_delay=delay(out_ch), table=lv["table"], srow=srow.to(i32),
             pi=lv["pi"][srow], rate=rate, inj_w=lv["inj_weight"],
             cum=lv["traffic_cum"], rate_t=None, kidx_row=None, bk=None,
             buf_dst=zeros(B, n, PI, V, Bd), buf_t=zeros(B, n, PI, V, Bd),
             head=zeros(B, n, PI, V), cnt=zeros(B, n, PI, V),
             credits=torch.full((B, n, p, V), Bd, dtype=i32, device=dev),
             link_dst=torch.full((B, c, d), -1, dtype=i32, device=dev),
             link_t=zeros(B, c, d), link_vc=zeros(B, c, d),
             credit_pipe=zeros(B, c, d, V), op_slot=zeros(B, n, PI, V),
             eligible=zeros(B, n, PI, V, dtype=torch.bool),
             rr_vc=zeros(B), rr_port=zeros(B), delivered_ph=None,
             offered_ph=None, accepted_ph=None, lat_ph=None, prod=None,
             dvc=None, ticket=zeros(1), windows=cfg.telemetry_windows,
             warmup=cfg.warmup, meas=cfg.cycles - cfg.warmup)
    if cfg.routing == "adaptive":
        bit = torch.arange(p, dtype=i32, device=dev)
        a.update(prod=(lv["prod"].to(i32) << bit).sum(3, dtype=i32),
                 dvc=zeros(B, n, PI, V))
    if sched is not None:
        a.update(inj_w=sched["inj_w"], cum=sched["cum"],
                 **{k: sched[j].contiguous() for k, j in (
                     ("rate_t", "rate"), ("kidx_row", "kidx_row"),
                     ("bk", "bk"))})
    return a


#: the kernel wrappers that count their launches (`launches`, and
#: `captured` for a call made while a graph is captured)
_COUNTED = (netstep, cycle_route, cycle_move)


class _CycleGraphs:
    """The CUDA graphs of one run's cycle loop, one per cycle body (keyed
    by `measuring`: warm-up or measured), sharing one memory pool.

    A capture records the body's launches without running them, so the
    simulation advances only by eager cycles and by replays.  `release`
    adds the launches the replays made of each counted kernel wrapper
    (`_COUNTED`) to that wrapper's `launches`, once a run rather than
    once a replay (the host's replay of a cycle is the loop's time in the
    cells that wait on it), then frees the graphs and their pool."""

    def __init__(self, dev):
        self.dev = dev
        self.stream = torch.cuda.Stream(device=dev)
        self.graphs: dict = {}
        self.launches: dict = {}
        self.replays: dict = {}

    def capture(self, key: bool, body) -> None:
        g = torch.cuda.CUDAGraph()
        pool = next(iter(self.graphs.values())).pool() if self.graphs \
            else None
        held = [f.captured for f in _COUNTED]
        cur = torch.cuda.current_stream(self.dev)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            g.capture_begin(pool=pool)
            try:
                body()
            finally:
                g.capture_end()
        cur.wait_stream(self.stream)
        self.graphs[key] = g
        self.launches[key] = [f.captured - h for f, h in zip(_COUNTED, held)]
        self.replays[key] = 0

    def replay(self, key: bool) -> None:
        self.graphs[key].replay()
        self.replays[key] += 1

    def release(self) -> None:
        if self.graphs:
            metrics.inc("sim.graph_captures", len(self.graphs))
            metrics.inc("sim.graph_replays", sum(self.replays.values()))
        for key, n in self.replays.items():
            for f, k in zip(_COUNTED, self.launches[key]):
                f.launches += n * k
        self.replays.clear()
        for g in self.graphs.values():
            g.reset()
        self.graphs.clear()


def _fused_body(lv: dict, srow, rate, sched: dict | None, shared: dict,
                n: int, p: int, c: int, d: int, cfg: SimConfig, alloc_fn):
    """The fused body of `_simulate_rows`: `cycle_route`, `alloc_fn` and
    `cycle_move` on int32 state of their own (`_fused_args`) and the
    loop's `shared` tensors.  Returns (cycle, state) as `_torch_body`
    does."""
    fa = _fused_args(lv, srow, rate, sched, n, p, c, d, cfg)
    fa.update(shared)
    state = [fa[k] for k in _FUSED_STATE]
    if sched is not None:
        state += [fa[k] for k in _PHASE_COUNTERS]
    if cfg.telemetry:
        state += [fa[k] for k in _RECORDER]

    def cycle(measuring: bool) -> None:
        """Simulate cycle `t` and advance `t` in three launches:
        §1-§4, the allocator, §5."""
        cycle_route(fa, measuring)
        win_mask, vc_choice, out_req = alloc_fn(
            fa["op_slot"], fa["eligible"], fa["rr_vc"], fa["rr_port"])
        cycle_move(fa, win_mask, vc_choice, out_req, measuring)

    return cycle, state


def _torch_body(lv: dict, srow, rate, sched: dict | None, shared: dict,
                n: int, p: int, c: int, d: int, cfg: SimConfig, alloc_fn):
    """The PyTorch body of `_simulate_rows`: about 170 stock ops a cycle
    on int64 state of its own, with sacrificial slots and a sacrificial
    channel row, around `alloc_fn`.  `shared` holds the tensors the loop
    keeps for both bodies (`_simulate_rows`).  Returns (cycle, state):
    `cycle(measuring)` simulates cycle `t` and advances it, and `state`
    lists the tensors carried across cycles."""
    N, P, C, D = n, p, c, d
    V, Bd = cfg.n_vcs, cfg.buf_depth
    PI = P + 1
    B = srow.shape[0]
    dev = srow.device
    i64, i32 = torch.int64, torch.int32
    t, u_inj_c, u_dst_c, vcs_c, rr, delivered, offered, accepted, \
        lat_node = (shared[k] for k in _SHARED)
    if sched is not None:
        s_cum, s_inj = sched["cum"], sched["inj_w"]
        rate_t, kidx_spec, kidx_row, bk = (
            sched[k] for k in ("rate", "kidx_spec", "kidx_row", "bk"))
        delivered_ph, offered_ph, accepted_ph, lat_ph = (
            shared[k] for k in _PHASE_COUNTERS)

    # ---- per-row spec leaves (gathered once) ---------------------------
    ch_dst = lv["ch_dst"][srow].long()                   # [B, C]
    ch_in_port = lv["ch_in_port"][srow].long()
    ch_src = lv["ch_src"][srow].long()
    ch_out_port = lv["ch_out_port"][srow].long()
    depth_pad = torch.cat(                               # [B, C+1]
        [lv["ch_depth"][srow].long(), torch.ones((B, 1), dtype=i64,
                                                 device=dev)], dim=1)
    out_ch = lv["out_ch"][srow].long()                   # [B, N, P]
    inj_w = lv["inj_weight"][srow]                       # [B, N] f32
    pi = lv["pi"][srow]                                  # [B] int32
    rr_mod = V * pi                                      # [B] int32
    rate_b = rate.view(B, 1)
    table, cum = lv["table"], lv["traffic_cum"]          # [S, ...]
    adaptive = cfg.routing == "adaptive"
    prod = lv["prod"] if adaptive else None

    b2 = torch.arange(B, device=dev).view(B, 1)
    b3 = b2.view(B, 1, 1)
    node_r = torch.arange(N, device=dev)
    node3 = node_r.view(1, N, 1)
    pp = torch.arange(PI, device=dev).view(1, 1, PI)

    # upstream channel of every (node, in-port) and its credit-return
    # delay: spec-only, so hoisted out of the cycle loop
    up_ch = lv["in_ch"][srow].long().gather(
        2, pp.clamp(0, P - 1).expand(B, N, PI))          # [B, N, PI]
    up_real = (pp < P) & (up_ch >= 0)
    up_ch_s = up_ch.clamp(min=0)
    up_delay = depth_pad.gather(1, up_ch_s.view(B, -1)).view(B, N, PI)
    # the spec-only part of each accumulating scatter's flat index (the
    # cycle adds the rest): arrivals into cnt [B, N, PI, V] at (row,
    # ch_dst, ch_in_port, vc); credit returns into credits [B, N, P, V]
    # at (row, ch_src, ch_out_port, every vc); upstream returns into
    # credit_pipe [B, C+1, D, V] at (row, up_ch_s, slot, vc); traversals
    # into credits at (row, node, out_port, vc)
    arr_base = ((b2 * N + ch_dst) * PI + ch_in_port) * V          # [B, C]
    ret_flat = (((b2 * N + ch_src) * P + ch_out_port) * V).unsqueeze(2) \
        + torch.arange(V, device=dev)                             # [B, C, V]
    up_base = (b3 * (C + 1) + up_ch_s) * D                        # [B, N, PI]
    trav_base = (b3 * N + node3) * P                              # [B, N, 1]

    # ---- state ------------------------------------------------------------
    # int64 where a value indexes another tensor (torch indexes with
    # int64); the counters the reference keeps in int32 stay int32
    buf_dst = torch.full((B, N, PI, V, Bd + 1), -1, dtype=i64, device=dev)
    buf_t = torch.zeros((B, N, PI, V, Bd + 1), dtype=i64, device=dev)
    head = torch.zeros((B, N, PI, V), dtype=i64, device=dev)
    cnt = torch.zeros((B, N, PI, V), dtype=i64, device=dev)
    credits = torch.full((B, N, P, V), Bd, dtype=i64, device=dev)
    link_dst = torch.full((B, C + 1, D), -1, dtype=i64, device=dev)
    link_t = torch.zeros((B, C + 1, D), dtype=i64, device=dev)
    link_vc = torch.zeros((B, C + 1, D), dtype=i64, device=dev)
    credit_pipe = torch.zeros((B, C + 1, D, V), dtype=i64, device=dev)
    cnt_flat, credits_flat = cnt.view(-1), credits.view(-1)
    credit_pipe_flat = credit_pipe.view(-1)
    W = cfg.telemetry_windows
    if cfg.telemetry:
        meas = cfg.cycles - cfg.warmup
        tel_busy, tel_stall, tel_occ, tel_inj, tel_eject, tel_hist = (
            shared[k] for k in _RECORDER)
        hist_edges = 2 ** torch.arange(LAT_HIST_BINS - 1, dtype=i64,
                                       device=dev)
        # row offsets into the flattened [B, C+1] and [B, bins] counters
        ch_base = b3 * (C + 1)
        hist_base = b3 * LAT_HIST_BINS
        w_first = torch.zeros((1,), dtype=i64, device=dev)
    state = [buf_dst, buf_t, head, cnt, credits, link_dst, link_t,
             link_vc, credit_pipe, rr, delivered, offered, accepted,
             lat_node]
    if sched is not None:
        state += [delivered_ph, offered_ph, accepted_ph, lat_ph]
    if cfg.telemetry:
        state += [shared[k] for k in _RECORDER]

    def cycle(measuring: bool) -> None:
        """Simulate cycle `t` and advance `t`.  `measuring` (past the
        warm-up) adds the counters."""
        recording = cfg.telemetry and measuring
        slot = t % D
        k = t % _BITS_CHUNK

        # ---- 1. link deliveries -> input buffers -----------------------
        arr_dst = link_dst[:, :C].index_select(2, slot).view(B, C)
        arr_ok = arr_dst >= 0
        arr_at = (b2, ch_dst, ch_in_port,
                  link_vc[:, :C].index_select(2, slot).view(B, C))
        pos = (head[arr_at] + cnt[arr_at]) % Bd
        pos_w = torch.where(arr_ok, pos, Bd)                # Bd: sacrificial
        buf_dst[arr_at + (pos_w,)] = arr_dst
        buf_t[arr_at + (pos_w,)] = link_t[:, :C].index_select(2, slot).view(
            B, C)
        cnt_flat.index_add_(0, (arr_base + arr_at[3]).view(-1),
                            arr_ok.long().view(-1))
        link_dst.index_fill_(2, slot, -1)

        # ---- 2. credit returns -----------------------------------------
        credits_flat.index_add_(0, ret_flat.view(-1), credit_pipe[:, :C]
                                .index_select(2, slot).view(-1))
        credit_pipe.index_fill_(2, slot, 0)

        # ---- 3. injection ----------------------------------------------
        u_inj = u_inj_c.index_select(0, k)                  # [1, N]
        if sched is None:
            want = u_inj < rate_b * inj_w                   # [B, N]
            cum_t = cum                                     # [S, N, N]
        else:
            # this cycle's phase of every row (spec): rate * gain was
            # formed in float32 on the host, as the reference forms it
            want = (u_inj < rate_t.index_select(0, t).view(B, 1)
                    * s_inj[kidx_row.index_select(0, t).view(B)])
            cum_t = s_cum[kidx_spec.index_select(0, t).view(-1)]
        dsts = (cum_t < u_dst_c.index_select(0, k).view(1, N, 1)).sum(
            2).clamp(0, N - 1)
        dsts = dsts[srow]                                   # [B, N]
        want &= dsts != node_r
        inj_at = (b2, node_r, P, vcs_c.index_select(0, k))
        space = cnt[inj_at] < Bd
        do_inj = want & space
        posi = (head[inj_at] + cnt[inj_at]) % Bd
        posi_w = torch.where(do_inj, posi, Bd)
        buf_dst[inj_at + (posi_w,)] = dsts
        buf_t[inj_at + (posi_w,)] = t
        cnt[inj_at] += do_inj.long()  # unique per row/node
        if measuring:
            n_want = want.sum(1, dtype=i32)
            n_inj = do_inj.sum(1, dtype=i32)
            offered.add_(n_want)
            accepted.add_(n_inj)
            if sched is not None:  # one phase per row
                bk_t = bk.index_select(0, t).view(B)
                offered_ph.index_add_(0, bk_t, n_want)
                accepted_ph.index_add_(0, bk_t, n_inj)

        # ---- 4. route + allocate ---------------------------------------
        if recording:
            # the occupancy snapshot: post-arrival, post-injection,
            # pre-pop (the pop below updates cnt in place)
            occ = cnt[b2, ch_dst, ch_in_port]               # [B, C, V]
        head_dst = buf_dst.gather(4, head.unsqueeze(4)).squeeze(4)
        head_t = buf_t.gather(4, head.unsqueeze(4)).squeeze(4)
        if adaptive:
            op_slot, eligible, starved, dvc = _route_lookup_adaptive(
                table, prod, srow, credits, head_dst, cnt, P)
        elif cfg.telemetry:
            op_slot, eligible, starved = _route_lookup(
                table, srow, credits, head_dst, cnt, P, starved=True)
        else:
            op_slot, eligible = _route_lookup(
                table, srow, credits, head_dst, cnt, P)
        win_mask, vc_choice, out_req = alloc_fn(op_slot.to(i32), eligible,
                                                rr % V, rr % pi)
        port_wins = win_mask.any(3)                         # [B, N, PI]

        # ---- 5. winners: pop, move, credit -----------------------------
        # wvc is the source VC popped at (node, in-port); w_dvc the
        # downstream VC the flit occupies after the hop.  Static routing
        # keeps them equal; adaptive routing moves the link VC tag and
        # the downstream credit to the class the lookup chose, while the
        # upstream credit return (freeing the popped lane) stays on wvc.
        wvc = vc_choice.long()                              # [B, N, PI]
        w_dvc = dvc.gather(3, wvc.unsqueeze(3)).squeeze(3) \
            if adaptive else wvc
        w_dst = head_dst.gather(3, wvc.unsqueeze(3)).squeeze(3)
        w_t = head_t.gather(3, wvc.unsqueeze(3)).squeeze(3)
        pw = port_wins.long().unsqueeze(3)
        head.scatter_add_(3, wvc.unsqueeze(3), pw).remainder_(Bd)
        cnt.scatter_add_(3, wvc.unsqueeze(3), -pw)

        # upstream credit return for real input ports
        has_up = up_real & port_wins
        ret_slot = (up_delay + t) % D
        credit_pipe_flat.index_add_(0, ((up_base + ret_slot) * V
                                        + wvc).view(-1),
                                    has_up.long().view(-1))

        # ejection vs traversal
        eject = port_wins & (out_req == P)
        traverse = port_wins & (out_req >= 0) & (out_req < P)
        if measuring:
            n_ej = eject.sum((1, 2), dtype=i32)
            lat_row = torch.where(eject, t - w_t, 0).sum(2, dtype=i32)
            delivered.add_(n_ej)
            lat_node.add_(lat_row)
            if sched is not None:
                delivered_ph.index_add_(0, bk_t, n_ej)
                lat_ph.index_add_(0, bk_t, lat_row)

        out_port = out_req.long().clamp(0, P - 1)
        oc_w = torch.where(traverse, out_ch.gather(2, out_port), C)
        wslot = (depth_pad.gather(1, oc_w.view(B, -1)).view(B, N, PI)
                 + t) % D
        link_at = (b3, oc_w, wslot)                         # C: sacrificial
        link_dst[link_at] = w_dst
        link_t[link_at] = w_t
        link_vc[link_at] = w_dvc
        credits_flat.index_add_(0, ((trav_base + out_port) * V
                                    + w_dvc).view(-1),
                                -traverse.long().view(-1))
        rr.add_(1).remainder_(rr_mod)

        # ---- 6. flight recorder (DESIGN.md §13, §16) -------------------
        # Pure observers: integer adds onto the recorder's own counters,
        # with non-contributing lanes sent to the sacrificial row C or
        # adding 0.  Duplicate indices (row C above all) need an
        # accumulating scatter: `index_add_` on the flattened counter, as
        # for the state above.  The window w is this cycle's, [1].
        if recording:
            w = ((t - cfg.warmup) * W).div_(
                meas, rounding_mode="floor").clamp_(0, W - 1) \
                if W else w_first
            w_ch = ch_base + w * (B * (C + 1))              # [B, 1, 1]
            tel_busy.view(-1).index_add_(0, (w_ch + oc_w).view(-1),
                                         traverse.int().view(-1))
            # credit starvation, charged to the requested out channel
            st_ch = out_ch.gather(2, op_slot.clamp(0, P - 1).view(
                B, N, PI * V))
            tel_stall.view(-1).index_add_(
                0, (w_ch + torch.where(starved.view(B, N, PI * V), st_ch,
                                       C)).view(-1),
                starved.int().view(-1))
            tel_occ[:, :, :C].index_add_(0, w, occ.int().unsqueeze(0))
            tel_inj.index_add_(0, w, do_inj.int().unsqueeze(0))
            tel_eject.index_add_(0, w, eject.sum(2, dtype=i32).unsqueeze(0))
            # latency bin h counts t - w_t in [2^(h-1), 2^h); lanes that
            # did not eject add 0 at a stale, in-range bin
            tel_hist.view(-1).index_add_(
                0, (hist_base + torch.bucketize(
                    t - w_t, hist_edges, right=True)).view(-1),
                eject.int().view(-1))
        t.add_(1)

    return cycle, state

def _simulate_rows(lv: dict, srow: torch.Tensor, rate: torch.Tensor,
                   n: int, p: int, c: int, d: int, cfg: SimConfig,
                   alloc_fn, sched: dict | None = None,
                   probe: dict | None = None):
    """Simulate B = len(srow) rows for cfg.cycles cycles.

    lv: the BatchSpec leaves as device tensors ([S, ...]); srow [B] the
    spec of each row; rate [B] float32.  Returns the raw counters
    (delivered, offered, accepted [B], lat_node [B, N]) as int32
    device tensors.

    sched (workload mode): the SchedBatch leaves `cum` [S*K, N, N] and
    `inj_w` [S*K, N] flattened over (spec, phase), the `_phase_tables`
    as device tensors and `k`.  Injection then reads the row's phase at
    cycle t from the tables, and four per-phase counters follow the
    totals: delivered_ph, offered_ph, accepted_ph [B, K] and lat_ph
    [B, K, N], int32.

    cfg.routing="adaptive" routes through `_route_lookup_adaptive` (the
    `prod` leaf) and moves each traversing flit to the downstream VC it
    chose.  cfg.telemetry=True appends the flight recorder's counters,
    int32: busy and stall [B, C+1], occupancy sums [B, C+1, V],
    injections and ejections [B, N] and the latency histogram [B,
    LAT_HIST_BINS]; with cfg.telemetry_windows=W also the first five
    binned by window, [B, W, ...].  Row C and pad lanes are sacrificial:
    `run_batch` slices them away.

    probe (a profile capture or an op trace): receives `state_bytes`,
    the bytes of the state carried across cycles.  An op trace's probe
    holds `cycle`, which the loop keeps at the cycle it is in (None
    before and after the loop).

    One body, `cycle`, simulates a cycle.  It reads the cycle from the
    device counter `t` and updates every piece of state in place, so on
    a CUDA device (`_graphed`) each body (warm-up, measured) runs one
    eager cycle, which loads whatever its ops need, and is then captured
    as a CUDA graph that every later cycle of that body replays.  On the
    CPU and under an op trace every cycle runs the body eagerly.  Where
    `_fused` holds (a CUDA device, the `netstep` kernel, no op trace:
    every mode of a run on the card) the body is the fused kernels
    `cycle_route`, `alloc_fn` and `cycle_move` on int32 state of their
    own (`_fused_body`); the CPU, `alloc="torch"` and op traces keep the
    PyTorch body (`_torch_body`).  Both bodies add into the loop's
    counters, the recorder's included (`_recorder_counters`).

    Each chunk of _BITS_CHUNK cycles is one `sim.cycles` span (`obs.
    trace`) with the attributes `t0`, `cycles`, `measured` (cycles past
    the warm-up), `mode` ("static" or "workload"), `adaptive`,
    `recorder`, and, with tracing on, `graphed` (the chunk's cycles
    replayed from a graph) and `fused` (its cycles simulated by the
    fused kernels); a chunk with no replayed cycle also carries
    `alloc_calls`, its cycles' allocator calls (one a cycle).
    `obs.metrics`' `sim.fused_cycles` counts a fused run's cycles at its
    end.  Tracing reads the host's clock only where a span opens and
    closes; it never waits for the device.
    """

    N = n
    V = cfg.n_vcs
    B = srow.shape[0]
    dev = srow.device
    i64, i32 = torch.int64, torch.int32

    # ---- what both bodies keep: the cycle, its injection bits, the
    # rotating priority and the counters --------------------------------
    # the cycle, on the device; the chunk's injection randomness, [cycle
    # % _BITS_CHUNK, node], written at each chunk's start
    t = torch.zeros((1,), dtype=i64, device=dev)
    nb = min(_BITS_CHUNK, cfg.cycles)
    u_inj_c = torch.empty((nb, N), dtype=torch.float32, device=dev)
    u_dst_c = torch.empty((nb, N), dtype=torch.float32, device=dev)
    vcs_c = torch.empty((nb, N), dtype=i64, device=dev)
    rr = torch.zeros((B,), dtype=i32, device=dev)
    delivered = torch.zeros((B,), dtype=i32, device=dev)
    offered = torch.zeros((B,), dtype=i32, device=dev)
    accepted = torch.zeros((B,), dtype=i32, device=dev)
    lat_node = torch.zeros((B, N), dtype=i32, device=dev)
    shared = dict(zip(_SHARED, (t, u_inj_c, u_dst_c, vcs_c, rr, delivered,
                                offered, accepted, lat_node)))
    shared.update(dict.fromkeys(_PHASE_COUNTERS))
    if sched is not None:
        K = sched["k"]
        shared.update(zip(_PHASE_COUNTERS, (
            torch.zeros((B * K,), dtype=i32, device=dev),
            torch.zeros((B * K,), dtype=i32, device=dev),
            torch.zeros((B * K,), dtype=i32, device=dev),
            torch.zeros((B * K, N), dtype=i32, device=dev))))
    shared.update(_recorder_counters(cfg, B, N, c, dev))
    node_r = torch.arange(N, device=dev)
    adaptive = cfg.routing == "adaptive"
    fused = _fused(dev, cfg, probe)
    cycle, state = (_fused_body if fused else _torch_body)(
        lv, srow, rate, sched, shared, n, p, c, d, cfg, alloc_fn)
    if probe is not None:
        probe["state_bytes"] = sum(x.numel() * x.element_size()
                                   for x in state)

    # One `sim.cycles` span per chunk of _BITS_CHUNK cycles, where the
    # injection bits are drawn; with tracing off, the loop reads no clock.
    timed = tracing_enabled()
    mode = "static" if sched is None else "workload"
    op_trace = probe is not None and "cycle" in probe
    graphs = _CycleGraphs(dev) if _graphed(dev, probe) else None
    ran = 0
    try:
        for c0 in range(0, cfg.cycles, _BITS_CHUNK):
            c1 = min(c0 + _BITS_CHUNK, cfg.cycles)
            with _span("sim.cycles", cat="sim", t0=c0, cycles=c1 - c0,
                       measured=max(c1 - max(c0, cfg.warmup), 0),
                       mode=mode, adaptive=adaptive,
                       recorder=cfg.telemetry) as chunk:
                ts = torch.arange(c0, c1, dtype=i64, device=dev).view(-1, 1)
                u_inj_c[:c1 - c0] = _bits_to_unit(
                    _node_bits(cfg.seed, ts, node_r, 0))
                u_dst_c[:c1 - c0] = _bits_to_unit(
                    _node_bits(cfg.seed, ts, node_r, 1))
                vcs_c[:c1 - c0] = _node_bits(cfg.seed, ts, node_r, 2) % V
                replayed = 0
                for tc in range(c0, c1):
                    measuring = tc >= cfg.warmup
                    if graphs is not None and measuring in graphs.graphs:
                        graphs.replay(measuring)
                        replayed += 1
                        continue
                    if op_trace:
                        probe["cycle"] = tc
                    cycle(measuring)
                    # the body's first cycle has run: capture it if it
                    # has cycles left to replay
                    if graphs is not None and tc + 1 < (
                            cfg.cycles if measuring else cfg.warmup):
                        graphs.capture(measuring, lambda: cycle(measuring))
                if timed:
                    chunk.set(graphed=replayed,
                              fused=c1 - c0 if fused else 0)
                    if not replayed:
                        chunk.set(alloc_calls=c1 - c0)
            ran = c1
    finally:
        if graphs is not None:
            graphs.release()
        if fused:
            metrics.inc("sim.fused_cycles", ran)

    if op_trace:
        probe["cycle"] = None
    out = (delivered, offered, accepted, lat_node)
    if sched is not None:
        d_ph, o_ph, a_ph, l_ph = (shared[k] for k in _PHASE_COUNTERS)
        out += (d_ph.view(B, K), o_ph.view(B, K), a_ph.view(B, K),
                l_ph.view(B, K, N))
    return out + _recorder_outputs(shared, cfg)


def _pad_fill(specs, shape, schedules, kmax) -> list[dict]:
    """Live-work fraction of a padded batch, one dict per spec.

    `state` is the live fraction of the router-state grid the runner
    iterates (n*(p+1) of N*(P+1) cells — +1 for the ejection lane);
    `chan`/`depth` are the live channel-row and ring-depth fractions;
    `phase` is live schedule phases over k_pad (1.0 on the static
    path).  1 - fill is pad waste: device work spent keeping
    heterogeneous specs in one batch (DESIGN.md §16).
    """
    fills = []
    for i, spec in enumerate(specs):
        fills.append(dict(
            state=(spec.n * (spec.p + 1)) / (shape.n * (shape.p + 1)),
            chan=spec.c / shape.c,
            depth=spec.d / shape.d,
            phase=(schedules[i].k / kmax) if schedules is not None else 1.0))
    return fills


def _prepare(specs, rates, cfg: SimConfig, pad_shape, device, schedules,
             k_pad) -> tuple:
    """Check and pad a batch the way `run_batch` runs it.  Returns the
    device, the alloc impl, the PadShape, the padded BatchSpec, the [S, R]
    float32 rates, kmax, the pad fills and `run(run_cfg, probe=None)`,
    which uploads the batch and simulates it for `run_cfg`'s cycles,
    returning the raw device counters and the device arguments."""
    dev = resolve_device(device)
    _check_config(cfg)
    alloc = resolve_alloc(cfg.alloc, dev)
    alloc_fn = netstep if alloc == "cuda" else netstep_ref
    from ..sweep.padding import stack_schedules, stack_specs
    with _span("sim.stack", cat="sim", specs=len(specs)):
        batch, shape = stack_specs(specs, pad_shape)
    s = len(specs)
    rates = np.asarray(rates, np.float32)
    if rates.ndim == 1:
        rates = np.broadcast_to(rates, (s, rates.shape[0]))
    if rates.shape[0] != s:
        raise ValueError(f"rates rows {rates.shape[0]} != specs {s}")
    kmax, sbatch = 0, None
    if schedules is not None:
        if len(schedules) != s:
            raise ValueError(f"schedules {len(schedules)} != specs {s}")
        for spec, sched in zip(specs, schedules):
            if sched.n != spec.n:
                raise ValueError(f"schedule for {sched.n} nodes paired "
                                 f"with a {spec.n}-node spec")
        with _span("sim.phase_tables", cat="sim",
                   k=max(sc.k for sc in schedules), n_pad=shape.n) as sp:
            sbatch, kmax = stack_schedules(schedules, shape.n, k_pad)
            sp.set(k_pad=kmax, bytes=sum(v.nbytes for v in sbatch))
    fills = _pad_fill(specs, shape, schedules, kmax)

    def run(run_cfg, probe=None):
        """Upload the batch and simulate it for `run_cfg`'s cycles;
        returns the raw device counters and the device arguments."""
        args = _device_args(batch, sbatch, kmax, rates, cfg, dev)
        lv, srow, rate, sched = args
        return _simulate_rows(lv, srow, rate, shape.n, shape.p, shape.c,
                              shape.d, run_cfg, alloc_fn, sched,
                              probe), args

    return dev, alloc, shape, batch, rates, kmax, fills, run


def profile_batch(specs, rates, cfg: SimConfig = SimConfig(), *,
                  pad_shape=None, device=None, schedules=None,
                  k_pad=None) -> dict:
    """The runner profile (`obs.profile`) of the batch `run_batch` would
    run with these arguments, captured in the profile's own short passes
    without running the batch — for benchmarks, which profile in an
    untimed pass of their own.  Recorded in the registry (once per key)
    whether or not profiling is enabled."""
    from ..obs.profile import record_runner_profile
    dev, alloc, shape, _, _, kmax, _, run = _prepare(
        specs, rates, cfg, pad_shape, device, schedules, k_pad)
    return record_runner_profile(shape, cfg, alloc, kmax, dev, run)


def run_batch(specs, rates, cfg: SimConfig = SimConfig(), *,
              pad_shape=None, device=None, schedules=None,
              k_pad=None) -> list[dict]:
    """Run many SimSpecs x injection rates in one batched simulation.

    rates: [R] shared across specs, or [S, R] one row per spec.  Returns
    one dict per spec with raw integer counters (`delivered`,
    `offered_n`, `accepted_n`, `lat_sum`, each [R]) plus derived float
    metrics (`throughput`, `latency`, `offered`, `accepted`) computed in
    numpy — so derived values are bitwise reproducible for any padding
    of the same spec — and `pad_fill`, the live-work fraction of the
    padded batch (`state`, `chan`, `depth`, `phase`).

    schedules: optional list of `SchedSpec` (one per spec) switching the
    batch to time-varying workload injection (DESIGN.md §9).  Each spec's
    `traffic_cum`/`inj_weight` are then ignored in favour of its
    schedule's per-phase arrays, and result dicts gain per-phase
    counters (`delivered_ph`, `offered_ph`, `accepted_ph`, `lat_sum_ph`
    [R, K]), `phase_cycles` [K] and the derived `throughput_ph`,
    `latency_ph`, `offered_rate_ph`.  k_pad pads the phase axis.

    cfg.routing="adaptive" runs minimal-adaptive routing with escape VCs
    (DESIGN.md §15).  cfg.telemetry=True switches on the flight recorder
    (DESIGN.md §13): result dicts gain `TELEMETRY_KEYS` — per-directed-
    channel `link_busy` / `link_stall` [R, c] and `link_occ_sum` [R, c,
    V], their escape / adaptive split, the derived `link_util`, per-node
    `inj_node` / `eject_node` [R, n] and `lat_hist` [R, LAT_HIST_BINS].
    cfg.telemetry_windows=W adds `TELEMETRY_WINDOW_KEYS`, the same
    counters binned into W windows of the measured cycles (DESIGN.md
    §16).  Sacrificial and padded lanes are sliced away, so the recorder
    is padding-invariant like every other counter.

    With profiling enabled (`obs.profile`), a batch whose runner key is
    new is first profiled in passes of its own, outside the timed
    dispatch (see `profile_batch`).

    device: None runs on the CUDA card (and raises without one); pass
    "cpu" to run on the CPU.
    """
    dev, alloc, shape, _, rates, kmax, fills, run = _prepare(
        specs, rates, cfg, pad_shape, device, schedules, k_pad)
    s, r = rates.shape
    if profiling_enabled():
        # untimed: a capture runs passes of its own, once per key
        from ..obs.profile import record_runner_profile
        record_runner_profile(shape, cfg, alloc, kmax, dev, run)
    with _span("sim.dispatch", cat="sim", specs=s, shape=str(shape),
               device=str(dev), rows=s * r,
               kind="static" if schedules is None else "workload"):
        raw, _ = run(cfg)
    with _span("sim.wait", cat="sim", specs=s):
        raw = [x.cpu().numpy() for x in raw]
    delivered, offered, accepted = (x.reshape(s, r) for x in raw[:3])
    lat_sum = raw[3].astype(np.int64).sum(axis=1).reshape(s, r)
    meas = cfg.cycles - cfg.warmup
    tel = telw = win_cycles = None
    if cfg.telemetry:
        off = 8 if schedules is not None else 4
        tel = raw[off:off + 6]
        if cfg.telemetry_windows:
            telw = raw[off + 6:off + 11]
            win_cycles = telemetry_window_cycles(cfg)
    out = []
    for i, spec in enumerate(specs):
        norm = spec.n * meas
        res = dict(
            rate=rates[i].astype(np.float64),
            delivered=delivered[i], offered_n=offered[i],
            accepted_n=accepted[i], lat_sum=lat_sum[i],
            throughput=delivered[i] / norm,
            latency=lat_sum[i] / np.maximum(delivered[i], 1),
            offered=offered[i] / norm,
            accepted=accepted[i] / norm,
            pad_fill=fills[i])
        if schedules is not None:
            sched_i = schedules[i]
            k = sched_i.k
            rows = slice(i * r, (i + 1) * r)
            dp = raw[4][rows, :k]                          # [R, K]
            op = raw[5][rows, :k]
            ap = raw[6][rows, :k]
            lp = raw[7][rows, :k].astype(np.int64).sum(axis=2)
            ph_cy = phase_measured_cycles(sched_i, cfg)    # [K]
            ph_norm = np.maximum(spec.n * ph_cy, 1)[None, :]
            res.update(
                delivered_ph=dp, offered_ph=op, accepted_ph=ap,
                lat_sum_ph=lp, phase_cycles=ph_cy,
                throughput_ph=dp / ph_norm,
                latency_ph=lp / np.maximum(dp, 1),
                offered_rate_ph=op / ph_norm)
        if tel is not None:
            # flight-recorder slices: drop the sacrificial channel row
            # and every padded channel / node lane
            rows = slice(i * r, (i + 1) * r)
            t_busy, t_stall, t_occ, t_inj, t_ej, t_hist = tel
            c, n = spec.c, spec.n
            busy = t_busy[rows, :c]                        # [R, c]
            occ = t_occ[rows, :c, :]                       # [R, c, V]
            res.update(
                link_busy=busy, link_stall=t_stall[rows, :c],
                link_occ_sum=occ,
                link_occ_escape=occ[:, :, 0],
                link_occ_adaptive=occ[:, :, 1:].sum(axis=-1),
                link_util=busy / float(meas),
                inj_node=t_inj[rows, :n], eject_node=t_ej[rows, :n],
                lat_hist=t_hist[rows])
            if telw is not None:
                w_busy, w_stall, w_occ, w_inj, w_ej = telw
                busy_w = w_busy[rows, :, :c]               # [R, W, c]
                res.update(
                    link_busy_w=busy_w,
                    link_stall_w=w_stall[rows, :, :c],
                    link_occ_w=w_occ[rows, :, :c, :],
                    link_util_w=busy_w / np.maximum(
                        win_cycles, 1).astype(np.float64)[None, :, None],
                    inj_node_w=w_inj[rows, :, :n],
                    eject_node_w=w_ej[rows, :, :n],
                    window_cycles=win_cycles)
        out.append(res)
    return out


def _device_args(batch, sbatch, kmax: int, rates: np.ndarray,
                 cfg: SimConfig, dev) -> tuple:
    """(leaves, srow, rate, sched) of `_simulate_rows` on `dev`: the
    BatchSpec leaves (`prod` only for adaptive routing, which alone
    reads it), each row's spec and rate, and in workload mode the phase
    tables of `cfg.cycles` cycles with the flattened phase leaves."""
    s, r = rates.shape
    lv = {k: torch.as_tensor(v, device=dev)
          for k, v in batch._asdict().items()
          if k != "prod" or cfg.routing == "adaptive"}
    srow_np = np.repeat(np.arange(s), r)
    rate_np = np.array(rates).reshape(-1)
    srow = torch.as_tensor(srow_np, device=dev)
    rate = torch.as_tensor(rate_np, device=dev)
    sched = None
    if sbatch is not None:
        n_pad = sbatch.cum.shape[-1]
        # k: the most live phases of a spec (padded ones end at INF)
        with _span("sim.phase_tables", cat="sim", k=int(
                (sbatch.end < INF).sum(1).max()), k_pad=kmax,
                n_pad=n_pad) as sp:
            tables = _phase_tables(sbatch, srow_np, rate_np, cfg.cycles)
            sched = {k: torch.as_tensor(v, device=dev)
                     for k, v in tables.items()}
            sched.update(
                k=kmax,
                cum=torch.as_tensor(sbatch.cum, device=dev).view(
                    s * kmax, n_pad, n_pad),
                inj_w=torch.as_tensor(sbatch.inj_w, device=dev).view(
                    s * kmax, n_pad))
            sp.set(bytes=sum(v.nbytes for v in tables.values())
                   + sbatch.cum.nbytes + sbatch.inj_w.nbytes)
    return lv, srow, rate, sched


class OpRecord(NamedTuple):
    """One aten op of a logged run (`log_ops`): its overload name, the
    cycle it ran in (None outside the cycle loop), and the dtypes and
    device types of its tensor inputs and outputs, in order (`in_dim0`:
    which inputs are 0-dim, the tensors Python numbers become).
    `synced`: where the host waited for the card ("file:line" of the
    Python call), when `log_ops` watched the card and this op's call
    made it wait; else empty."""
    op: str
    cycle: int | None
    in_dtypes: tuple
    in_devices: tuple
    in_dim0: tuple
    out_dtypes: tuple
    out_devices: tuple
    synced: str = ""


#: the warning PyTorch gives under `torch.cuda.set_sync_debug_mode("warn")`
#: each time the host waits for the card
_SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def log_ops(probe: dict):
    """Record every aten op run inside the block as an `OpRecord` in the
    yielded list, tagged with `probe["cycle"]` at the time it ran (the
    cycle loop keeps that key current when given the probe).

    With a card present the block also runs under
    `torch.cuda.set_sync_debug_mode("warn")`, which warns at every wait
    of the host for the card at whatever level it happens (inside an
    op's kernel too: a boolean-mask index, `masked_select`).  PyTorch
    raises the warning when the Python call that issued the op returns,
    so it marks the last op logged before it (`synced`); a wait with no
    unmarked op of the same cycle before it is an op of its own,
    `"cuda.sync"`."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    log: list = []

    def tensors(tree):
        return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]

    class _OpLog(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins, outs = tensors((args, kwargs)), tensors(out)
            log.append(OpRecord(
                op=str(func), cycle=probe.get("cycle"),
                in_dtypes=tuple(str(x.dtype) for x in ins),
                in_devices=tuple(x.device.type for x in ins),
                in_dim0=tuple(x.dim() == 0 for x in ins),
                out_dtypes=tuple(str(x.dtype) for x in outs),
                out_devices=tuple(x.device.type for x in outs)))
            return out

    if not torch.cuda.is_available():
        with _OpLog():
            yield log
        return

    def on_warning(message, category, filename, lineno, *rest):
        if _SYNC_WARNING not in str(message):
            return shown(message, category, filename, lineno, *rest)
        at = f"{os.path.basename(filename)}:{lineno}"
        cycle = probe.get("cycle")
        if log and log[-1].cycle == cycle and not log[-1].synced:
            log[-1] = log[-1]._replace(synced=at)
        else:
            log.append(OpRecord("cuda.sync", cycle, (), (), (), (), (), at))

    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown, warnings.showwarning = warnings.showwarning, on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with _OpLog():
                yield log
        finally:
            torch.cuda.set_sync_debug_mode(previous)


#: cycles `trace_batch` runs: one in warm-up, then measured ones, so the
#: log holds both branches of the loop
TRACE_CYCLES = 3


def trace_batch(specs, rates, cfg: SimConfig = SimConfig(), *,
                pad_shape=None, device=None, schedules=None, k_pad=None):
    """Run the batched runner for a few cycles and log its aten ops.

    Builds exactly the arguments `run_batch` would dispatch (same
    padding, same checks, same device) and runs `TRACE_CYCLES` cycles of
    them (the first in warm-up, the rest measured) under `log_ops`,
    which with a card present also marks the host's waits for it.  PyTorch
    has no traced program to inspect, so this is the counterpart of the
    reference's abstract `trace_batch`: the ops a cycle really issues.
    Returns `(op_log, pad_shape, batch)`: a list of `OpRecord`, the
    `PadShape` and the padded `BatchSpec`; the runner-hazard analyzer
    (`analysis.runner_hazards`) reads the log for host syncs and dtype
    promotions and inspects `batch` against the sacrificial-slot
    padding contract.
    """
    _, _, shape, batch, _, _, _, run = _prepare(
        specs, rates, cfg, pad_shape, device, schedules, k_pad)
    probe: dict = {"cycle": None}
    with log_ops(probe) as log:
        run(cfg._replace(cycles=TRACE_CYCLES, warmup=1), probe)
    return log, shape, batch


# =====================================================================
# single-spec conveniences (thin wrappers over the batched path)
# =====================================================================

def simulate(routing: Routing, traffic: np.ndarray, rates,
             cfg: SimConfig = SimConfig(), *, device=None):
    """Run the simulator for a sweep of injection rates.

    Returns dict of numpy arrays: delivered throughput (flits/node/cycle),
    avg packet latency (cycles), offered and accepted rates.  This is a
    batch of one through `run_batch` at the spec's exact shape.
    """
    spec = make_spec(routing, traffic)
    res = run_batch([spec], np.asarray(rates, np.float32)[None, :], cfg,
                    device=device)[0]
    return dict(rate=np.asarray(rates), throughput=res["throughput"],
                latency=res["latency"], offered=res["offered"],
                accepted=res["accepted"])


def saturation_throughput(routing: Routing, traffic: np.ndarray,
                          cfg: SimConfig = SimConfig(),
                          n_rates: int = 8, *, device=None) -> dict:
    """Saturation = plateau of delivered throughput over an offered sweep.

    The sweep is seeded by the analytic channel-load bound and refined
    around it.
    """
    analytic = routing.saturation_rate(traffic)
    rates = saturation_rate_grid(analytic, n_rates,
                                 headroom=routing_headroom(cfg.routing))
    res = simulate(routing, traffic, rates, cfg, device=device)
    i = int(np.argmax(res["throughput"]))
    return dict(sim_saturation=float(res["throughput"][i]),
                analytic_saturation=float(analytic),
                latency_at_sat=float(res["latency"][i]), sweep=res)


def routing_headroom(routing: str) -> float:
    """Default rate-grid ceiling multiplier for a routing mode: adaptive
    sweeps must extend past the *static* analytic bound (they can beat
    it), static sweeps keep the historical 2x bracket."""
    return ADAPTIVE_HEADROOM if routing == "adaptive" else STATIC_HEADROOM


def saturation_rate_grid(analytic: float, n_rates: int = 8,
                         headroom: float = STATIC_HEADROOM) -> np.ndarray:
    """Offered-rate grid bracketing the analytic saturation estimate."""
    hi = min(1.0, headroom * analytic)
    return np.linspace(max(analytic * 0.25, 1e-3), hi, n_rates)


def zero_load_latency(routing: Routing, traffic: np.ndarray) -> float:
    """Analytic average packet latency at zero load (cycles)."""
    _, hops, lat = routing.paths_channel_loads(traffic)
    w = traffic / max(traffic.sum(), 1e-12)
    return float((lat * w).sum())
