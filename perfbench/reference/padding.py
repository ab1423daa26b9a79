"""Shape padding for heterogeneous SimSpecs (DESIGN.md §6).

The port's copy of `repro.sweep.padding`: spec padding and, for
workloads, phase-schedule padding.  A `SimSpec`'s
arrays are sized by its topology: node count N, max port count P,
directed channel count C and link-pipeline ring depth D.  To run several
topologies through one batched simulation they are padded to a common
`PadShape` and stacked into a `BatchSpec` whose leaves carry a leading
spec axis.  Padding happens in numpy, with the reference's sentinels;
`core.simulator.run_batch` moves the leaves to the device once.

Padding is *inert by construction* — the simulator never lets a padded
lane influence a real one:

  * padded nodes have `inj_weight == 0` (never inject) and all-(-1)
    routing-table rows (never route);
  * padded in/out port columns hold `-1` channel ids, which the step
    function masks everywhere it consults them;
  * padded channels are never written by real traversals (the routing
    table only names real channels), so their link rows stay empty and
    their arrival scatters resolve to the simulator's sacrificial slots;
  * `traffic_cum` pad columns are 1.0, so destination draws (uniform in
    [0, 1)) can never land on a padded node;
  * the injection column of the routing table moves from index P_spec to
    the shared padded index P, and the per-spec `pi = P_spec + 1` scalar
    lets the rotating-priority counter keep the spec's own period.

Phase schedules pad the same way (`SchedBatch`): padded phase rows end
at 2^30, so the phase pointer never counts them.  The productive-ports
leaf `prod` (adaptive routing, DESIGN.md §15) is all-False in its pad
region, so adaptive selection never names a padded destination, node or
port; the static runner never reads it.

The flight recorder (`SimConfig(telemetry=True)`, DESIGN.md §13) rides
on the same discipline in the output direction: its per-channel and
per-node counters are sized to the padded shape (sacrificial row C,
padded node tails), non-contributing lanes go to the sacrificial row or
add 0, and `run_batch` slices every counter back to the spec's own
(c, n) before results leave the batch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True, order=True)
class PadShape:
    """Common padded dimensions for a batch of SimSpecs."""
    n: int   # nodes
    p: int   # max real ports
    c: int   # directed channels
    d: int   # link pipeline ring depth

    @classmethod
    def of(cls, specs) -> "PadShape":
        return cls(n=max(s.n for s in specs), p=max(s.p for s in specs),
                   c=max(s.c for s in specs), d=max(s.d for s in specs))

    def covers(self, other: "PadShape") -> bool:
        return (self.n >= other.n and self.p >= other.p
                and self.c >= other.c and self.d >= other.d)


class BatchSpec(NamedTuple):
    """Stacked padded spec arrays; every leaf has a leading spec axis S.

    `pi` is the per-spec real port-axis size P_spec+1 (the rotating
    priority period divisor), shaped [S].
    """
    table: np.ndarray        # [S, N, N, P+1] int16
    out_ch: np.ndarray       # [S, N, P] int32
    in_ch: np.ndarray        # [S, N, P] int32
    ch_src: np.ndarray       # [S, C] int32
    ch_dst: np.ndarray       # [S, C] int32
    ch_in_port: np.ndarray   # [S, C] int32
    ch_out_port: np.ndarray  # [S, C] int32
    ch_depth: np.ndarray     # [S, C] int32
    traffic_cum: np.ndarray  # [S, N, N] float32
    inj_weight: np.ndarray   # [S, N] float32
    prod: np.ndarray         # [S, N, N, P] bool (pad region all-False)
    pi: np.ndarray           # [S] int32


def pad_spec(spec, shape: PadShape) -> dict:
    """Pad one SimSpec's arrays to `shape`; returns a dict of leaves."""
    own = PadShape(n=spec.n, p=spec.p, c=spec.c, d=spec.d)
    if not shape.covers(own):
        raise ValueError(f"pad shape {shape} does not cover spec {own}")
    n, p, c = spec.n, spec.p, spec.c
    N, P, C = shape.n, shape.p, shape.c

    table = np.full((N, N, P + 1), -1, np.int16)
    table[:n, :n, :p] = spec.table[:, :, :p]
    table[:n, :n, P] = spec.table[:, :, p]     # injection column -> slot P

    def pad2(a, fill, dtype=np.int32):
        out = np.full((N, P), fill, dtype)
        out[:n, :p] = a
        return out

    def padc(a, fill):
        out = np.full((C,), fill, np.int32)
        out[:c] = a
        return out

    cum = np.ones((N, N), np.float32)
    cum[:n, :n] = spec.traffic_cum
    inj = np.zeros((N,), np.float32)
    inj[:n] = spec.inj_weight
    # productive-ports mask: pad region all-False, so padded lanes fall
    # back to the (all -1) escape table and stay inert as on the static
    # path
    pr = np.zeros((N, N, P), bool)
    pr[:n, :n, :p] = spec.prod
    return dict(
        table=table,
        out_ch=pad2(spec.out_ch, -1), in_ch=pad2(spec.in_ch, -1),
        ch_src=padc(spec.ch_src, 0), ch_dst=padc(spec.ch_dst, 0),
        ch_in_port=padc(spec.ch_in_port, 0),
        ch_out_port=padc(spec.ch_out_port, 0),
        ch_depth=padc(spec.ch_depth, 1),
        traffic_cum=cum, inj_weight=inj, prod=pr,
        pi=np.int32(p + 1))


def stack_specs(specs: Sequence, shape: PadShape | None = None
                ) -> tuple[BatchSpec, PadShape]:
    """Pad every spec to a common shape and stack into a BatchSpec."""
    if not specs:
        raise ValueError("stack_specs needs at least one spec")
    shape = shape or PadShape.of(specs)
    padded = [pad_spec(s, shape) for s in specs]
    leaves = {k: np.stack([p[k] for p in padded]) for k in padded[0]}
    return BatchSpec(**leaves), shape


# =====================================================================
# phase-schedule padding (workload mode, DESIGN.md §9)
# =====================================================================

_END_INF = np.int32(2 ** 30)


class SchedBatch(NamedTuple):
    """Stacked padded `core.simulator.SchedSpec`s; leading spec axis S.

    Padded phase rows are inert by the same discipline as spec padding:
    their `end` is 2^30, so the phase pointer (#{ends <= t_eff}) never
    counts them for any real cycle; their gain is 0 and their traffic
    rows are all-1.0.  Padded node columns mirror `pad_spec`: inj_w 0,
    cum 1.0.
    """
    cum: np.ndarray       # [S, K, N, N] float32
    inj_w: np.ndarray     # [S, K, N] float32
    gain_on: np.ndarray   # [S, K] float32
    start: np.ndarray     # [S, K] int32
    end: np.ndarray       # [S, K] int32 (padded rows: 2^30)
    on: np.ndarray        # [S, K] int32
    period: np.ndarray    # [S, K] int32
    total: np.ndarray     # [S] int32


def pad_schedule(sched, n_pad: int, k_pad: int) -> dict:
    """Pad one SchedSpec to (k_pad phases, n_pad nodes); dict of leaves."""
    if sched.k > k_pad or sched.n > n_pad:
        raise ValueError(f"pad shape (k={k_pad}, n={n_pad}) does not "
                         f"cover schedule (k={sched.k}, n={sched.n})")
    k, n = sched.k, sched.n
    cum = np.ones((k_pad, n_pad, n_pad), np.float32)
    cum[:k, :n, :n] = sched.cum
    inj_w = np.zeros((k_pad, n_pad), np.float32)
    inj_w[:k, :n] = sched.inj_w

    def padk(a, fill, dtype):
        out = np.full((k_pad,), fill, dtype)
        out[:k] = a
        return out

    return dict(
        cum=cum, inj_w=inj_w,
        gain_on=padk(sched.gain_on, 0.0, np.float32),
        start=padk(sched.start, 0, np.int32),
        end=padk(sched.end, _END_INF, np.int32),
        on=padk(sched.on, 1, np.int32),
        period=padk(sched.period, 1, np.int32),
        total=np.int32(sched.total))


def stack_schedules(scheds: Sequence, n_pad: int, k_pad: int | None = None
                    ) -> tuple[SchedBatch, int]:
    """Pad every schedule to (k_pad, n_pad) and stack into a SchedBatch."""
    if not scheds:
        raise ValueError("stack_schedules needs at least one schedule")
    k_pad = k_pad or max(s.k for s in scheds)
    padded = [pad_schedule(s, n_pad, k_pad) for s in scheds]
    leaves = {k: np.stack([p[k] for p in padded]) for k in padded[0]}
    return SchedBatch(**leaves), k_pad
