"""Shape padding for heterogeneous SimSpecs (DESIGN.md §6).

The port's copy of `repro.sweep.padding`'s static part.  A `SimSpec`'s
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

The productive-ports leaf (adaptive routing) and the phase-schedule
batch (workloads) come with their slices.
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
    return dict(
        table=table,
        out_ch=pad2(spec.out_ch, -1), in_ch=pad2(spec.in_ch, -1),
        ch_src=padc(spec.ch_src, 0), ch_dst=padc(spec.ch_dst, 0),
        ch_in_port=padc(spec.ch_in_port, 0),
        ch_out_port=padc(spec.ch_out_port, 0),
        ch_depth=padc(spec.ch_depth, 1),
        traffic_cum=cum, inj_weight=inj,
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
