"""Workload phase schedules (DESIGN.md §9).

A *workload* is a schedule of phases.  Each phase carries a traffic
matrix (who talks to whom), a relative intensity (how hard), a duration
in cycles, and optional ON/OFF burst modulation (how spiky).  Schedules
replay cyclically through the simulator — `repro_torch.core.simulator`
owns the compiled representation (`SchedSpec`) and the time-varying
injection; this module owns the user-facing objects and the generators
live in the sibling modules:

  * `repro_torch.workloads.traces` — loadable region traces
    (generalizing the hard-coded `traffic.TRACE_PROFILES`);
  * `repro_torch.workloads.synthetic` — adversarial phase-alternating
    and hotspot-drift schedules.

The port's copy of `repro.workloads.schedule`.  A single uniform phase
at intensity 1 with no burst modulation reproduces the static-traffic
simulator counters bitwise (tests/test_torch_workloads.py) — the
workload path strictly generalizes the static path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .simulator import SchedSpec, make_sched_spec
from .topology import Topology


@dataclasses.dataclass
class Phase:
    """One workload phase: (traffic, intensity, duration, burstiness).

    traffic may be any non-negative [N, N] matrix (raw bytes, flow
    counts, probabilities) — rows are normalized into destination
    distributions and relative injection weights at compile time.
    intensity multiplies the offered rate for the whole phase; burst_on/
    burst_off > 0 add ON/OFF modulation within it (mean-preserving when
    the duration is a multiple of the burst period).
    """
    traffic: np.ndarray
    intensity: float = 1.0
    duration: int = 500
    burst_on: int = 0
    burst_off: int = 0
    label: str = ""


@dataclasses.dataclass
class Schedule:
    """An ordered list of phases, replayed cyclically by the simulator."""
    phases: list[Phase]
    name: str = "workload"

    @property
    def n(self) -> int:
        return int(np.asarray(self.phases[0].traffic).shape[0])

    @property
    def total_cycles(self) -> int:
        return sum(p.duration for p in self.phases)

    def compile(self) -> SchedSpec:
        """Compile to the simulator's dense [K, ...] representation."""
        return make_sched_spec(
            [(p.traffic, p.intensity, p.duration, p.burst_on, p.burst_off)
             for p in self.phases])

    def mean_traffic(self) -> np.ndarray:
        """Time-averaged offered-demand matrix (for analytic seeding).

        Each phase contributes its row-normalized matrix scaled by its
        injection weights and intensity, weighted by duration (burst
        modulation is mean-preserving, so it drops out).
        """
        n = self.n
        acc, wsum = np.zeros((n, n)), 0.0
        for p in self.phases:
            m = np.asarray(p.traffic, np.float64)
            rows = m.sum(axis=1, keepdims=True)
            dist = np.divide(m, rows, out=np.zeros_like(m), where=rows > 0)
            inj = rows.ravel() / max(rows.max(), 1e-12)
            w = float(p.intensity) * p.duration
            acc += w * inj[:, None] * dist
            wsum += p.duration
        return acc / max(wsum, 1e-12)

    def scaled(self, factor: float) -> "Schedule":
        """Copy with durations scaled by `factor` (floor 1 cycle)."""
        return Schedule(
            phases=[dataclasses.replace(
                p, duration=max(int(round(p.duration * factor)), 1))
                for p in self.phases],
            name=self.name)

    def fit(self, total_cycles: int) -> "Schedule":
        """Rescale so the schedule totals exactly `total_cycles`.

        Keeps phase-duration ratios (rounding absorbed by the longest
        phase).  The sweep engine fits schedules to the simulator's
        measurement window so one replay covers every phase exactly
        once — otherwise a schedule longer than the simulated cycle
        count would never reach its tail phases.
        """
        if total_cycles < len(self.phases):
            raise ValueError(f"cannot fit {len(self.phases)} phases into "
                             f"{total_cycles} cycles")
        out = self.scaled(total_cycles / self.total_cycles)
        # absorb the rounding residual longest-phase-first; a negative
        # residual may exceed one phase's slack (many 1-cycle phases), so
        # keep distributing until it is gone — the guard above ensures
        # the all-phases-at-1 floor can always be reached
        diff = total_cycles - out.total_cycles
        while diff:
            longest = max(range(len(out.phases)),
                          key=lambda i: out.phases[i].duration)
            p = out.phases[longest]
            take = diff if diff > 0 else max(diff, 1 - p.duration)
            out.phases[longest] = dataclasses.replace(
                p, duration=p.duration + take)
            diff -= take
        assert out.total_cycles == total_cycles
        return out


def static_schedule(traffic: np.ndarray, cycles: int,
                    name: str = "static") -> Schedule:
    """Single-phase schedule equivalent to static traffic (bitwise)."""
    return Schedule([Phase(traffic=traffic, intensity=1.0,
                           duration=cycles, label="static")], name=name)


@dataclasses.dataclass
class Workload:
    """A named, topology-independent schedule builder.

    The sweep engine crosses workloads with topology cases; `build` is
    called once per topology to materialize the [N, N] phase matrices at
    that topology's size and placement.
    """
    name: str
    build: Callable[[Topology], Schedule]

    def __call__(self, topo: Topology) -> Schedule:
        return self.build(topo)
