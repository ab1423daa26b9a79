"""Adversarial / synthetic phase schedules (DESIGN.md §9).

Stationary synthetic patterns (uniform, tornado, ...) miss the failure
modes of phased traffic: a topology can look fine under each pattern in
isolation yet thrash when the pattern *changes* while queues still hold
the previous phase's flits.  These generators build such schedules from
the static pattern library in `repro_torch.core.traffic`.  The port's
copy of `repro.workloads.synthetic`: the same seeded draws, so the same
schedules.
"""
from __future__ import annotations

import numpy as np

from . import traffic as TR
from .topology import Topology

from .schedule import Phase, Schedule


def phase_alternating(topo: Topology, patterns=("tornado", "uniform"),
                      phase_cycles: int = 300, repeats: int = 2,
                      intensities=None, burst: tuple[int, int] = (0, 0),
                      ) -> Schedule:
    """Cycle through static patterns: tornado↔uniform by default.

    The alternation is adversarial for routings tuned to either pattern
    alone — buffered tornado flits congest the uniform phase and vice
    versa.  `intensities` optionally scales each pattern's phase.
    """
    intensities = intensities or [1.0] * len(patterns)
    phases = []
    for _ in range(repeats):
        for pat, inten in zip(patterns, intensities):
            phases.append(Phase(
                traffic=TR.PATTERNS[pat](topo), intensity=float(inten),
                duration=phase_cycles, burst_on=burst[0],
                burst_off=burst[1], label=pat))
    return Schedule(phases, name="alt:" + "-".join(patterns))


def hotspot_drift(topo: Topology, n_phases: int = 6, dwell: int = 200,
                  hot_frac: float = 0.6, n_hotspots: int = 1,
                  seed: int = 0) -> Schedule:
    """A drifting hotspot: every phase, `hot_frac` of all traffic aims at
    the current hotspot chiplet(s); the rest is uniform.  Hotspots drift
    pseudo-randomly across the placement, modelling a migrating shard or
    a hot parameter server."""
    n = topo.n
    rng = np.random.default_rng(seed)
    u = TR.uniform(topo)
    phases = []
    for k in range(n_phases):
        hots = rng.choice(n, size=min(n_hotspots, n), replace=False)
        m = (1.0 - hot_frac) * u
        m[:, hots] += hot_frac / len(hots)
        np.fill_diagonal(m, 0.0)
        phases.append(Phase(traffic=m, intensity=1.0, duration=dwell,
                            label=f"hot@{','.join(map(str, hots))}"))
    return Schedule(phases, name=f"hotspot_drift:{n_hotspots}")


def bursty_uniform(topo: Topology, on: int = 20, off: int = 60,
                   cycles: int = 1000) -> Schedule:
    """Uniform traffic under ON/OFF modulation: the mean offered load
    matches plain uniform, but arrivals come in (on+off)/on-times-denser
    waves — stresses buffer depth rather than bisection."""
    return Schedule([Phase(traffic=TR.uniform(topo), intensity=1.0,
                           duration=cycles, burst_on=on, burst_off=off,
                           label=f"burst{on}/{off}")],
                    name=f"bursty_uniform:{on}/{off}")
