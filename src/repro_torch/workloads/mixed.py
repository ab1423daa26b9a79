"""Mixed-tenant workloads: serving traffic under a training step.

The port of `repro.workloads.mixed` (numpy; same schedules as the JAX
package's).

The production scenario the paper never measures (ROADMAP "Resilience
and multi-tenant serving"): one package simultaneously runs a training
job — whose collectives arrive in phases (`collective_workload`) — and
a serving tenant whose request/KV-cache traffic is a steady background
pattern.  `superimpose` blends a background matrix into every phase of
a schedule; `mixed_tenant_workload` packages the common case (training
collectives + a named serving pattern) for the sweep engine and the
fault-degradation benchmark (DESIGN.md §12).

Blending happens in *offered-demand* space: each phase's raw flow
matrix is converted to its demand matrix (row-normalized destinations
scaled by the phase's relative injection weights — exactly the terms of
`Schedule.mean_traffic`), then mixed as

    demand' = (1 - serve_frac) * demand_phase + serve_frac * serving

so `serve_frac` is the serving tenant's share of every phase's offered
load, independent of how bytes were scaled in the raw collectives.
`serve_frac=0` returns phases whose demand equals the original
schedule's demand; `serve_frac=1` is pure serving traffic paced by the
training phases' durations.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import traffic as TR
from ..core.topology import Topology

from .collective import collective_workload
from .schedule import Phase, Schedule, Workload


def _phase_demand(p: Phase) -> np.ndarray:
    """One phase's offered-demand matrix (rows sum to the phase's
    relative per-source injection rate, peak row = intensity)."""
    m = np.asarray(p.traffic, np.float64)
    rows = m.sum(axis=1, keepdims=True)
    dist = np.divide(m, rows, out=np.zeros_like(m), where=rows > 0)
    inj = rows.ravel() / max(rows.max(), 1e-12)
    return float(p.intensity) * inj[:, None] * dist


def superimpose(schedule: Schedule, background: np.ndarray,
                frac: float, name: str | None = None) -> Schedule:
    """Blend a steady `background` demand matrix into every phase.

    background: [N, N] non-negative matrix (rows are destination
    distributions — any `traffic.PATTERNS` output qualifies); frac in
    [0, 1] is the background tenant's share of each phase's offered
    load.  Phase durations, labels and burst modulation are preserved;
    intensities are folded into the blended matrices (the demand
    construction already carries them)."""
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"frac must be in [0, 1], got {frac}")
    bg = np.asarray(background, np.float64)
    n = schedule.n
    if bg.shape != (n, n):
        raise ValueError(f"background shape {bg.shape} != ({n}, {n})")
    phases = []
    for p in schedule.phases:
        blended = (1.0 - frac) * _phase_demand(p) + frac * bg
        # the schedule compiler renormalizes injection weights by each
        # phase's peak row, so the blended matrix's absolute demand is
        # carried in the intensity (inj_w * intensity == row sums)
        phases.append(dataclasses.replace(
            p, traffic=blended,
            intensity=float(blended.sum(axis=1).max())))
    return Schedule(phases, name=name or f"{schedule.name}+bg{frac:g}")


def mixed_tenant_workload(config, topo: Topology, *,
                          serve_pattern: str = "uniform",
                          serve_frac: float = 0.3,
                          **collective_kw) -> Schedule:
    """Training collectives of `config` + a serving tenant on `topo`.

    The serving tenant offers `serve_frac` of every phase's load as the
    named static pattern (requests and KV-cache reads spread over the
    package); the remaining (1 - serve_frac) is the training step's
    phase-varying collective traffic."""
    train = collective_workload(config, topo, **collective_kw)
    bg = TR.PATTERNS[serve_pattern](topo)
    return superimpose(
        train, bg, serve_frac,
        name=f"mixed:{config.name}+{serve_pattern}{serve_frac:g}")


def mixed_tenant(config, serve_pattern: str = "uniform",
                 serve_frac: float = 0.3, **kw) -> Workload:
    """`Workload` wrapper for the sweep engine / experiment scenarios."""
    return Workload(
        name=f"mixed:{config.name}+{serve_pattern}{serve_frac:g}",
        build=lambda topo: mixed_tenant_workload(
            config, topo, serve_pattern=serve_pattern,
            serve_frac=serve_frac, **kw))
