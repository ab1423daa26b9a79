"""Batched multi-topology sweep engine (DESIGN.md §6).

The port of `repro.sweep.engine`.  `SweepEngine` runs "K topologies x R
injection rates" as a handful of batched simulations: specs are grouped
by *bucketed* padded shape (dims rounded up to fixed multiples, batch
size rounded up by replicating the last spec, rate rows rounded up by
repeating the last rate, and in workload mode the phase axis rounded up
to `K_ROUND`) — the same bucketing as the reference, so a group here
simulates the same rows as a compiled program there — and padding
invariance (see `repro_torch.sweep.padding`) keeps results
bitwise-equal to the single-spec path.  This module owns that policy:
`group_key` and `merged_key` decide a group, for the engine and for the
experiment planner alike.

The port compiles nothing per shape: `stats["compiles"]` and the
`sweep.compiles` counter stay 0, and every group counts as a reuse.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np

from ..core import simulator as sim
from ..core import topology as T
from ..core import traffic as TR
from ..core.routing import cached_routing
from ..core.simulator import SimConfig, SimSpec
from ..obs.metrics import metrics
from ..obs.trace import trace

from .padding import PadShape


class SweepCase(NamedTuple):
    """One (topology, size, substrate, traffic) evaluation cell."""
    name: str
    n: int
    substrate: str = "organic"
    pattern: str = "uniform"
    area: float = 74.0
    roles: str = "homogeneous"

    def build(self) -> tuple:
        """(routing, traffic matrix) for this cell, via the shared cache."""
        topo, routing = cached_routing(self.name, self.n, self.substrate,
                                       self.area, self.roles)
        return routing, TR.PATTERNS[self.pattern](topo)

    @property
    def valid(self) -> bool:
        return T.valid_n(self.name, self.n)


# The bucketing policy.  These are the reference engine's defaults, so the
# port's groups, per-spec `pad_fill` and plan keys equal the reference's.
S_ROUND = 4     # batch axis rounded up to a multiple of this
R_ROUND = 4     # rate axis rounded up to a multiple of this
N_MULT, C_MULT, D_MULT = 8, 32, 4    # node, channel and link-ring buckets
K_ROUND = 2     # phase axis (workload mode) bucket


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def merged_key(specs: Sequence[SimSpec], scheds: Sequence
               ) -> tuple[PadShape, int]:
    """The group of `specs` run as one batch, each with its compiled
    schedule (None for a static spec): the padded shape that covers them
    all with its dims rounded up to their buckets, and the largest phase
    count rounded up to `K_ROUND` (0 for static specs)."""
    sh = PadShape.of(specs)
    return (PadShape(n=_round_up(sh.n, N_MULT), p=sh.p,
                     c=_round_up(sh.c, C_MULT), d=_round_up(sh.d, D_MULT)),
            max(_round_up(sc.k, K_ROUND) if sc is not None else 0
                for sc in scheds))


def group_key(spec: SimSpec, sched=None) -> tuple[PadShape, int]:
    """The group of one spec and its compiled schedule (None for a static
    spec), as `merged_key` gives it."""
    return merged_key([spec], [sched])


@dataclasses.dataclass
class SweepEngine:
    """Padded-batch sweep runner.  `device` is passed to
    `simulator.run_batch`: None is the CUDA card, "cpu" the CPU."""
    cfg: SimConfig = SimConfig()
    device: object = None

    def __post_init__(self):
        self.stats = dict(runs=0, groups=0, specs=0, compiles=0, reuses=0)

    # ---- core entry points ---------------------------------------------
    def run_specs(self, specs: Sequence[SimSpec], rates,
                  single_program: bool = False,
                  cfg: SimConfig | None = None) -> list[dict]:
        """Run heterogeneous specs through few batched simulations.

        rates: [R] shared or [S, R] per-spec.  Returns one result dict
        per spec (same keys as `simulator.run_batch`), in input order.
        single_program=True pads every spec to one global shape, so the
        whole sweep is one group (at the cost of padding small-radix
        topologies to the largest radix present).  `cfg` overrides the
        engine's SimConfig for this call only.
        """
        return self._run_grouped(specs, rates, None, single_program, cfg)

    def run_workloads(self, specs: Sequence[SimSpec], schedules, rates,
                      single_program: bool = False,
                      cfg: SimConfig | None = None) -> list[dict]:
        """Run (spec, phase-schedule) pairs through few batched
        simulations.

        schedules: one `simulator.SchedSpec` (or compilable
        `workloads.Schedule`) per spec.  Groups also bucket the phase
        axis (`K_ROUND`) so workloads with similar phase counts share a
        group.  Result dicts gain the per-phase counters of
        `run_batch(..., schedules=...)`.  `cfg` as in `run_specs`.
        """
        if len(schedules) != len(specs):
            raise ValueError(
                f"schedules {len(schedules)} != specs {len(specs)}")
        schedules = [s.compile() if hasattr(s, "compile") else s
                     for s in schedules]
        return self._run_grouped(specs, rates, schedules, single_program,
                                 cfg)

    # result keys whose leading axis is NOT the rate axis — never
    # sliced back to n_rates when rate-padding is trimmed
    _PER_PHASE_KEYS = ("phase_cycles", "window_cycles")

    def _run_grouped(self, specs, rates, schedules, single_program,
                     cfg: SimConfig | None = None):
        cfg = cfg or self.cfg
        s = len(specs)
        rates = np.asarray(rates, np.float32)
        if rates.ndim == 1:
            rates = np.broadcast_to(rates, (s, rates.shape[0])).copy()
        n_rates = rates.shape[1]
        r_pad = _round_up(n_rates, R_ROUND)
        scheds = schedules if schedules is not None else [None] * s

        groups: dict[tuple[PadShape, int], list[int]] = {}
        if single_program:
            groups[merged_key(specs, scheds)] = list(range(s))
        else:
            for i, spec in enumerate(specs):
                groups.setdefault(group_key(spec, scheds[i]), []).append(i)

        results: list = [None] * s
        for (shape, k_pad), idxs in groups.items():
            g_specs = [specs[i] for i in idxs]
            g_scheds = [schedules[i] for i in idxs] \
                if schedules is not None else None
            g_rates = rates[idxs]
            if r_pad > n_rates:
                g_rates = np.concatenate(
                    [g_rates,
                     np.repeat(g_rates[:, -1:], r_pad - n_rates, axis=1)],
                    axis=1)
            s_live = len(g_specs)
            s_pad = _round_up(s_live, S_ROUND)
            while len(g_specs) < s_pad:           # replicate an inert tail
                g_specs.append(g_specs[-1])
                g_rates = np.concatenate([g_rates, g_rates[-1:]], axis=0)
                if g_scheds is not None:
                    g_scheds.append(g_scheds[-1])
            # bucket-fill attrs (DESIGN.md §16): live vs padded batch
            # rows/rates — with the per-spec pad_fill fractions on the
            # results, the complete pad-waste picture for this group
            with trace("sweep.group", cat="sweep", specs=len(g_specs),
                       shape=str(shape), k_pad=k_pad,
                       s_live=s_live, s_pad=s_pad,
                       r_live=n_rates, r_pad=g_rates.shape[1],
                       kind="static" if g_scheds is None else "workload"):
                out = sim.run_batch(g_specs, g_rates, cfg,
                                    pad_shape=shape, schedules=g_scheds,
                                    k_pad=k_pad or None,
                                    device=self.device)
            metrics.observe("sweep.bucket_fill", s_live / s_pad)
            for j, i in enumerate(idxs):
                results[i] = {
                    k: (v[:n_rates] if isinstance(v, np.ndarray)
                        and k not in self._PER_PHASE_KEYS else v)
                    for k, v in out[j].items()}
        # the port compiles nothing per shape: no group is a compile, so
        # `compiles` stays 0 and every group is a reuse
        self.stats["runs"] += 1
        self.stats["groups"] += len(groups)
        self.stats["specs"] += s
        self.stats["reuses"] += len(groups)
        metrics.inc("sweep.runs")
        metrics.inc("sweep.groups", len(groups))
        metrics.inc("sweep.specs", s)
        metrics.inc("sweep.compiles", 0)
        return results
