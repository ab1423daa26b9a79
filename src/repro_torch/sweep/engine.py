"""Batched multi-topology sweep engine (DESIGN.md §6).

The port of `repro.sweep.engine`.  `SweepEngine` runs "K topologies x R
injection rates" as a handful of batched simulations: specs are grouped
by *bucketed* padded shape (dims rounded up to configurable multiples,
batch size rounded up by replicating the last spec, rate rows rounded
up by repeating the last rate, and in workload mode the phase axis
rounded up to `k_round`) — the same bucketing as the reference, so a
group here simulates the same rows as a compiled program there — and
padding invariance (see `repro_torch.sweep.padding`) keeps results
bitwise-equal to the single-spec path.

The port compiles nothing per shape: `stats["compiles"]` and the
`sweep.compiles` counter stay 0, and every group counts as a reuse.

Case-level evaluation lives in the experiment API
(`repro_torch.experiments`): `evaluate_cases`, `evaluate_workload_cases`
and `sweep` are deprecation shims forwarding there; `run_specs` /
`run_workloads` are the primitive layer the experiment executor lowers
onto.
"""
from __future__ import annotations

import dataclasses
import warnings
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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m if m > 1 else x


@dataclasses.dataclass
class SweepEngine:
    """Padded-batch sweep runner.

    bucket=False disables shape rounding (every distinct max-shape gets
    its own group).  `device` is passed to `simulator.run_batch`: None
    is the CUDA card, "cpu" the CPU.
    """
    cfg: SimConfig = SimConfig()
    bucket: bool = True
    s_round: int = 4         # batch axis rounded up to a multiple of this
    r_round: int = 4         # rate axis rounded up to a multiple of this
    n_mult: int = 8          # node-dim bucket
    c_mult: int = 32         # channel-dim bucket
    d_mult: int = 4          # link-ring bucket
    k_round: int = 2         # phase axis (workload mode) bucket
    device: object = None

    def __post_init__(self):
        self.stats = dict(runs=0, groups=0, specs=0, compiles=0, reuses=0)

    # ---- shape policy --------------------------------------------------
    def bucket_shape(self, shape: PadShape) -> PadShape:
        if not self.bucket:
            return shape
        return PadShape(n=_round_up(shape.n, self.n_mult),
                        p=shape.p,
                        c=_round_up(shape.c, self.c_mult),
                        d=_round_up(shape.d, self.d_mult))

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
        axis (`k_round`) so workloads with similar phase counts share a
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
        r_pad = _round_up(n_rates, self.r_round) if self.bucket else n_rates

        def k_bucket(i: int) -> int:
            if schedules is None:
                return 0
            k = schedules[i].k
            return _round_up(k, self.k_round) if self.bucket else k

        groups: dict[tuple[PadShape, int], list[int]] = {}
        if single_program:
            key = (self.bucket_shape(PadShape.of(specs)),
                   max(k_bucket(i) for i in range(s)))
            groups[key] = list(range(s))
        else:
            for i, spec in enumerate(specs):
                key = (self.bucket_shape(
                    PadShape(n=spec.n, p=spec.p, c=spec.c, d=spec.d)),
                    k_bucket(i))
                groups.setdefault(key, []).append(i)

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
            s_pad = _round_up(s_live, self.s_round) \
                if self.bucket else s_live
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

    # ---- case-level deprecation shims ----------------------------------
    # Case-level evaluation lives in the declarative experiment API
    # (repro_torch.experiments, DESIGN.md §10).  These shims forward to
    # it and reshape the ResultFrame into the legacy list-of-dicts.

    def _experiment_frame(self, scenarios):
        from .. import experiments as X
        exp = X.Experiment(scenarios, cfg=self.cfg, name="legacy_shim")
        return X.execute(X.plan(exp, engine=self), engine=self)

    def evaluate_cases(self, cases: Sequence[SweepCase],
                       n_rates: int = 6) -> list[dict | None]:
        """DEPRECATED: use `repro_torch.experiments.run` on an
        `Experiment` of static `Scenario`s.

        Simulated saturation for many cells; invalid cells yield None.
        """
        warnings.warn(
            "SweepEngine.evaluate_cases is deprecated; build an "
            "Experiment of Scenarios and call repro_torch.experiments.run",
            DeprecationWarning, stacklevel=2)
        from .. import experiments as X
        frame = self._experiment_frame(
            [X.scenario_from_case(c, rates=X.SaturationGrid(n_rates))
             for c in cases])
        out = []
        for i, case in enumerate(cases):
            res = frame.case_result(i)
            if res is not None:
                res["case"] = case
            out.append(res)
        return out

    def evaluate_workload_cases(self, cases: Sequence[SweepCase],
                                workloads: Sequence, n_rates: int = 5,
                                fit: bool = True) -> list[dict | None]:
        """DEPRECATED: use `repro_torch.experiments.run` on an
        `Experiment` whose Scenarios carry the workloads as their
        `traffic`.

        Returns len(cases) * len(workloads) rows in case-major order;
        invalid cases yield None rows.
        """
        warnings.warn(
            "SweepEngine.evaluate_workload_cases is deprecated; build "
            "an Experiment of workload Scenarios and call "
            "repro_torch.experiments.run", DeprecationWarning,
            stacklevel=2)
        from .. import experiments as X
        frame = self._experiment_frame(
            [dataclasses.replace(
                X.scenario_from_case(case, traffic=wl,
                                     rates=X.SaturationGrid(n_rates)),
                fit_schedule=fit)
             for case in cases for wl in workloads])
        out = []
        for ci, case in enumerate(cases):
            for wi in range(len(workloads)):
                res = frame.workload_result(ci * len(workloads) + wi)
                if res is not None:
                    res["case"] = case
                out.append(res)
        return out

    def sweep(self, names: Sequence[str], n: int, substrate: str = "organic",
              pattern: str = "uniform", area: float = 74.0,
              roles: str = "homogeneous", n_rates: int = 6) -> list[dict]:
        """Evaluate several topologies at one size in one batched sweep
        (a thin convenience over `repro_torch.experiments.run`)."""
        from .. import experiments as X
        frame = self._experiment_frame(
            [X.Scenario(name, n, substrate, pattern, area, roles,
                        rates=X.SaturationGrid(n_rates))
             for name in names])
        rows = []
        for i, name in enumerate(names):
            res = frame.case_result(i)
            if res is None:
                continue
            rows.append(dict(topology=name, n=n, substrate=substrate,
                             pattern=pattern,
                             sim_saturation=res["sim_saturation"],
                             analytic_saturation=res["analytic_saturation"],
                             latency_at_sat=res["latency_at_sat"]))
        return rows


def default_engine(device=None) -> SweepEngine:
    """Process-wide engine for the default SimConfig on `device` (None:
    the card).  Forwards to the experiment executor's per-(config,
    device) registry so legacy callers and the declarative pipeline
    share one engine (and its stats)."""
    from ..experiments import engine_for
    return engine_for(SimConfig(), device)
