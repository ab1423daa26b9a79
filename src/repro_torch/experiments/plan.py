"""Experiment planner (DESIGN.md §10): Scenario -> engine-ready buckets.

The port's copy of `repro.experiments.plan`: the same buckets, skip
reasons and diagnostic codes, static and adaptive routing alike.

`plan(experiment)` resolves every scenario against the real registries
— N-constraints from `topology.N_CONSTRAINTS`, routing via the shared
`cached_routing`, traffic patterns / workload schedules, per-scenario
rate grids — and groups the survivors into *buckets* that lower 1:1
onto `SweepEngine` padded batches:

  * bucket key = (kind, R, bucketed PadShape, bucketed phase count),
    from the engine's `group_key` / `merged_key`, so one bucket is one
    engine group;
  * static scenarios and workload scenarios flow through the same
    pipeline — a workload scenario simply carries a compiled
    `SchedSpec` next to its `SimSpec` (its spec's traffic matrix is the
    schedule's time-averaged demand, used only for analytic seeding);
  * invalid scenarios are *skipped with a reason*, never silently
    dropped — the executor emits a `status="invalid"` row for each.

Planning is cheap (no simulation) and deterministic; the plan can be
inspected (`Plan.describe()`) before committing to execution.  It is
span-traced (DESIGN.md §13): an `experiment.plan` span over each
scenario's `plan.traffic` (the traffic matrix or schedule) and
`plan.spec` (the `SimSpec`, the compiled schedule and the rate grid)
spans, with the scenario's `topology` and `n`; routing tables that are
built anew are `routing.build` spans.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import placement as pl
from ..core import topology as T
from ..core import traffic as TR
from ..core.routing import cached_routing, routing_for, saturation_from_loads
from ..core.simulator import SimSpec, make_spec
from ..faults import FaultError
from ..obs.trace import trace
from ..sweep.engine import SweepEngine, group_key, merged_key
from ..sweep.padding import PadShape

from .scenario import CustomTraffic, Experiment, Scenario


@dataclasses.dataclass
class PlannedScenario:
    """One validated, resolved scenario, ready for the engine."""
    index: int                  # position in experiment.scenarios
    scenario: Scenario
    topo: object
    routing: object
    traffic: np.ndarray         # static matrix, or schedule mean demand
    analytic: float             # channel-load saturation bound
    avg_hops: float             # traffic-weighted hop count
    zero_load_cycles: float     # traffic-weighted zero-load latency
    spec: SimSpec | None        # None on the analytic backend
    schedule: object | None     # fitted workloads.Schedule (labels)
    sched_spec: object | None   # compiled simulator.SchedSpec
    rates: np.ndarray | None    # [R] resolved offered-rate grid


@dataclasses.dataclass(frozen=True)
class BucketKey:
    kind: str                   # "static" | "workload" | "analytic"
    n_rates: int
    shape: PadShape | None      # engine-bucketed padded shape
    k_pad: int                  # bucketed phase-axis size (0 = static)
    #: effective routing mode ("static" | "adaptive"); part of the key
    #: because the two modes run different step functions (DESIGN.md §15)
    routing: str = "static"


@dataclasses.dataclass
class Bucket:
    key: BucketKey
    items: list


@dataclasses.dataclass
class Plan:
    experiment: Experiment
    buckets: list
    skipped: list               # [(scenario index, reason)]
    single_program: bool = False
    #: scenario index -> diagnostic code for each skip (DESIGN.md §14);
    #: `skipped` keeps its legacy (index, reason) shape, the code rides
    #: here so `ResultFrame` invalid rows carry a machine-readable
    #: `diag_code` alongside the byte-identical reason string
    skip_codes: dict = dataclasses.field(default_factory=dict)

    @property
    def n_planned(self) -> int:
        return sum(len(b.items) for b in self.buckets)

    def describe(self) -> str:
        lines = [f"plan[{self.experiment.name}]: "
                 f"{len(self.experiment)} scenarios -> "
                 f"{self.n_planned} planned in {len(self.buckets)} "
                 f"bucket(s), {len(self.skipped)} skipped"]
        for b in self.buckets:
            k = b.key
            shape = (f"N{k.shape.n} P{k.shape.p} C{k.shape.c} D{k.shape.d}"
                     if k.shape else "-")
            lines.append(f"  [{k.kind:8s}] R={k.n_rates} K={k.k_pad} "
                         f"routing={k.routing} shape=({shape}) "
                         f"x{len(b.items)}")
        for i, reason in self.skipped:
            lines.append(f"  skip #{i}: {reason}")
        return "\n".join(lines)


def resolve_topology(scenario: Scenario):
    """(topo, routing) for a scenario's topology source.

    Registry names go through `cached_routing`; `Topology` objects and
    generator callables are validated here and routed via the
    structural-hash cache (`routing_for`) — name collisions between
    synthesized candidates are harmless by construction.

    A `Topology` object keeps its own substrate/area unless the
    scenario names them explicitly (`Scenario.resolved_substrate`), in
    which case it is re-stamped; a non-default `roles` scheme is
    re-applied to it so the result row's `roles` column always
    describes the traffic actually run — with the default scheme the
    object's own (possibly hand-assigned) roles are kept.

    A degraded scenario (`Scenario.faults` non-empty) resolves its base
    topology the same way, then lowers the fault set onto it
    (`FaultSet.apply`: masked edge list, survivors-connected check) and
    routes the *degraded* structure — `routing_for` keys on the
    structural hash, so pristine and every distinct fault mask each get
    their own cached routing, and an empty fault set shares the
    pristine entry bitwise.
    """
    s = scenario
    substrate, area = s.resolved_substrate, s.resolved_area
    if isinstance(s.topology, str):
        if not s.degraded:
            return cached_routing(s.topology, s.n, substrate, area,
                                  s.roles)
        # fault path: build the (cheap) base topology without routing
        # the pristine structure — only the degraded one is simulated
        topo = s.faults.apply(
            T.build(s.topology, s.n, substrate=substrate,
                    chiplet_area_mm2=area, roles_scheme=s.roles))
        return topo, routing_for(topo)
    src = s.topology if isinstance(s.topology, T.Topology) \
        else s.topology(s.n)            # generator callable
    if isinstance(src, T.Topology):
        topo = src
        if topo.n != s.n:
            raise ValueError(f"scenario n={s.n} != topology n={topo.n} "
                             f"({topo.name})")
        if topo.substrate != substrate or \
                topo.chiplet_area_mm2 != area:
            topo = dataclasses.replace(topo, substrate=substrate,
                                       chiplet_area_mm2=area)
        if s.roles != "homogeneous":
            topo = dataclasses.replace(
                topo, roles=pl.assign_roles(topo.pos, s.roles))
        T.validate_edges(topo.n, topo.edges, name=topo.name)
    else:                               # generator returned (name, pos, edges)
        name, pos, edges = src
        topo = T.make_topology(name, pos, edges, substrate=substrate,
                               chiplet_area_mm2=area,
                               roles_scheme=s.roles)
        if topo.n != s.n:
            raise ValueError(f"scenario n={s.n} != generated n={topo.n} "
                             f"({topo.name})")
    if s.degraded:
        topo = s.faults.apply(topo)
    return topo, routing_for(topo)


def _resolve_traffic(scenario: Scenario, topo, meas: int):
    """(static matrix | schedule mean, fitted Schedule | None).

    On a degraded scenario with dead chiplets, static matrices and
    every schedule phase are masked (`FaultSet.mask_traffic`): dead
    chiplets neither inject nor receive, and survivors' destination
    rows are renormalized.  Link-only fault sets leave traffic
    untouched (masking is a no-op without dead chiplets)."""
    tr = scenario.traffic
    fs = scenario.faults if scenario.degraded else None
    if isinstance(tr, str):
        if tr not in TR.PATTERNS:
            raise KeyError(f"unknown traffic pattern {tr!r}; choose from "
                           f"{sorted(TR.PATTERNS)} or pass a Workload")
        tm = TR.PATTERNS[tr](topo)
        return (fs.mask_traffic(tm) if fs is not None else tm), None
    if isinstance(tr, CustomTraffic):
        tm = np.asarray(tr.build(topo), np.float64)
        return (fs.mask_traffic(tm) if fs is not None else tm), None
    schedule = tr.build(topo) if hasattr(tr, "build") else tr(topo)
    if not hasattr(schedule, "mean_traffic"):
        raise TypeError(
            f"traffic callable {getattr(tr, 'name', tr)!r} returned "
            f"{type(schedule).__name__}, not a workloads.Schedule; wrap "
            "plain topo -> matrix builders in experiments.CustomTraffic")
    if fs is not None:
        schedule = fs.mask_schedule(schedule)
    if scenario.fit_schedule:
        schedule = schedule.fit(meas)
    return schedule.mean_traffic(), schedule


def plan(experiment: Experiment, engine: SweepEngine | None = None,
         single_program: bool = False) -> Plan:
    """Validate + resolve every scenario and bucket them for execution.

    The buckets are the engine's groups (`sweep.engine.group_key`);
    `engine` is accepted in the reference's signature and unused, since
    the bucketing is fixed.  Planning never runs anything.

    single_program=True coalesces all scenarios of one (kind, R, phase
    bucket) into a single bucket that the executor runs as ONE batch
    padded to the group's max shape (the engine's
    `run_specs(..., single_program=True)` mode) — fewer groups at the
    cost of padding small topologies to the largest shape present.
    """
    meas = experiment.cfg.cycles - experiment.cfg.warmup
    sim_backend = experiment.backend == "sim"
    buckets: dict[BucketKey, Bucket] = {}
    skipped: list = []
    skip_codes: dict = {}
    with trace("experiment.plan", cat="experiments",
               experiment=experiment.name,
               scenarios=len(experiment.scenarios)):
        for i, s in enumerate(experiment.scenarios):
            if not s.valid:
                skipped.append((i, f"{s.topology_name} does not support "
                                   f"N={s.n} (topology.N_CONSTRAINTS)"))
                skip_codes[i] = "DP006"
                continue
            try:
                topo, routing = resolve_topology(s)
            except FaultError as e:
                # un-applyable fault set (disconnects the survivors,
                # names a non-existent link, ...): skip with the
                # sampler-actionable reason rather than aborting the grid
                skipped.append((i, f"fault set rejected: {e}"))
                skip_codes[i] = "FT001"
                continue
            with trace("plan.traffic", cat="experiments",
                       topology=s.topology_name, n=s.n):
                tm, schedule = _resolve_traffic(s, topo, meas)
            # one routing walk gives the bound and the tidy row's
            # traffic-weighted hops and zero-load latency
            loads, hops, lat = routing.paths_channel_loads(tm)
            analytic = saturation_from_loads(loads, tm)
            w = tm / max(tm.sum(), 1e-12)
            eff = s.effective_routing(experiment.cfg)
            spec = sched_spec = rates = None
            if sim_backend:
                with trace("plan.spec", cat="experiments",
                           topology=s.topology_name, n=s.n):
                    spec = make_spec(routing, tm)
                    sched_spec = schedule.compile() \
                        if schedule is not None else None
                    rates = np.asarray(
                        s.rates.resolve(analytic, routing=eff), np.float64)
                shape, k_pad = group_key(spec, sched_spec)
                key = BucketKey(kind=s.kind, n_rates=len(rates),
                                shape=shape, k_pad=k_pad, routing=eff)
            else:
                key = BucketKey(kind="analytic", n_rates=0, shape=None,
                                k_pad=0, routing=eff)
            ps = PlannedScenario(index=i, scenario=s, topo=topo,
                                 routing=routing, traffic=tm,
                                 analytic=analytic,
                                 avg_hops=float((hops * w).sum()),
                                 zero_load_cycles=float((lat * w).sum()),
                                 spec=spec,
                                 schedule=schedule, sched_spec=sched_spec,
                                 rates=rates)
            buckets.setdefault(key,
                               Bucket(key=key, items=[])).items.append(ps)
    out = list(buckets.values())
    if single_program and sim_backend:
        merged: dict[tuple, Bucket] = {}
        for b in out:
            # routing is part of the merge key: the two modes run
            # different step functions, so they can never share a batch
            mk = (b.key.kind, b.key.n_rates, b.key.routing)
            if mk not in merged:
                merged[mk] = Bucket(key=b.key, items=list(b.items))
            else:
                m = merged[mk]
                m.items += b.items
                shape, k_pad = merged_key(
                    [ps.spec for ps in m.items],
                    [ps.sched_spec for ps in m.items])
                m.key = BucketKey(kind=b.key.kind, n_rates=b.key.n_rates,
                                  shape=shape, k_pad=k_pad,
                                  routing=b.key.routing)
        out = list(merged.values())
    return Plan(experiment=experiment, buckets=out, skipped=skipped,
                single_program=single_program, skip_codes=skip_codes)
