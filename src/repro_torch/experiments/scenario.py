"""Declarative experiment descriptions (DESIGN.md §10).

The port's copy of `repro.experiments.scenario`.

A `Scenario` names ONE evaluation cell of the paper's grids — a
topology at a size, on a substrate, under a traffic source, swept over
an injection-rate policy.  An `Experiment` is an ordered list of
scenarios sharing one `SimConfig` (and a backend: the cycle-accurate
simulator or the analytic channel-load model).  Nothing here runs
anything: `repro_torch.experiments.plan` lowers an experiment onto the
batched sweep engine and `repro_torch.experiments.execute` runs the
plan.

Traffic sources (the `traffic` field) come in three flavours:

  * a `str` — a named static pattern from `core.traffic.PATTERNS`
    ("uniform", "tornado", ...);
  * a `CustomTraffic` — a named `topo -> [N, N] matrix` builder for
    static matrices that are not registry patterns (e.g. one region of
    a Netrace-like trace);
  * a `repro_torch.workloads.Workload` (or any callable
    `topo -> Schedule`)
    — a time-varying phase schedule replayed by the simulator
    (DESIGN.md §9).

Rate policies say which offered rates the sweep visits:

  * `SaturationGrid(n_rates)` — a grid bracketing the scenario's
    analytic channel-load bound (resolved per scenario at plan time,
    exactly `simulator.saturation_rate_grid`);
  * `ExplicitRates(rates)` — a fixed grid shared verbatim.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

import numpy as np

from ..core import topology as T
from ..core.simulator import (SimConfig, routing_headroom,
                              saturation_rate_grid)


# ---------------------------------------------------------------------
# rate policies
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SaturationGrid:
    """Offered-rate grid seeded from the analytic saturation bound.

    `headroom` overrides the grid's ceiling multiplier above the static
    analytic bound; None picks the routing-mode default (static 2x,
    adaptive 3x — adaptive sweeps can exceed the static bound, see
    DESIGN.md §15), so the same policy object works for both modes.
    """
    n_rates: int = 6
    headroom: float | None = None

    def resolve(self, analytic: float,
                routing: str = "static") -> np.ndarray:
        h = self.headroom if self.headroom is not None \
            else routing_headroom(routing)
        return saturation_rate_grid(analytic, self.n_rates, headroom=h)

    def describe(self) -> str:
        if self.headroom is not None:
            return f"saturation_grid({self.n_rates},x{self.headroom:g})"
        return f"saturation_grid({self.n_rates})"


@dataclasses.dataclass(frozen=True)
class ExplicitRates:
    """A fixed offered-rate grid, used verbatim for the scenario."""
    rates: tuple = ()

    def __post_init__(self):
        object.__setattr__(
            self, "rates",
            tuple(float(r) for r in np.ravel(np.asarray(self.rates))))
        if not self.rates:
            raise ValueError("ExplicitRates needs at least one rate")

    def resolve(self, analytic: float,
                routing: str = "static") -> np.ndarray:
        return np.asarray(self.rates, np.float64)

    def describe(self) -> str:
        return "rates(" + ",".join(f"{r:g}" for r in self.rates) + ")"


RatePolicy = SaturationGrid | ExplicitRates


# ---------------------------------------------------------------------
# traffic sources
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CustomTraffic:
    """A named static-traffic builder: `build(topo) -> [N, N]` matrix."""
    name: str
    build: Callable


def traffic_kind(traffic) -> str:
    """'static' for named patterns / CustomTraffic, 'workload' for
    schedule builders (`Workload` or bare `topo -> Schedule`)."""
    if isinstance(traffic, (str, CustomTraffic)):
        return "static"
    if hasattr(traffic, "build") or callable(traffic):
        return "workload"
    raise TypeError(f"unsupported traffic source {traffic!r}")


def traffic_name(traffic) -> str:
    if isinstance(traffic, str):
        return traffic
    name = getattr(traffic, "name", "")
    return str(name) if name else getattr(traffic, "__name__", "custom")


# ---------------------------------------------------------------------
# Scenario / Experiment
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """One evaluation cell: topology x substrate x traffic x rates.

    `topology` is a registry name (built-in Table III or
    a first-class `Topology` object, or a generator callable
    `n -> Topology | (name, pos, edges)`.  Non-string
    topologies are validated and routed at plan time via the
    structural-hash routing cache, so arbitrarily many synthesized
    scenarios can share names without colliding.

    `substrate`/`area` default to None = *inherit*: a `Topology`
    object keeps its own substrate and chiplet area (a glass candidate
    stays glass), registry names and generator callables fall back to
    the paper defaults (organic, 74 mm^2).  Pass explicit values to
    re-stamp a `Topology` onto a different substrate.

    `faults` (a `repro_torch.faults.FaultSet`, DESIGN.md §12) degrades the
    resolved topology before routing: dead links and dead chiplets'
    links are masked out of the edge list, deadlock-free routing is
    rebuilt for the degraded structure (the structural-hash routing
    cache keys it separately from the pristine topology), and traffic
    to/from dead chiplets is masked.  `faults=None` and an *empty*
    `FaultSet` are bitwise identical to each other — the zero-fault
    path is exactly the pristine path.
    """
    topology: object                 # str | Topology | callable(n)
    n: int
    substrate: str | None = None     # None = inherit / organic
    traffic: object = "uniform"      # str | CustomTraffic | Workload
    area: float | None = None        # None = inherit / 74.0
    roles: str = "homogeneous"
    rates: RatePolicy = SaturationGrid()
    fit_schedule: bool = True        # fit workloads to the meas. window
    faults: object = None            # faults.FaultSet | None
    routing: str | None = None       # None = inherit Experiment cfg
    tags: tuple = ()                 # extra ((column, value), ...) pairs

    def __post_init__(self):
        from .frame import COLUMNS   # deferred: frame imports scenario
        bad = [k for k, _ in self.tags if k in COLUMNS]
        if bad:
            raise ValueError(f"tags {bad} collide with reserved result "
                             f"columns; pick different tag names")
        if self.routing not in (None, "static", "adaptive"):
            raise ValueError(f"unknown routing mode {self.routing!r}; "
                             f"choose 'static', 'adaptive' or None "
                             f"(inherit the experiment SimConfig)")
        if self.faults is not None:
            from ..faults import FaultSet   # deferred: optional layer
            if not isinstance(self.faults, FaultSet):
                raise TypeError(
                    f"faults must be a repro_torch.faults.FaultSet (or "
                    f"None), got {type(self.faults).__name__}; build one "
                    f"with faults.sample_faults(topo, k, kind)")

    @property
    def kind(self) -> str:
        return traffic_kind(self.traffic)

    @property
    def traffic_name(self) -> str:
        return traffic_name(self.traffic)

    @property
    def topology_name(self) -> str:
        """Label for result rows: the registry name, a `Topology`'s own
        name, or a generator callable's name attribute."""
        t = self.topology
        if isinstance(t, str):
            return t
        name = getattr(t, "name", "")
        return str(name) if name else getattr(t, "__name__", "custom")

    @property
    def resolved_substrate(self) -> str:
        if self.substrate is not None:
            return self.substrate
        if isinstance(self.topology, T.Topology):
            return self.topology.substrate
        return "organic"

    @property
    def resolved_area(self) -> float:
        if self.area is not None:
            return self.area
        if isinstance(self.topology, T.Topology):
            return self.topology.chiplet_area_mm2
        return 74.0

    @property
    def valid(self) -> bool:
        return not isinstance(self.topology, str) \
            or T.valid_n(self.topology, self.n)

    @property
    def degraded(self) -> bool:
        """True when a non-empty fault set degrades this scenario."""
        return self.faults is not None and not self.faults.empty

    @property
    def fault_name(self) -> str:
        return self.faults.name if self.degraded else "none"

    def effective_routing(self, cfg: SimConfig) -> str:
        """Routing mode this scenario runs under a given SimConfig:
        its own `routing` override, else the config's."""
        return self.routing if self.routing is not None else cfg.routing

    @property
    def label(self) -> str:
        base = (f"{self.topology_name}/n{self.n}/"
                f"{self.resolved_substrate}/{self.traffic_name}")
        return f"{base}/{self.fault_name}" if self.degraded else base


def scenario_from_case(case, traffic=None,
                       rates: RatePolicy = SaturationGrid()) -> Scenario:
    """Adapt a legacy `sweep.SweepCase` (its pattern, or an explicit
    workload riding on its placement) into a Scenario."""
    return Scenario(topology=case.name, n=case.n, substrate=case.substrate,
                    traffic=case.pattern if traffic is None else traffic,
                    area=case.area, roles=case.roles, rates=rates)


@dataclasses.dataclass
class Experiment:
    """An ordered list of scenarios sharing one SimConfig + backend."""
    scenarios: Sequence[Scenario]
    cfg: SimConfig = SimConfig()
    name: str = "experiment"
    backend: str = "sim"             # "sim" | "analytic"

    def __post_init__(self):
        self.scenarios = list(self.scenarios)
        if self.backend not in ("sim", "analytic"):
            raise ValueError(f"unknown backend {self.backend!r}")

    def __len__(self) -> int:
        return len(self.scenarios)

    def __iter__(self):
        return iter(self.scenarios)

    @classmethod
    def grid(cls, topologies: Sequence[str], sizes: Sequence[int],
             substrates: Sequence[str] = ("organic",),
             traffics: Sequence = ("uniform",),
             areas: Sequence[float] = (74.0,),
             roles: Sequence[str] = ("homogeneous",),
             rates: RatePolicy = SaturationGrid(),
             cfg: SimConfig = SimConfig(), name: str = "grid",
             backend: str = "sim") -> "Experiment":
        """Product grid in (area, substrate, role, traffic, topology,
        size) major-to-minor order — the figure benches' loop order."""
        scens = [Scenario(topology=t, n=n, substrate=sub, traffic=tr,
                          area=a, roles=ro, rates=rates)
                 for a, sub, ro, tr, t, n in itertools.product(
                     areas, substrates, roles, traffics, topologies, sizes)]
        return cls(scens, cfg=cfg, name=name, backend=backend)
