"""Two-stage candidate evaluation (DESIGN.md §11).

Stage 1 (**analytic**, cheap): the channel-load saturation bound of
the shared deadlock-free routing (`routing_for`, structural-hash
cached) feeds the paper's §V-B cost model — absolute Tb/s through the
substrate wires, zero-load latency, wire cost.  This ranks thousands
of candidates without a single simulated cycle.

Stage 2 (**cycle-accurate**, expensive): the top slice is packed into
`experiments` scenarios — `Scenario` carrying the synthesized
`Topology` objects directly — and executed as padded `SweepEngine`
batches, replacing the analytic saturation with the simulated plateau.
The Pareto objectives stay comparable across stages: only the
throughput coordinate changes backend; zero-load latency and wire
cost are analytic by definition.  Stage 2 runs on the device the
caller names (the CUDA card by default): every simulated cycle goes
through the `netstep` kernel there.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import costmodel as cm
from ..core import traffic as TR
from ..core.routing import routing_for
from ..core.simulator import SimConfig, zero_load_latency
from ..core.topology import Topology, make_topology

#: Pareto objectives: (metrics key, maximize?)
OBJECTIVES = (("abs_throughput_gbps", True),
              ("zero_load_latency_ns", False),
              ("wire_cost_mm", False))
MAXIMIZE = tuple(mx for _, mx in OBJECTIVES)


@dataclasses.dataclass
class Candidate:
    """One design-space point: a topology plus its evaluation record."""
    topo: Topology
    origin: str                     # registry | fold_mask | random | perturb
    parent: str = ""
    reasons: tuple = ()             # infeasibility reasons; () == feasible
    analytic: dict | None = None    # stage-1 metrics
    sim: dict | None = None         # stage-2 metrics (adds sim_saturation)

    @property
    def feasible(self) -> bool:
        return not self.reasons

    @property
    def simulated(self) -> bool:
        return self.sim is not None

    @property
    def metrics(self) -> dict | None:
        return self.sim if self.sim is not None else self.analytic

    def objectives(self) -> np.ndarray:
        """[K] objective vector (NaN until stage-1 evaluated)."""
        m = self.metrics
        if m is None:
            return np.full(len(OBJECTIVES), np.nan)
        return np.array([m[k] for k, _ in OBJECTIVES], np.float64)

    # ---- JSON round-trip (SearchState serialization) ------------------
    def to_dict(self) -> dict:
        t = self.topo
        return dict(name=t.name, n=t.n, substrate=t.substrate,
                    area=t.chiplet_area_mm2,
                    pos=np.asarray(t.pos, float).tolist(),
                    edges=np.asarray(t.edges, int).tolist(),
                    origin=self.origin, parent=self.parent,
                    reasons=list(self.reasons),
                    analytic=self.analytic, sim=self.sim)

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        topo = make_topology(d["name"], np.asarray(d["pos"]),
                             np.asarray(d["edges"], np.int64),
                             substrate=d["substrate"],
                             chiplet_area_mm2=d["area"])
        return cls(topo=topo, origin=d["origin"], parent=d["parent"],
                   reasons=tuple(d["reasons"]),
                   analytic=d["analytic"], sim=d["sim"])


def objective_matrix(cands) -> np.ndarray:
    return np.stack([c.objectives() for c in cands]) if cands else \
        np.zeros((0, len(OBJECTIVES)))


def analytic_metrics(topo: Topology, traffic: str = "uniform") -> dict:
    """Stage-1 metrics: analytic saturation -> §V-B cost model."""
    r = routing_for(topo)
    tm = TR.PATTERNS[traffic](topo)
    sat = r.saturation_rate(tm)
    # one all-pairs pass covers diameter + avg hops (candidates are
    # validated connected, so no inf rows); the properties would run it
    # twice per candidate in the hot analytic loop
    h = topo.hop_matrix()
    n = topo.n
    return dict(
        analytic_saturation=float(sat),
        abs_throughput_gbps=cm.absolute_throughput_gbps(topo, sat),
        zero_load_latency_ns=float(zero_load_latency(r, tm)),
        wire_cost_mm=cm.wire_cost_mm(topo),
        radix=int(topo.radix), diameter=int(h.max()),
        avg_hops=float(h.sum() / (n * (n - 1))),
        n_links=int(len(topo.edges)),
        max_link_mm=float(topo.max_link_length_mm()))


def evaluate_analytic(cands, traffic: str = "uniform") -> None:
    """Attach stage-1 metrics to every candidate lacking them."""
    for c in cands:
        if c.analytic is None:
            c.analytic = analytic_metrics(c.topo, traffic)


def simulate_candidates(cands, traffic: str = "uniform",
                        cfg: SimConfig = SimConfig(), n_rates: int = 4,
                        chunk_size: int | None = None,
                        single_program: bool = False, device=None):
    """Stage 2: cycle-accurate saturation for `cands`, batched.

    Lowers the candidates onto the declarative experiment pipeline —
    one `Scenario` per candidate carrying its `Topology` object — so
    the padded `SweepEngine` batches, executable caching and
    failure-isolation all apply.  Each candidate's `sim` metrics
    replace the analytic throughput with the simulated one; the
    returned `ResultFrame` keeps the full rate sweeps.  device: None
    runs on the CUDA card; "cpu" on the CPU.
    """
    from .. import experiments as X
    # substrate/area inherit from each candidate's Topology (the
    # Scenario None-default), so glass candidates stay glass
    scens = [X.Scenario(topology=c.topo, n=c.topo.n, traffic=traffic,
                        rates=X.SaturationGrid(n_rates))
             for c in cands]
    frame = X.run(X.Experiment(scens, cfg=cfg, name="synth_sim"),
                  chunk_size=chunk_size, single_program=single_program,
                  device=device)
    for c, row in zip(cands, frame.rows):
        if row["status"] != "ok":
            continue
        c.sim = dict(c.analytic,
                     sim_saturation=float(row["sim_saturation"]),
                     abs_throughput_gbps=float(row["abs_throughput_gbps"]),
                     latency_at_sat_ns=float(row["latency_ns"]))
    return frame
