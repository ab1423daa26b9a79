"""Topology synthesis driver (DESIGN.md §11).

    generate -> feasibility filter -> analytic rank -> sim verify -> Pareto

`run_search` seeds a candidate pool (Table-III registry anchors +
fold-mask variants + degree-bounded random geometric graphs), prunes
it with the design-principle feasibility filter, ranks survivors with
the analytic channel-load bound, then walks `generations` rounds of
evolutionary perturbation moves (parents = the analytic ε-Pareto
front) before promoting the top slice to cycle-accurate verification
through the batched experiment pipeline.  The result is a Pareto front
over (absolute Tb/s, zero-load latency, wire cost) — which is how the
repo checks that FoldedHexaTorus actually sits on the frontier its own
simulator produces, not just against hand-picked baselines.

Randomness flows through Threefry keys (`prng`, equal to the
reference's `jax.random` keys): generation g derives its move seeds
from `fold_in(key(seed), g)`, so a `SearchState` serialized mid-search
and resumed produces the identical pool as an uninterrupted run, and
the pool equals the reference's candidate for candidate.  Stage 2 runs
on the device `run_search` is given (the CUDA card by default); the
device is an argument, never part of the serialized `SearchConfig`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import topology as T
from ..core.simulator import SimConfig
from ..experiments import io as xio
from ..obs.metrics import metrics
from ..obs.trace import trace

from . import prng
from .evaluate import (Candidate, MAXIMIZE, evaluate_analytic,
                       objective_matrix, simulate_candidates)
from .feasibility import FeasibilityCriteria, check_diagnostics
from .pareto import pareto_mask
from .space import fold_mask_variants, key_seeds, perturb, random_geometric

#: registry names seeded as anchors (all Table-III families that exist
#: at arbitrary N; constrained ones are skipped via N_CONSTRAINTS)
DEFAULT_ANCHORS = ("mesh", "torus", "folded_torus", "hexamesh",
                   "folded_hexa_torus", "octamesh", "folded_octa_torus",
                   "honeycomb_mesh", "sid_mesh", "kite_large")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    n: int = 48
    substrate: str = "organic"
    traffic: str = "uniform"
    seed: int = 0
    area: float = 74.0
    anchors: tuple = DEFAULT_ANCHORS
    families: tuple = ("grid", "brick", "grid_diag")
    n_random: int = 32
    generations: int = 3
    offspring: int = 16              # perturbation moves per generation
    parents: int = 10                # ε-front slice used as parents
    max_degree: int = 8
    max_link_range: int = 1
    min_rate_fraction: float = 0.25
    sim_top: int = 8                 # stage-2 budget beyond the anchors
    n_rates: int = 4
    cfg: SimConfig = SimConfig(cycles=1500, warmup=500)

    @property
    def criteria(self) -> FeasibilityCriteria:
        return FeasibilityCriteria(max_link_range=self.max_link_range,
                                   min_rate_fraction=self.min_rate_fraction,
                                   max_radix=self.max_degree)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cfg"] = list(self.cfg)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SearchConfig":
        d = dict(d)
        d["cfg"] = SimConfig(*d["cfg"])
        for k in ("anchors", "families"):
            d[k] = tuple(d[k])
        return cls(**d)


@dataclasses.dataclass
class SearchState:
    """Serializable search progress: the feasible pool, dedupe set,
    rejection ledger and counters.  JSON round-trips via
    `experiments.io` (schema-stamped), so a search can be stopped
    after any generation and resumed elsewhere."""
    config: SearchConfig
    generation: int = 0
    pool: list = dataclasses.field(default_factory=list)   # [Candidate]
    seen: set = dataclasses.field(default_factory=set)     # structural hashes
    rejected: list = dataclasses.field(default_factory=list)
    stats: dict = dataclasses.field(default_factory=lambda: dict(
        n_generated=0, n_duplicate=0, n_infeasible=0, n_feasible=0,
        n_simulated=0))

    # ---- pool growth ---------------------------------------------------
    def admit(self, topo, origin: str, parent: str = "") -> bool:
        """Dedupe -> validate feasibility -> pool; returns admitted?"""
        self.stats["n_generated"] += 1
        h = topo.structural_hash()
        if h in self.seen:
            self.stats["n_duplicate"] += 1
            return False
        self.seen.add(h)
        diags = check_diagnostics(topo, self.config.criteria)
        if diags:
            self.stats["n_infeasible"] += 1
            # reason strings stay byte-identical to the legacy ledger
            # (d.message IS the legacy string); codes ride alongside so
            # rejections are machine-groupable (DESIGN.md §14)
            self.rejected.append(dict(
                name=topo.name, origin=origin,
                reasons=[d.message for d in diags],
                diag_codes=[d.code for d in diags]))
            return False
        self.stats["n_feasible"] += 1
        self.pool.append(Candidate(topo=topo, origin=origin, parent=parent))
        return True

    # ---- serialization -------------------------------------------------
    def to_json(self, path: str) -> None:
        xio.write_json(path, [c.to_dict() for c in self.pool],
                       meta=dict(kind="synth_search_state",
                                 config=self.config.to_dict(),
                                 generation=self.generation,
                                 seen=sorted(self.seen),
                                 rejected=self.rejected,
                                 stats=self.stats))

    @classmethod
    def from_json(cls, path: str) -> "SearchState":
        doc = xio.read_json(path)
        if doc.get("kind") != "synth_search_state":
            raise ValueError(f"{path}: not a synth search state")
        return cls(config=SearchConfig.from_dict(doc["config"]),
                   generation=int(doc["generation"]),
                   pool=[Candidate.from_dict(d) for d in doc["rows"]],
                   seen=set(doc["seen"]), rejected=list(doc["rejected"]),
                   stats=dict(doc["stats"]))


@dataclasses.dataclass
class SearchResult:
    state: SearchState
    simulated: list                  # stage-2 Candidates, rank order
    frame: object                    # stage-2 ResultFrame (rate sweeps)

    @property
    def stats(self) -> dict:
        return self.state.stats

    @property
    def prefilter_ratio(self) -> float:
        """Feasible candidates per cycle-sim evaluation — how much the
        analytic prefilter cut the simulation bill."""
        return self.stats["n_feasible"] / max(self.stats["n_simulated"], 1)

    def front_mask(self, eps: float = 0.0) -> np.ndarray:
        """[len(simulated)] mask: on (or within eps of) the Pareto
        front over the sim-verified objective vectors."""
        return pareto_mask(objective_matrix(self.simulated), MAXIMIZE,
                           eps=eps)

    def front(self, eps: float = 0.0) -> list:
        m = self.front_mask(eps)
        return [c for c, on in zip(self.simulated, m) if on]

    def on_front(self, name: str, eps: float = 0.0) -> bool:
        """Is the named candidate on (or within eps of) the front?"""
        m = self.front_mask(eps)
        return any(on for c, on in zip(self.simulated, m)
                   if c.topo.name == name)

    def rows(self) -> list:
        """Tidy rows (pool + rejections) for the versioned writers."""
        front = {id(c) for c in self.front(0.0)}
        eps_front = {id(c) for c in self.front(0.05)}
        out = []
        for c in sorted(self.state.pool,
                        key=lambda c: -(c.metrics or {}).get(
                            "abs_throughput_gbps", 0.0)):
            m = c.metrics or {}
            out.append(dict(
                name=c.topo.name, origin=c.origin, parent=c.parent,
                n=c.topo.n, substrate=c.topo.substrate, status="ok",
                stage="sim" if c.simulated else "analytic",
                on_front=id(c) in front, within_5pct=id(c) in eps_front,
                **{k: m.get(k) for k in (
                    "abs_throughput_gbps", "zero_load_latency_ns",
                    "wire_cost_mm", "analytic_saturation",
                    "sim_saturation", "radix", "diameter", "avg_hops",
                    "n_links", "max_link_mm")}))
        for r in self.state.rejected:
            out.append(dict(name=r["name"], origin=r["origin"],
                            n=self.state.config.n,
                            substrate=self.state.config.substrate,
                            status="infeasible",
                            error="; ".join(r["reasons"]),
                            diag_code=";".join(r.get("diag_codes", []))))
        return out


# ---------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------

def _seed_pool(state: SearchState) -> None:
    cfg = state.config
    for name in cfg.anchors:
        if not T.valid_n(name, cfg.n):
            continue
        topo = T.build(name, cfg.n, substrate=cfg.substrate,
                       chiplet_area_mm2=cfg.area)
        state.admit(topo, origin="registry")
    for topo in fold_mask_variants(cfg.n, families=cfg.families,
                                   substrate=cfg.substrate, area=cfg.area):
        state.admit(topo, origin="fold_mask")
    seeds = key_seeds(prng.fold_in(prng.key(cfg.seed), 0), cfg.n_random)
    for i, s in enumerate(seeds):
        family = cfg.families[i % len(cfg.families)]
        family = "brick" if family == "brick" else "grid"
        topo = random_geometric(cfg.n, int(s), family=family,
                                max_degree=cfg.max_degree,
                                max_range=cfg.max_link_range,
                                substrate=cfg.substrate, area=cfg.area)
        if topo is not None:
            state.admit(topo, origin="random")


def _select_parents(state: SearchState) -> list:
    cfg = state.config
    cands = [c for c in state.pool if c.analytic is not None]
    if not cands:
        return []
    mask = pareto_mask(objective_matrix(cands), MAXIMIZE, eps=0.05)
    ranked = sorted(
        range(len(cands)),
        key=lambda i: (not mask[i],
                       -cands[i].analytic["abs_throughput_gbps"]))
    return [cands[i] for i in ranked[:cfg.parents]]


def _evolve(state: SearchState, generation: int) -> None:
    cfg = state.config
    parents = _select_parents(state)
    if not parents:
        return
    seeds = key_seeds(prng.fold_in(prng.key(cfg.seed), generation),
                      cfg.offspring)
    for i, s in enumerate(seeds):
        parent = parents[i % len(parents)]
        child = perturb(parent.topo, int(s), max_degree=cfg.max_degree,
                        max_range=cfg.max_link_range,
                        n_moves=1 + i % 2)
        if child is not None:
            state.admit(child, origin="perturb", parent=parent.topo.name)


def _sim_slice(state: SearchState) -> list:
    """Stage-2 selection: every feasible registry anchor (so the
    paper's own topologies are always verified, FHT included) plus the
    `sim_top` best non-anchors — analytic Pareto-front members first,
    then by analytic throughput."""
    cfg = state.config
    anchors = [c for c in state.pool if c.origin == "registry"]
    rest = [c for c in state.pool if c.origin != "registry"]
    mask = pareto_mask(objective_matrix(rest), MAXIMIZE, eps=0.0) \
        if rest else np.zeros(0, bool)
    ranked = sorted(
        range(len(rest)),
        key=lambda i: (not mask[i],
                       -rest[i].analytic["abs_throughput_gbps"]))
    return anchors + [rest[i] for i in ranked[:cfg.sim_top]]


def run_search(config: SearchConfig | None = None,
               state: SearchState | None = None,
               progress=None,
               pause_after: int | None = None,
               device=None) -> SearchResult:
    """Run (or resume) a synthesis search; see the module docstring.

    Pass a saved `SearchState` to resume: completed generations are
    not re-run, and PRNG keys are derived per generation
    (`fold_in(key(seed), g)`), so resumed and uninterrupted runs
    produce the identical pool.  `pause_after=g` stops after
    generation min(g, generations) and always skips the stage-2
    simulation (the result carries an empty `simulated` slice) —
    serialize `result.state` and pass it back to continue.  device:
    where stage 2 simulates (None: the CUDA card; "cpu" the CPU).
    """
    if state is None:
        state = SearchState(config=config or SearchConfig())
    elif config is not None and config != state.config:
        raise ValueError("resume state carries a different SearchConfig")
    cfg = state.config
    if not state.pool and state.generation == 0:
        with trace("synth.seed", cat="synth", n=cfg.n,
                   substrate=cfg.substrate):
            _seed_pool(state)
    with trace("synth.analytic", cat="synth", pool=len(state.pool)):
        evaluate_analytic(state.pool, cfg.traffic)
    target = cfg.generations if pause_after is None \
        else min(pause_after, cfg.generations)
    while state.generation < target:
        g = state.generation + 1
        with trace("synth.generation", cat="synth", generation=g,
                   pool=len(state.pool)):
            _evolve(state, g)
            evaluate_analytic(state.pool, cfg.traffic)
        state.generation = g
        metrics.inc("synth.generations")
        if progress is not None:
            progress(g, cfg.generations, state.stats)
    metrics.inc("synth.candidates", state.stats["n_generated"])
    if pause_after is not None:           # paused: no stage-2 this call
        return SearchResult(state=state, simulated=[], frame=None)
    sim = _sim_slice(state)
    with trace("synth.simulate", cat="synth", candidates=len(sim)):
        frame = simulate_candidates(sim, traffic=cfg.traffic, cfg=cfg.cfg,
                                    n_rates=cfg.n_rates, device=device)
    state.stats["n_simulated"] = sum(1 for c in sim if c.simulated)
    metrics.inc("synth.simulated", state.stats["n_simulated"])
    return SearchResult(state=state, simulated=[c for c in sim
                                               if c.simulated],
                        frame=frame)
