"""repro_torch.synth — topology design-space exploration (DESIGN.md §11).

The paper's deepest contribution is not one topology but the design
principles that produced it; this package turns those principles into
a search:

    from repro_torch.synth import SearchConfig, run_search
    res = run_search(SearchConfig(n=48, substrate="organic", seed=0),
                     device="cuda")       # or "cpu"; None is the card
    print(res.prefilter_ratio)            # sims saved by the prefilter
    for c in res.front():                 # (Tb/s, latency, wire cost)
        print(c.topo.name, c.metrics["abs_throughput_gbps"])
    assert res.on_front("folded_hexa_torus", eps=0.05)

Layers: `space` (fold-mask variants, degree-bounded random geometric
graphs, perturbation moves — all first-class `Topology` objects),
`feasibility` (the three design principles as prefilter checks),
`evaluate` (analytic rank, then cycle-accurate verification through
the batched experiment pipeline), `pareto` (ε-dominance utilities) and
`search` (the seeded, resumable evolutionary driver) and `prng`
(the reference's `jax.random` Threefry keys, in numpy).  The port's copy
of `repro.synth`: the same pool, ledger, metrics and front for the same
config, with stage 2 on the device `run_search` is given.
"""
from .evaluate import (Candidate, MAXIMIZE, OBJECTIVES, analytic_metrics,
                       evaluate_analytic, objective_matrix,
                       simulate_candidates)
from .feasibility import (FeasibilityCriteria, check, filter_feasible,
                          max_feasible_link_mm)
from .pareto import dominates, pareto_front, pareto_mask
from .search import (DEFAULT_ANCHORS, SearchConfig, SearchResult,
                     SearchState, run_search)
from .space import (AXIS_MODES, candidate_pairs, fold_mask_topology,
                    fold_mask_variants, key_seeds, perturb,
                    random_geometric)

__all__ = [
    "SearchConfig", "SearchState", "SearchResult", "run_search",
    "DEFAULT_ANCHORS",
    "Candidate", "OBJECTIVES", "MAXIMIZE", "analytic_metrics",
    "evaluate_analytic", "objective_matrix", "simulate_candidates",
    "FeasibilityCriteria", "check", "filter_feasible",
    "max_feasible_link_mm",
    "pareto_mask", "pareto_front", "dominates",
    "fold_mask_variants", "fold_mask_topology", "random_geometric",
    "perturb", "candidate_pairs", "key_seeds", "AXIS_MODES",
]
