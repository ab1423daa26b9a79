"""Static verification layer (DESIGN.md §14): the port's
`repro_torch.analysis`.

    from repro_torch.analysis import analyze
    rep = analyze(names=["folded_hexa_torus"], n=36, fault_kmax=2)
    assert rep.ok
    rep.to_json("build/diagnostics.json")

    # CLI / CI gate:
    #   python -m repro_torch.analysis --all-builtin [--hazards]

Three analyzer families behind one front door, all speaking structured
`Diagnostic` records with stable codes (see `diagnostics.CODES`):

  * `routing_verify` — exhaustive deadlock/reachability certification
    of routing artifacts (RT codes; witness = the actual CDG cycle),
    and the escape-safety check of adaptive routing (`check_escape`,
    RT005);
  * `principles` — the paper's design principles as shared lint (DP
    codes; the synth prefilter is a shim over this module, with
    byte-identical legacy messages);
  * `runner_hazards` — hazards of the batched simulator (JX codes:
    int32 overflow bounds, sacrificial-slot padding contract, recompile
    storms, and, from the op log of a few real cycles, host syncs and
    dtype promotions); the counterpart of the reference's
    `jaxpr_hazards`.

numpy, scipy and torch only; `analyze_runner` / `hazards=True` run the
simulator (on the CUDA card unless `device="cpu"`).
"""
from .diagnostics import (CODES, ERROR, INFO, WARNING, Diagnostic,
                          Report, diag)
from .engine import (DEFAULT_N, analyze, analyze_runner, analyze_topology,
                     builtin_names)
from .principles import (FeasibilityCriteria, check_n_constraint,
                         diagnose, lint_topology, max_feasible_link_mm)
from .routing_verify import (RoutingCertificate, certify_routing,
                             check_acyclic, check_escape,
                             check_reachability, check_table_channels,
                             dependency_edges, find_cdg_cycle,
                             verify_routing)

__all__ = [
    "CODES", "ERROR", "WARNING", "INFO", "Diagnostic", "Report", "diag",
    "analyze", "analyze_topology", "analyze_runner", "builtin_names",
    "DEFAULT_N",
    "FeasibilityCriteria", "diagnose", "lint_topology",
    "check_n_constraint", "max_feasible_link_mm",
    "RoutingCertificate", "certify_routing", "verify_routing",
    "check_acyclic", "check_escape", "check_reachability",
    "check_table_channels", "dependency_edges", "find_cdg_cycle",
]
