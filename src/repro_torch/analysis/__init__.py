"""Static verification layer (DESIGN.md §14): the port's
`repro_torch.analysis`.

    from repro_torch.analysis import certify_routing
    cert = certify_routing(routing)
    assert cert.ok, cert.report().summary()

Two modules of the reference's analysis layer, numpy and scipy only:

  * `diagnostics` — `Diagnostic` records with stable codes (`CODES`),
    `Report` with its CI gate and versioned JSON artifact;
  * `routing_verify` — exhaustive deadlock / reachability / table
    certification of routing artifacts (RT codes, witness = the actual
    channel-dependency cycle), and the escape-safety check of adaptive
    routing (`check_escape`, RT005).

`routing.routing_for(topo, certify=True)` caches a certificate with the
routing.  The reference's design-principle lint, analyzer engine and
jaxpr hazards are not part of the port yet.
"""
from .diagnostics import (CODES, ERROR, INFO, WARNING, Diagnostic,
                          Report, diag)
from .routing_verify import (RoutingCertificate, certify_routing,
                             check_acyclic, check_escape,
                             check_reachability, check_table_channels,
                             dependency_edges, find_cdg_cycle,
                             verify_routing)

__all__ = [
    "CODES", "ERROR", "WARNING", "INFO", "Diagnostic", "Report", "diag",
    "RoutingCertificate", "certify_routing", "verify_routing",
    "check_acyclic", "check_escape", "check_reachability",
    "check_table_channels", "dependency_edges", "find_cdg_cycle",
]
