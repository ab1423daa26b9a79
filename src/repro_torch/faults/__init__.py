"""Fault injection & graceful degradation (DESIGN.md §12).

    import repro_torch.faults as F

    fs = F.sample_faults(topo, k=2, kind="random", seed=0)
    degraded = fs.apply(topo)              # masked edges, same nodes
    routing = routing_for(degraded)        # rebuilt via structural hash

    # or through the experiment pipeline (the usual way):
    X.Scenario("folded_hexa_torus", 36, faults=fs)

The port of `repro.faults` (numpy/scipy only).

A `FaultSet` is failed links + failed chiplets; `apply` lowers it onto
a `Topology` as a degraded-edge mask, and the experiments planner
rebuilds deadlock-free routing for the degraded structure through the
shared structural-hash cache.  Fault sets that partition the surviving
chiplets raise `DisconnectedFaultError` — degraded topologies are just
more custom topologies, but a partitioned package is an outage, not a
scenario.
"""
from .enumerate import apply_variant, iter_fault_variants
from .faultset import (DisconnectedFaultError, FaultError, FaultSet,
                       check_survivors_connected, surviving_connected)
from .samplers import (SAMPLERS, adversarial_link_faults,
                       correlated_link_faults, random_chiplet_faults,
                       random_link_faults, sample_faults)

__all__ = [
    "FaultSet", "FaultError", "DisconnectedFaultError",
    "check_survivors_connected", "surviving_connected",
    "sample_faults", "SAMPLERS", "random_link_faults",
    "correlated_link_faults", "adversarial_link_faults",
    "random_chiplet_faults", "iter_fault_variants", "apply_variant",
]
