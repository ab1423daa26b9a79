"""Feasibility filter (DESIGN.md §11): the paper's design principles
as candidate checks, applied before any routing or simulation.

The canonical implementation lives in `analysis.principles`
(DESIGN.md §14) so the synth prefilter, the experiment planner and the
`python -m repro_torch.analysis` CLI all emit the *same* diagnostic codes
(DP001–DP005) instead of three divergent string sets.  This module is
a compatibility shim: `FeasibilityCriteria` is the same class, and
`check` returns exactly the legacy reason strings — they are the
`message` fields of the structured diagnostics, in the same order, so
the synth rejection ledger is byte-identical to pre-refactor runs.

  * **Principle 2 — link-range budget** (DP001): every link spans at
    most `max_link_range` intermediate chiplets;
  * **substrate rate floor** (DP002): the longest link must retain at
    least `min_rate_fraction` of the maximum per-wire rate on this
    substrate's Fig.-2 curve — the mechanism that zeroes
    Torus/ClusCross-style wrap links at scale;
  * **Principle 3 — wire budget** (DP003/DP004/DP005): the radix must
    leave a positive per-link data-wire budget after the UCIe overhead,
    optionally capped (`max_radix`), and the total substrate wire cost
    may be bounded (`max_wire_cost_mm`).

Connectivity / well-formedness is not re-checked here — `make_topology`
and `topology.build` already enforce it at construction time.
"""
from __future__ import annotations

from ..analysis.principles import (FeasibilityCriteria, diagnose,
                                   max_feasible_link_mm)
from ..core.topology import Topology

__all__ = ["FeasibilityCriteria", "max_feasible_link_mm", "check",
           "check_diagnostics", "filter_feasible"]


def check(topo: Topology,
          crit: FeasibilityCriteria = FeasibilityCriteria()) -> list[str]:
    """Reasons this candidate is infeasible; empty list == feasible."""
    return [d.message for d in diagnose(topo, crit)]


def check_diagnostics(topo: Topology,
                      crit: FeasibilityCriteria = FeasibilityCriteria()):
    """The same checks as structured diagnostics (DP codes + witness)."""
    return diagnose(topo, crit)


def filter_feasible(topos, crit: FeasibilityCriteria = FeasibilityCriteria()
                    ) -> tuple[list, list]:
    """Split candidates into (feasible, [(topo, reasons), ...])."""
    feasible, rejected = [], []
    for t in topos:
        reasons = check(t, crit)
        (feasible.append(t) if not reasons
         else rejected.append((t, reasons)))
    return feasible, rejected
