"""Design-principle lint (DESIGN.md §14): Principles 1–3 as diagnostics.

The port's copy of `repro.analysis.principles`, message for message.

This is the *canonical* home of the paper's feasibility constraints.
They used to live as bare strings split between `synth/feasibility.py`
(the search prefilter) and `experiments/plan.py` (the planner's
N-constraint skip logic); now one implementation produces structured
`Diagnostic`s with stable DP-family codes, and those two call sites are
shims over it.  Message strings are kept **byte-identical** to the
legacy ones — the synth rejection ledger and planner skip rows are
pinned by tests and downstream CSV diffs.

Severity is `warning`, not `error`: a DP violation marks an
*infeasible design*, not broken code.  Table III deliberately includes
topologies that violate the rate floor at scale (that is the paper's
argument for folding), so `--all-builtin` must certify them
deadlock-free (no RT errors) while still surfacing the DP lint.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..core import costmodel as cm
from ..core import linkmodel as lm
from ..core.topology import Topology, valid_n

from .diagnostics import Diagnostic, Report, diag


@dataclasses.dataclass(frozen=True)
class FeasibilityCriteria:
    """The paper's constraint knobs (defaults match the benchmark grid)."""
    max_link_range: int = 1          # Principle 2
    min_rate_fraction: float = 0.25  # substrate floor on the Fig.-2 curve
    max_radix: int | None = 8        # Principle 3: per-chiplet PHY budget
    min_data_wires: int = 1          # Principle 3: wires left per link
    max_wire_cost_mm: float | None = None

    def max_link_mm(self, substrate: str) -> float:
        return max_feasible_link_mm(substrate, self.min_rate_fraction)


@functools.lru_cache(maxsize=64)
def max_feasible_link_mm(substrate: str,
                         min_rate_fraction: float) -> float:
    """Longest link (mm) that still meets the rate floor on this
    substrate — the inverse of the monotone tail of the Fig.-2 curve,
    read off a fine grid (cached: `diagnose` calls this once per
    generated candidate)."""
    grid = np.linspace(0.0, lm.MAX_LINK_LENGTH_MM, 7001)
    ok = grid[lm.rate_fraction(grid, substrate) >= min_rate_fraction]
    return float(ok.max()) if len(ok) else 0.0


def _label(topo: Topology) -> str:
    return f"{topo.name}/n{topo.n}/{topo.substrate}"


def diagnose(topo: Topology,
             crit: FeasibilityCriteria = FeasibilityCriteria()
             ) -> list[Diagnostic]:
    """DP001–DP005 for one candidate; empty list == feasible.

    Check order and message text mirror the legacy
    `synth.feasibility.check` exactly — its return value is now
    `[d.message for d in diagnose(...)]`.
    """
    out: list[Diagnostic] = []
    t = _label(topo)
    ranges = topo.link_ranges()
    if len(ranges) and int(ranges.max()) > crit.max_link_range:
        out.append(diag(
            "DP001",
            f"link-range {int(ranges.max())} > "
            f"{crit.max_link_range} (Principle 2)",
            target=t, link_range=int(ranges.max()),
            budget=crit.max_link_range,
            n_over=int((ranges > crit.max_link_range).sum())))
    cap = crit.max_link_mm(topo.substrate)
    lmax = topo.max_link_length_mm()
    if lmax > cap + 1e-9:
        out.append(diag(
            "DP002",
            f"max link {lmax:.1f} mm > {cap:.1f} mm "
            f"({topo.substrate} rate floor "
            f"{crit.min_rate_fraction:g})",
            target=t, max_link_mm=float(lmax), cap_mm=float(cap),
            substrate=topo.substrate,
            min_rate_fraction=crit.min_rate_fraction))
    if crit.max_radix is not None and topo.radix > crit.max_radix:
        out.append(diag(
            "DP003",
            f"radix {topo.radix} > {crit.max_radix} "
            "(Principle 3)",
            target=t, radix=int(topo.radix), budget=crit.max_radix))
    if cm.data_wires(topo) < crit.min_data_wires:
        out.append(diag(
            "DP004",
            f"data wires {cm.data_wires(topo)} < "
            f"{crit.min_data_wires} at radix {topo.radix} "
            "(Principle 3)",
            target=t, data_wires=int(cm.data_wires(topo)),
            minimum=crit.min_data_wires, radix=int(topo.radix)))
    if crit.max_wire_cost_mm is not None and \
            cm.wire_cost_mm(topo) > crit.max_wire_cost_mm:
        out.append(diag(
            "DP005",
            f"wire cost {cm.wire_cost_mm(topo):.0f} wire-mm "
            f"> {crit.max_wire_cost_mm:.0f}",
            target=t, wire_cost_mm=float(cm.wire_cost_mm(topo)),
            budget=crit.max_wire_cost_mm))
    return out


def check_n_constraint(name: str, n: int) -> list[Diagnostic]:
    """DP006 with the planner's exact skip string; empty == supported."""
    if valid_n(name, n):
        return []
    return [diag(
        "DP006",
        f"{name} does not support N={n} (topology.N_CONSTRAINTS)",
        target=f"{name}/n{n}", name=name, n=n)]


def lint_topology(topo: Topology,
                  crit: FeasibilityCriteria = FeasibilityCriteria(),
                  report: Report | None = None) -> list[Diagnostic]:
    """All DP checks for a built topology, optionally into `report`."""
    out = diagnose(topo, crit)
    if report is not None:
        report.record("principles", _label(topo))
        report.extend(out)
    return out
