"""Structured diagnostics (DESIGN.md §14): records, codes, reports.

Every analyzer in `analysis` speaks one vocabulary: a
`Diagnostic` is a stable machine-readable code (`RT001`, `DP002`,
`JX003`, ...), a severity, a human message, the artifact it is about
(`target`), and — crucially — a concrete *witness*: the actual
channel-dependency cycle, the offending edge, the overflowing counter
bound.  A claim without a witness is a lint; a claim with one is a
certificate of the violation.

Code families (the full registry is `CODES`):

  * ``RT``  — routing verification (deadlock / reachability / table
    well-formedness).  Violations are correctness bugs: severity
    ``error``.
  * ``DP``  — the paper's design principles (link range, substrate
    rate floor, radix/wire budget) plus generator N-constraints.
    These describe *infeasible designs*, not broken code, so their
    default severity is ``warning`` — Table III deliberately contains
    topologies that violate them (that is the paper's argument).
  * ``JX``  — JAX-side hazards of the batched simulator (int32
    counter overflow, pad-slot scatter escapes, recompilation storms,
    host sync points, dtype promotions).
  * ``FT`` / ``EX`` — planner/executor outcomes (rejected fault sets,
    failed chunks) so `ResultFrame` skip rows carry the same codes.

Severities order ``error > warning > info``; `Report.gate()` is the CI
gate: it fails when any diagnostic at or above the threshold exists.

The port's copy of `repro.analysis.diagnostics` (standard library only):
the same codes, records and reports, so that a report reads alike in
both packages.  The JX codes' descriptions are the reference's; the
port's JX004 / JX005 read an op log, not a traced step
(`runner_hazards`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

ERROR, WARNING, INFO = "error", "warning", "info"
_SEV_RANK = {ERROR: 2, WARNING: 1, INFO: 0}

#: code -> (slug, default severity, one-line description)
CODES: dict[str, tuple[str, str, str]] = {
    # ---- routing verification (analysis.routing_verify) --------------
    "RT001": ("cdg-cycle", ERROR,
              "channel-dependency graph has a cycle (deadlock possible)"),
    "RT002": ("unreachable-pair", ERROR,
              "a connected (src, dst) pair has no route in the table"),
    "RT003": ("undeclared-channel", ERROR,
              "a routing-table entry names a port with no declared "
              "channel"),
    "RT004": ("routing-loop", ERROR,
              "table following exceeded the hop bound (livelock)"),
    "RT005": ("escape-unsafe", ERROR,
              "an adaptive routing choice loses its deadlock-free "
              "escape path"),
    # ---- design principles (analysis.principles) --------------------
    "DP001": ("link-range", WARNING,
              "link range exceeds the Principle-2 budget"),
    "DP002": ("rate-floor", WARNING,
              "longest link falls below the substrate's Fig.-2 rate "
              "floor"),
    "DP003": ("radix", WARNING,
              "radix exceeds the Principle-3 per-chiplet PHY budget"),
    "DP004": ("wire-budget", WARNING,
              "per-link data wires fall below the Principle-3 minimum"),
    "DP005": ("wire-cost", WARNING,
              "total substrate wire cost exceeds the configured bound"),
    "DP006": ("n-constraint", WARNING,
              "generator does not support the requested N "
              "(topology.N_CONSTRAINTS)"),
    # ---- runner hazards (analysis.runner_hazards) -------------------
    "JX001": ("int32-overflow", ERROR,
              "an int32 counter's worst-case bound overflows at the "
              "configured cycle count"),
    "JX002": ("pad-slot-write", ERROR,
              "a padded array region violates the sacrificial-slot "
              "contract (a scatter can touch a live slot)"),
    "JX003": ("recompile-hazard", WARNING,
              "distinct avals / padded shapes force extra executable "
              "compiles"),
    "JX004": ("host-sync", WARNING,
              "the traced step contains a host callback (device sync "
              "point inside the scan)"),
    "JX005": ("dtype-promotion", WARNING,
              "the traced step silently promotes or demotes a dtype"),
    # ---- pipeline outcomes (experiments planner / executor) ----------
    "FT001": ("fault-rejected", WARNING,
              "fault set cannot be applied (disconnects survivors or "
              "names a missing link)"),
    "EX001": ("chunk-failed", ERROR,
              "an execution chunk raised and was skipped"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code + severity + location + witness."""
    code: str                   # registry key, e.g. "RT001"
    message: str                # human-readable, legacy-string exact
    target: str = ""            # what it is about (topology/spec label)
    severity: str = ""          # "" = the code's default severity
    witness: tuple = ()         # ((key, value), ...) concrete evidence

    def __post_init__(self):
        if self.code not in CODES:
            raise KeyError(f"unknown diagnostic code {self.code!r}; "
                           f"register it in analysis.diagnostics.CODES")
        if not self.severity:
            object.__setattr__(self, "severity", CODES[self.code][1])
        if self.severity not in _SEV_RANK:
            raise ValueError(f"unknown severity {self.severity!r}")
        object.__setattr__(self, "witness", tuple(
            (str(k), v) for k, v in self.witness))

    @property
    def slug(self) -> str:
        return CODES[self.code][0]

    @property
    def label(self) -> str:
        """'RT001 cdg-cycle' — the stable display form."""
        return f"{self.code} {self.slug}"

    def witness_dict(self) -> dict:
        return dict(self.witness)

    def to_dict(self) -> dict:
        return dict(code=self.code, slug=self.slug,
                    severity=self.severity, target=self.target,
                    message=self.message,
                    witness=self.witness_dict() or None)

    def __str__(self) -> str:
        where = f" [{self.target}]" if self.target else ""
        return f"{self.severity:7s} {self.label}{where}: {self.message}"


def diag(code: str, message: str, target: str = "",
         severity: str = "", **witness) -> Diagnostic:
    """Build a `Diagnostic`; witness kwargs become the witness pairs."""
    return Diagnostic(code=code, message=message, target=target,
                      severity=severity,
                      witness=tuple(witness.items()))


class Report:
    """An ordered collection of diagnostics with gate/summary helpers."""

    def __init__(self, diagnostics: Iterable[Diagnostic] = ()):
        self.diagnostics: list[Diagnostic] = list(diagnostics)
        #: analyzed-artifact ledger: (kind, label) pairs, so "zero
        #: diagnostics" is distinguishable from "analyzed nothing"
        self.analyzed: list[tuple[str, str]] = []

    # ---- collection ---------------------------------------------------
    def extend(self, diagnostics: Iterable[Diagnostic]) -> "Report":
        self.diagnostics.extend(diagnostics)
        return self

    def add(self, d: Diagnostic) -> "Report":
        self.diagnostics.append(d)
        return self

    def record(self, kind: str, label: str) -> None:
        self.analyzed.append((kind, label))

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    # ---- queries ------------------------------------------------------
    def at_least(self, severity: str) -> list[Diagnostic]:
        r = _SEV_RANK[severity]
        return [d for d in self.diagnostics
                if _SEV_RANK[d.severity] >= r]

    def errors(self) -> list[Diagnostic]:
        return self.at_least(ERROR)

    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def by_code(self, code: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for d in self.diagnostics:
            out[d.code] = out.get(d.code, 0) + 1
        return out

    @property
    def ok(self) -> bool:
        """No error-severity diagnostics (warnings/infos allowed)."""
        return not self.errors()

    def gate(self, fail_on: str = ERROR) -> int:
        """CI exit code: 1 if any diagnostic at/above `fail_on`."""
        return 1 if self.at_least(fail_on) else 0

    # ---- presentation -------------------------------------------------
    def summary(self) -> str:
        sev = {ERROR: 0, WARNING: 0, INFO: 0}
        for d in self.diagnostics:
            sev[d.severity] += 1
        per_code = " ".join(f"{c}x{n}"
                            for c, n in sorted(self.counts().items()))
        return (f"{len(self.analyzed)} artifact(s) analyzed: "
                f"{sev[ERROR]} error(s), {sev[WARNING]} warning(s), "
                f"{sev[INFO]} info" + (f"  [{per_code}]" if per_code
                                       else ""))

    def to_rows(self) -> list[dict]:
        return [d.to_dict() for d in self.diagnostics]

    def to_json(self, path: str, **meta) -> None:
        """Versioned JSON artifact (experiments.io discipline) for the
        CI gate: {schema_version, meta, counts, analyzed, rows}."""
        from ..experiments import io as xio
        xio.write_json(path, self.to_rows(), meta=dict(
            kind="diagnostics", counts=self.counts(),
            n_errors=len(self.errors()),
            analyzed=[list(a) for a in self.analyzed], **meta))
