"""The `analyze(...)` front door (DESIGN.md §14).

One call runs the three analyzer families over a set of targets and
returns a `Report`:

    from repro_torch.analysis import analyze
    rep = analyze(names=["folded_hexa_torus", "mesh"], n=36,
                  fault_kmax=2)
    assert rep.ok                    # no error-severity diagnostics
    rep.to_json("results/diagnostics.json")

Per target the engine (1) lints the built topology against the design
principles (DP codes), (2) certifies its routing exhaustively —
pristine and fault-degraded variants (RT codes, certificate cached on
the routing via `routing_for(certify=True)`), and (3) optionally runs
the batched simulator for a few cycles under the op logger for runner
hazards (JX codes, `hazards=True`; off by default because it runs the
simulator, on the card unless `device="cpu"`).  Every step bumps
`analysis.*` counters on the process metrics registry.  The port's copy
of `repro.analysis.engine`: `analyze_runner` and `hazards=` take the
places of `analyze_jax` and `jax_hazards=`.
"""
from __future__ import annotations

from ..core import topology as T
from ..core import traffic as tr
from ..core.routing import routing_for
from ..obs.metrics import metrics

from .diagnostics import Report
from .principles import (FeasibilityCriteria, check_n_constraint,
                         lint_topology)

#: default CLI/CI chiplet count — the paper's N=36 headline scale
DEFAULT_N = 36


def analyze_topology(topo, *, crit: FeasibilityCriteria | None = None,
                     fault_kmax: int = 0, fault_kinds: tuple = ("random",),
                     fault_seeds: tuple = (0,),
                     report: Report | None = None) -> Report:
    """Lint + certify one built topology and its fault variants."""
    from ..faults import apply_variant, iter_fault_variants

    report = report if report is not None else Report()
    lint_topology(topo, crit or FeasibilityCriteria(), report=report)
    for label, fs in iter_fault_variants(topo, fault_kmax,
                                         kinds=fault_kinds,
                                         seeds=fault_seeds):
        degraded = apply_variant(topo, fs)
        r = routing_for(degraded, certify=True)
        report.record("routing", f"{r.cert.target}[{label}]")
        report.extend(r.cert.diagnostics)
        metrics.inc("analysis.certified")
        if not r.cert.ok:
            metrics.inc("analysis.cert_failures")
    metrics.inc("analysis.targets")
    return report


def analyze_runner(topos, *, cfg=None, rates=(0.1,),
                   report: Report | None = None, device=None) -> Report:
    """JX hazards for the batch the given topologies would run as, its
    few traced cycles on `device` (None: the CUDA card)."""
    from ..core.simulator import make_spec

    from .runner_hazards import analyze_batch

    report = report if report is not None else Report()
    specs = [make_spec(routing_for(t), tr.uniform(t)) for t in topos]
    label = f"batch[{len(specs)}]"
    analyze_batch(specs, list(rates), cfg, target=label, report=report,
                  device=device)
    metrics.inc("analysis.runner_batches")
    return report


def analyze(names=None, topos=None, *, n: int = DEFAULT_N,
            substrates: tuple = ("organic", "glass"),
            crit: FeasibilityCriteria | None = None,
            fault_kmax: int = 0, fault_kinds: tuple = ("random",),
            fault_seeds: tuple = (0,), hazards: bool = False,
            cfg=None, report: Report | None = None,
            device=None) -> Report:
    """Analyze named generators and/or pre-built topologies.

    names: generator names (builtin or registered); each is built at
    the nearest supported chiplet count to `n` per substrate, with a
    DP006 lint when `n` itself is unsupported (e.g. hypercube at 36
    runs at 32).  topos: already-built `Topology` objects, analyzed
    as-is.  hazards=True adds the runner-hazard pass, run on `device`.
    Returns one `Report` across all targets.
    """
    report = report if report is not None else Report()
    built = list(topos or [])
    for name in names or []:
        report.extend(check_n_constraint(name, n))
        n_eff = T.nearest_valid_n(name, n)
        for substrate in substrates:
            built.append(T.build(name, n_eff, substrate=substrate))
    for topo in built:
        analyze_topology(topo, crit=crit, fault_kmax=fault_kmax,
                         fault_kinds=fault_kinds, fault_seeds=fault_seeds,
                         report=report)
    if hazards and built:
        # one batch per substrate: specs that would actually be padded
        # and dispatched together
        for substrate in sorted({t.substrate for t in built}):
            group = [t for t in built if t.substrate == substrate]
            analyze_runner(group, cfg=cfg, report=report, device=device)
    metrics.inc("analysis.diagnostics", len(report))
    return report


def builtin_names() -> list[str]:
    """Table III generators + currently registered custom generators."""
    return sorted(T.GENERATORS) + sorted(T.CUSTOM_GENERATORS)
