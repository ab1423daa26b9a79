"""`python -m repro_torch.analysis` — the static-verification CLI / CI gate.

    # certify every Table III topology (both substrates) at N=36:
    python -m repro_torch.analysis --all-builtin

    # one topology, fault-degraded variants up to k=2, with the runner
    # hazard checks (a few simulated cycles on the card):
    python -m repro_torch.analysis folded_hexa_torus --fault-kmax 2 --hazards

    # machine-readable export for the CI artifact:
    python -m repro_torch.analysis --all-builtin -o results/diagnostics.json

Exit status is `Report.gate(fail_on)`: 0 when clean, 1 when any
diagnostic at or above --fail-on severity exists (default: error).
Design-principle findings are warnings — Table III deliberately
violates them — so `--all-builtin` passes unless routing certification
or a JX contract actually breaks.  The port's copy of
`repro.analysis.__main__`: `--hazards` takes the place of `--jax`, and
`--device` (default: the CUDA card) says where its cycles run.
"""
from __future__ import annotations

import argparse
import sys

from . import ERROR, WARNING, analyze, builtin_names
from .engine import DEFAULT_N
from .principles import FeasibilityCriteria


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static verification: routing certification, "
                    "design-principle lint, runner hazard analysis")
    ap.add_argument("names", nargs="*",
                    help="topology generator names (builtin or "
                         "registered)")
    ap.add_argument("--all-builtin", action="store_true",
                    help="analyze every Table III + registered generator")
    ap.add_argument("-n", type=int, default=DEFAULT_N,
                    help=f"chiplet count (default {DEFAULT_N}; "
                         "constrained generators run at the nearest "
                         "supported N)")
    ap.add_argument("--substrate", action="append", default=None,
                    choices=["organic", "glass"],
                    help="substrate(s) to analyze (default: both)")
    ap.add_argument("--fault-kmax", type=int, default=0,
                    help="also certify fault-degraded variants up to "
                         "this many faults (default 0: pristine only)")
    ap.add_argument("--fault-kind", action="append", default=None,
                    help="fault sampler kind(s) (default: random)")
    ap.add_argument("--seed", type=int, action="append", default=None,
                    help="fault sampler seed(s) (default: 0)")
    ap.add_argument("--hazards", action="store_true",
                    help="run the batched simulator for a few cycles "
                         "under the op logger and run the JX hazard "
                         "checks")
    ap.add_argument("--device", default=None,
                    help="device of the --hazards cycles (default: the "
                         "CUDA card; 'cpu' for the CPU)")
    ap.add_argument("--max-radix", type=int, default=None,
                    help="override the Principle-3 radix budget")
    ap.add_argument("--min-rate-fraction", type=float, default=None,
                    help="override the substrate rate floor")
    ap.add_argument("-o", "--output", default=None, metavar="PATH",
                    help="write the JSON diagnostics artifact here")
    ap.add_argument("--fail-on", default=ERROR,
                    choices=[ERROR, WARNING],
                    help="exit nonzero when a diagnostic at/above this "
                         "severity exists (default: error)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only the summary line")
    args = ap.parse_args(argv)

    names = list(args.names)
    if args.all_builtin:
        names += [x for x in builtin_names() if x not in names]
    if not names:
        ap.error("give topology names or --all-builtin")

    crit_kw = {}
    if args.max_radix is not None:
        crit_kw["max_radix"] = args.max_radix
    if args.min_rate_fraction is not None:
        crit_kw["min_rate_fraction"] = args.min_rate_fraction

    rep = analyze(
        names=names, n=args.n,
        substrates=tuple(args.substrate or ("organic", "glass")),
        crit=FeasibilityCriteria(**crit_kw) if crit_kw else None,
        fault_kmax=args.fault_kmax,
        fault_kinds=tuple(args.fault_kind or ("random",)),
        fault_seeds=tuple(args.seed if args.seed is not None else (0,)),
        hazards=args.hazards, device=args.device)

    if not args.quiet:
        for d in rep:
            print(d)
    print(rep.summary())
    if args.output:
        rep.to_json(args.output, n=args.n, names=names,
                    fault_kmax=args.fault_kmax)
    return rep.gate(args.fail_on)


if __name__ == "__main__":
    sys.exit(main())
