"""Structured benchmark results + regression gate (DESIGN.md §16).

The port's copy of `repro.obs.bench`: the same BENCH document schema,
so that `compare` reads the JAX package's `results/BENCH_*.json` and a
port document alike.  A BENCH document carries machine metadata (here
torch, CUDA and the card's name and power limit), the bench's scalar
metrics (cold/warm wall-clock, derived throughput numbers), per-metric
better-direction hints, span summaries, runner profiles
(`obs.profile`) and pad-waste fractions.  `compare` diffs two BENCH
files metric-by-metric and exits nonzero past a configurable regression
threshold.

Document schema (`bench_schema_version`, independent of the CSV
`schema_version` in `experiments.io` — BENCH files version their own
layout):

    {
      "bench_schema_version": 1,
      "name": "sweep", "mode": "smoke",
      "created_utc": "...", "machine": {...},
      "metrics":    {"batched_warm_s": 0.61, ...},   # scalars only
      "directions": {"warm_speedup": "higher", ...}, # default "lower"
      "spans":    {name: {count, total_s, max_s}},   # optional
      "profiles": [{peak_device_bytes, ...}],        # optional
      "extra":    {...}                              # free-form
    }

CLI:

    python -m repro_torch.obs.bench compare OLD NEW [--fail-over PCT]
                                                    [--warn-only]

The reference's `run <name>` subcommand dispatches to its JAX
benchmark modules; the port has no benchmark modules of its own yet,
so it has no `run`.
"""
from __future__ import annotations

import json
import os
import sys
import time

BENCH_SCHEMA_VERSION = 1

#: default regression threshold: a metric moving >25% in its worse
#: direction fails `compare` (override with --fail-over)
DEFAULT_FAIL_OVER_PCT = 25.0

#: where the port writes BENCH files by default (gitignored); the JAX
#: package's own files stay in results/
RESULTS_DIR = os.path.join("build", "bench")

__all__ = [
    "BENCH_SCHEMA_VERSION", "DEFAULT_FAIL_OVER_PCT", "machine_metadata",
    "bench_doc", "bench_path", "write_bench", "load_bench", "compare",
    "format_compare", "main",
]


def machine_metadata() -> dict:
    """Where this BENCH file came from: host, python, torch, CUDA and
    the card (its name and power limit, as nvidia-smi reports them)."""
    import platform

    import torch
    cuda = torch.cuda.is_available()
    return dict(
        platform=platform.platform(),
        machine=platform.machine(),
        python=platform.python_version(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        backend="cuda" if cuda else "cpu",
        device_count=torch.cuda.device_count() if cuda else 0,
        device_name=torch.cuda.get_device_name(0) if cuda else None,
        nvidia_smi=_nvidia_smi() if cuda else None,
        cpu_count=os.cpu_count(),
    )


def _nvidia_smi() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or
    None where the tool does not answer."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def bench_doc(name: str, metrics: dict, *, directions: dict | None = None,
              mode: str = "full", spans: dict | None = None,
              profiles: list | None = None,
              extra: dict | None = None) -> dict:
    """Assemble one BENCH document.  `metrics` must be scalar-valued —
    those are what `compare` diffs; everything non-scalar goes in
    `extra`.  `directions` marks metrics where bigger is better
    (e.g. speedups); unlisted metrics default to "lower"."""
    bad = {k: v for k, v in metrics.items()
           if v is not None and not isinstance(v, (int, float))}
    if bad:
        raise TypeError(f"non-scalar metrics {sorted(bad)}; put "
                        "structured payloads in extra=")
    for k, d in (directions or {}).items():
        if d not in ("lower", "higher"):
            raise ValueError(f"direction for {k!r} must be "
                             f"'lower' or 'higher', got {d!r}")
    return dict(
        bench_schema_version=BENCH_SCHEMA_VERSION,
        name=name, mode=mode,
        created_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        machine=machine_metadata(),
        metrics=dict(metrics),
        directions=dict(directions or {}),
        spans=spans or {},
        profiles=profiles or [],
        extra=extra or {},
    )


def bench_path(name: str, results_dir: str = RESULTS_DIR) -> str:
    return os.path.join(results_dir, f"BENCH_{name}.json")


def write_bench(doc: dict, results_dir: str = RESULTS_DIR) -> str:
    """Write a BENCH document to `<results_dir>/BENCH_<name>.json`."""
    path = bench_path(doc["name"], results_dir)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def default(o):
        try:
            import numpy as np
            if isinstance(o, (np.floating, np.integer)):
                return o.item()
            if isinstance(o, np.ndarray):
                return o.tolist()
        except ImportError:
            pass
        return str(o)

    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=default)
    print(f"[bench] wrote {path} ({len(doc['metrics'])} metrics, "
          f"bench schema v{BENCH_SCHEMA_VERSION})")
    return path


def load_bench(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    v = doc.get("bench_schema_version")
    if v != BENCH_SCHEMA_VERSION:
        raise ValueError(f"{path}: bench_schema_version {v!r} != "
                         f"{BENCH_SCHEMA_VERSION} (regenerate)")
    return doc


def compare(old: dict, new: dict,
            fail_over_pct: float = DEFAULT_FAIL_OVER_PCT) -> list[dict]:
    """Metric-by-metric diff of two BENCH documents.

    Returns one row per metric: {metric, old, new, delta_pct,
    direction, status} with status in {"ok", "regressed", "improved",
    "new", "removed"}.  A metric regressed when it moved more than
    `fail_over_pct` percent in its worse direction (direction hints
    come from the NEW doc, defaulting to "lower"-is-better)."""
    rows = []
    dirs = new.get("directions", {})
    om, nm = old.get("metrics", {}), new.get("metrics", {})
    for k in sorted(set(om) | set(nm)):
        direction = dirs.get(k, "lower")
        if k not in nm:
            rows.append(dict(metric=k, old=om[k], new=None,
                             delta_pct=None, direction=direction,
                             status="removed"))
            continue
        if k not in om or om[k] is None or nm[k] is None:
            rows.append(dict(metric=k, old=om.get(k), new=nm[k],
                             delta_pct=None, direction=direction,
                             status="new"))
            continue
        o, n = float(om[k]), float(nm[k])
        delta = (n - o) / abs(o) * 100.0 if o != 0 else \
            (0.0 if n == 0 else None)
        worse = delta is not None and (
            delta > fail_over_pct if direction == "lower"
            else delta < -fail_over_pct)
        better = delta is not None and (
            delta < -fail_over_pct if direction == "lower"
            else delta > fail_over_pct)
        rows.append(dict(
            metric=k, old=om[k], new=nm[k],
            delta_pct=None if delta is None else round(delta, 2),
            direction=direction,
            status="regressed" if worse else
                   "improved" if better else "ok"))
    return rows


def format_compare(rows: list[dict]) -> str:
    """Human-readable compare table (one line per metric)."""
    lines = [f"{'metric':<28} {'old':>12} {'new':>12} "
             f"{'delta%':>8}  status"]
    for r in rows:
        delta = "" if r["delta_pct"] is None else f"{r['delta_pct']:+.1f}"
        fmt = lambda v: "" if v is None else (
            f"{v:.4g}" if isinstance(v, float) else str(v))
        mark = {"regressed": " <-- REGRESSION",
                "improved": " (improved)"}.get(r["status"], "")
        lines.append(f"{r['metric']:<28} {fmt(r['old']):>12} "
                     f"{fmt(r['new']):>12} {delta:>8}  "
                     f"{r['status']}{mark}")
    return "\n".join(lines)


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------

def _cmd_compare(argv: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.bench compare",
        description="Diff two BENCH_<name>.json files; exit 1 on "
                    "regression past the threshold.")
    ap.add_argument("old", help="baseline BENCH json")
    ap.add_argument("new", help="candidate BENCH json")
    ap.add_argument("--fail-over", type=float,
                    default=DEFAULT_FAIL_OVER_PCT, metavar="PCT",
                    help="regression threshold in percent "
                         f"(default {DEFAULT_FAIL_OVER_PCT})")
    ap.add_argument("--warn-only", action="store_true",
                    help="report regressions but always exit 0")
    ns = ap.parse_args(argv)
    try:
        old, new = load_bench(ns.old), load_bench(ns.new)
    except (OSError, ValueError) as e:
        print(f"[bench] compare failed: {e}", file=sys.stderr)
        return 2
    rows = compare(old, new, ns.fail_over)
    print(f"[bench] {old['name']}: {ns.old} -> {ns.new} "
          f"(fail-over {ns.fail_over}%)")
    print(format_compare(rows))
    n_reg = sum(r["status"] == "regressed" for r in rows)
    if n_reg:
        msg = f"[bench] {n_reg} metric(s) regressed past {ns.fail_over}%"
        if ns.warn_only:
            print(msg + " (warn-only)")
            return 0
        print(msg, file=sys.stderr)
        return 1
    print("[bench] no regressions")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "compare":
        return _cmd_compare(rest)
    print(f"[bench] unknown subcommand {cmd!r} "
          "(expected: compare)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
