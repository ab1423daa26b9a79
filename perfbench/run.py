"""Run one benchmark cell and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is an entry of `workloads` in
`BENCHMARK.json`; its configuration (`perfbench/configs/<config>.json`)
names the driver (`perfbench/drivers/<driver>.py`) that sets it up,
measures it for `--seconds` and checks its answers against the plain
reference.  With `--trace 0` the line carries the cell's end-to-end
metrics; with `--trace 1` its per-layer metrics, each read by its own
reader, `perfbench/metrics/<metric>.py`, from what the traced run
recorded.  The last line of standard output is the result, one JSON
object; the last lines of standard error are the numbers compared, each
beside its limit.

It runs on the CUDA card: without one, or with fewer cards than the
cell asks for, it exits with code 3 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()       # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that must not be loaded in a run's process:
#: JAX and the JAX package (`repro`; the port is `repro_torch`)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def run_environment(root: Path) -> None:
    """Set before numpy loads: the host's math libraries run on one
    thread, so that their pools do not contend with the thread that
    issues the device's work; and every build and kernel cache stays
    inside the checkout, at fixed paths (the port builds its own
    kernels into `build/kernels/`)."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    build = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def load_reader(root: Path, name: str):
    """The reader module of metric `name`: perfbench/metrics/<name>.py."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: int) -> list:
    """The metrics a run of `cell` reports: the end-to-end ones with
    --trace 0, the per-layer ones with --trace 1."""
    ms = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in ms if cell in m.get("workloads", [cell])]


def check_device(chips: int) -> str | None:
    """Why this machine cannot run a cell on `chips` cards, or None."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA devices, "
                f"{torch.cuda.device_count()} are present")
    return None


def main(argv=None, *, root: Path | None = None, device=None) -> int:
    """Run the cell; `root` and `device` are for tests ("cpu" skips the
    look for a card and runs the program and reference on the CPU)."""
    args = parse_args(argv)
    root = Path(root or ROOT)
    run_environment(root)
    if (root / "src").is_dir():
        sys.path.insert(0, str(root / "src"))
    from . import grid
    bench = grid.load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; choose from "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if device is None:
        why = check_device(int(cell["chips"]))
        if why:
            print(f"perfbench: {why}; no result", file=sys.stderr)
            return 3
    config = grid.load_json(grid.find(root, "configs", cell["config"]))
    mix = grid.load_json(grid.find(root, "traffic", cell["traffic"]))
    driver = importlib.import_module(f"perfbench.drivers.{config['driver']}")
    rec = driver.run(cell=cell, config=config, mix=mix, seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace),
                     device=device, t_start=T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}; no result",
              file=sys.stderr)
        return 4
    metrics = {}
    for m in cell_metrics(bench, cell["name"], args.trace):
        value = load_reader(root, m["name"]).read(rec)
        if value is None:
            if not args.trace:
                print(f"perfbench: end-to-end metric {m['name']} has no "
                      f"reading; no result", file=sys.stderr)
                return 5
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = rec["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": metrics,
            "device": rec["device"]}
    if args.trace and rec.get("breakdown"):
        line["breakdown"] = rec["breakdown"]
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
