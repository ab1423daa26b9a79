"""The control of the `correct` check: the plain reference put in the
program's place, one precision step below what the configurations
state.

    python3 -m perfbench.control --workload <cell> --seeds 11 12 13

For each seed it draws the scenarios a run's check would compare (CHECK_SCENARIOS of
them) with their simulator seeds, simulates
each with the reference twice, once as stated (the injection test in
float32) and once with both sides of that test rounded to bfloat16, and
compares the second with the first by the harness's comparison.  A
sound check reads more than its limit, 0, on every seed.  Prints one
JSON line per seed.  Runs on the card unless `--device cpu`; the
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import compare as C
from . import grid as G
from .drivers.sim import CHECK_SCENARIOS, group_seed

ROOT = Path(__file__).resolve().parents[1]


def readings(config: dict, mix: dict, seed: int, device,
             inject_dtype: str = "bfloat16") -> dict:
    """The control's reading on `seed`: the summed comparison of the
    lowered reference against the reference, and what was compared."""
    from .reference import scenario as REF
    s = G.settings(config, mix)
    defs = G.scenario_defs(config, mix)
    n = min(CHECK_SCENARIOS, len(defs))
    rng = np.random.default_rng([seed % 2 ** 64, 1])
    out, labels = [], []
    for i in sorted(int(k) for k in rng.choice(len(defs), n,
                                               replace=False)):
        gs = group_seed(seed, i)
        want, want_row = REF.simulate(defs[i], s, gs, device)
        got, got_row = REF.simulate(defs[i], s, gs, device, inject_dtype)
        out.append(C.compare(got, got_row, want, want_row))
        labels.append(defs[i].label)
    return dict(C.total(out), scenarios=labels)


def main(argv=None, *, root: Path | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--inject-dtype", default="bfloat16")
    args = ap.parse_args(argv)
    root = Path(root or ROOT)
    bench = G.load_json(root / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    config = G.load_json(G.find(root, "configs", cell["config"]))
    mix = G.load_json(G.find(root, "traffic", cell["traffic"]))
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(config, mix, seed, args.device, args.inject_dtype)
        r.update(workload=args.workload, seed=seed,
                 inject_dtype=args.inject_dtype,
                 seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
