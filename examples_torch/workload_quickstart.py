"""Workload-engine quickstart: time-varying traffic through the
declarative experiment API (DESIGN.md §9 + §10).

    PYTHONPATH=src python examples_torch/workload_quickstart.py \
        [--device cpu] [--out build/examples]

The port's `examples/workload_quickstart.py`: three workloads (a
qwen3-style training collective schedule, a replayed fluidanimate trace
with ON/OFF bursts, an adversarial tornado<->uniform alternation)
crossed with Mesh vs FoldedHexaTorus in ONE `Experiment`, on the CUDA
card unless `--device cpu` is given.  Writes
`OUT/workload_quickstart.csv`.
"""
import argparse
import os
from functools import partial

import numpy as np

import repro_torch.experiments as X
import repro_torch.workloads as W
from repro_torch.configs import get_config
from repro_torch.core.simulator import SimConfig
from repro_torch.core.topology import build
from repro_torch.device import resolve_device

OUT = os.path.join("build", "examples")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT, help="directory of the CSV")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("qwen3_1_7b")
    workloads = [
        W.Workload(f"collective:{cfg.name}",
                   partial(W.collective_workload, cfg)),
        W.Workload("trace:fluidanimate",
                   partial(W.trace_workload, trace="fluidanimate")),
        W.Workload("alt:tornado-uniform", W.phase_alternating),
    ]
    exp = X.Experiment(
        [X.Scenario(name, 16, traffic=wl, roles="hetero_cmi",
                    rates=X.SaturationGrid(4))
         for name in ("mesh", "folded_hexa_torus") for wl in workloads],
        cfg=SimConfig(cycles=800, warmup=300), name="workload_quickstart")
    frame = X.run(exp, device=device)
    print("=== workloads x topologies, one declarative experiment ===")
    for i, row in enumerate(frame.rows):
        if row["status"] != "ok":
            continue
        res = frame.workload_result(i)
        phases = ", ".join(
            f"{lbl}={thr:.3f}" for lbl, thr in
            zip(res["phase_labels"], res["throughput_ph"]))
        print(f"{row['topology']:18s} {res['workload']:24s} "
              f"sat={res['sim_saturation']:.3f} "
              f"lat={res['latency_at_sat']:5.1f}cy  per-phase [{phases}]")
    frame.to_csv(os.path.join(args.out, "workload_quickstart.csv"))

    print("\n=== anatomy of the collective schedule on FHT-16 ===")
    topo = build("folded_hexa_torus", 16)
    sched = W.collective_workload(cfg, topo)
    for p in sched.phases:
        burst = f" burst {p.burst_on}/{p.burst_off}" if p.burst_on else ""
        print(f"  {p.label:12s} {p.duration:4d}cy intensity="
              f"{p.intensity:.3f}{burst} peak-row="
              f"{np.asarray(p.traffic).sum(1).max():.3g} bytes")


if __name__ == "__main__":
    main()
