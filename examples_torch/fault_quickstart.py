"""Fault-injection quickstart: serve traffic through dead links
(DESIGN.md §12).

    PYTHONPATH=src python examples_torch/fault_quickstart.py \
        [--device cpu] [--out build/examples]

The port's `examples/fault_quickstart.py`: seeded link faults on
FoldedHexaTorus-36, the degraded topology re-routed deadlock-free
through the experiment pipeline, the degradation against Mesh, and a
mixed-tenant schedule (serving traffic superimposed on a training step)
through the same fault masks, on the CUDA card unless `--device cpu` is
given.  A disconnecting fault set is shown being rejected.  Writes
`OUT/fault_quickstart.csv`.
"""
import argparse
import os

import numpy as np

import repro_torch.experiments as X
import repro_torch.faults as F
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
    cfg = SimConfig(cycles=800, warmup=300)
    names = ("mesh", "folded_hexa_torus")
    ks = (0, 1, 2, 4)

    print("=== uniform-traffic degradation, N=36 organic ===")
    scenarios = []
    for name in names:
        topo = build(name, 36)
        for k in ks:
            fs = F.sample_faults(topo, k, "random", seed=0) if k else None
            scenarios.append(X.Scenario(
                name, 36, faults=fs, rates=X.SaturationGrid(4),
                tags=(("k_failed", k),)))
    frame = X.run(X.Experiment(scenarios, cfg=cfg,
                               name="fault_quickstart"), device=device)
    for row in frame.ok():
        print(f"  {row['topology']:18s} k={row['k_failed']} "
              f"faults={row['faults']:16s} "
              f"sat={row['sim_saturation']:.3f} "
              f"abs={row['abs_throughput_gbps'] / 1e3:.2f} Tb/s")

    print("\n=== mixed tenant (train collectives + 30% serving) "
          "through the same masks ===")
    mixed = W.mixed_tenant(get_config("qwen3_1_7b"), serve_frac=0.3)
    topo = build("folded_hexa_torus", 36)
    scenarios = [X.Scenario("folded_hexa_torus", 36, traffic=mixed,
                            faults=F.sample_faults(topo, k, "random",
                                                   seed=0) if k else None,
                            rates=X.SaturationGrid(3),
                            tags=(("k_failed", k),))
                 for k in (0, 2)]
    mf = X.run(X.Experiment(scenarios, cfg=cfg, name="fault_mixed"),
               device=device)
    for i, row in enumerate(mf.ok()):
        res = mf.workload_result(i)
        print(f"  k={row['k_failed']} sat={res['sim_saturation']:.3f} "
              f"lat={res['latency_at_sat']:.1f}cy "
              f"({len(res['phase_labels'])} phases)")

    print("\n=== partitioned packages are outages, not data points ===")
    mesh = build("mesh", 16)
    e = np.sort(np.asarray(mesh.edges), axis=1)
    cut = tuple(tuple(int(x) for x in lk) for lk in e[(e == 0).any(1)])
    try:
        F.FaultSet(links=cut).apply(mesh)
    except F.DisconnectedFaultError as err:
        print(f"  rejected: {err}")

    frame.to_csv(os.path.join(args.out, "fault_quickstart.csv"))


if __name__ == "__main__":
    main()
