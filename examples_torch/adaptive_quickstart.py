"""Adaptive-routing quickstart: minimal-adaptive with escape VCs
(DESIGN.md §15).

    PYTHONPATH=src python examples_torch/adaptive_quickstart.py \
        [--device cpu] [--out build/examples]

The port's `examples/adaptive_quickstart.py`, on the CUDA card unless
`--device cpu` is given.  Walks the three layers of the adaptive
subsystem on a drifting-hotspot workload — the traffic adaptivity is
built for:

  1. the productive-ports mask and its RT005 escape certification:
     every adaptive choice keeps a deliverable escape path and the
     escape-class channel-dependency graph stays acyclic;
  2. a static-vs-adaptive saturation comparison through `run_batch`
     with the `repro_torch.adaptive` config (both modes, one hotspot
     schedule);
  3. the same comparison through `repro_torch.experiments` — the
     routing mode rides in `Scenario(routing=...)`, so one declarative
     experiment runs both modes and the frame carries a `routing`
     column.

It writes no file; `--out` is accepted so that every example takes the
same flags.
"""
import argparse
import os

import numpy as np

import repro_torch.adaptive as A
import repro_torch.experiments as X
import repro_torch.workloads as W
from repro_torch.analysis.routing_verify import certify_routing
from repro_torch.core import topology as T, traffic as TR
from repro_torch.core.routing import build_routing
from repro_torch.core.simulator import SimConfig, make_spec, run_batch
from repro_torch.device import resolve_device

OUT = os.path.join("build", "examples")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT, help="unused: writes no file")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    n = 36
    r = build_routing(T.build("mesh", n))

    print("=== 1. productive ports + escape certification (RT005) ===")
    prod = A.productive_ports(r)
    cert = certify_routing(r)
    print(f"  mask [N_dst, N, P] = {prod.shape}, "
          f"{int(prod.sum())} productive entries")
    print(f"  certificate: ok={cert.ok} escape_safe={cert.escape_safe} "
          f"adaptive_choices={cert.n_adaptive_choices}")
    assert cert.ok, "escape certification must pass for Table III"

    print("\n=== 2. static vs adaptive under a drifting hotspot ===")
    cfg = SimConfig(cycles=1000, warmup=300)
    sched = W.hotspot_drift(r.topo, n_phases=4, dwell=250,
                            seed=2).fit(cfg.cycles).compile()
    spec = make_spec(r, TR.uniform(r.topo))
    rates = np.linspace(0.05, 0.9, 6).astype(np.float32)[None, :]
    st = run_batch([spec], rates, cfg, schedules=[sched],
                   device=device)[0]
    ad = run_batch([spec], rates, A.adaptive_config(cfg),
                   schedules=[sched], device=device)[0]
    s = float(np.max(np.asarray(st["throughput"])))
    a = float(np.max(np.asarray(ad["throughput"])))
    print(f"  mesh{n}, hotspot_drift: static {s:.3f} "
          f"adaptive {a:.3f}  gain {a / s - 1.0:+.1%}")

    print("\n=== 3. the same thing declaratively, via Scenario(routing) "
          "===")
    wl = W.Workload("hotspot_drift",
                    lambda topo: W.hotspot_drift(topo, n_phases=4,
                                                 dwell=250, seed=2))
    exp = X.Experiment(
        [X.Scenario("folded_hexa_torus", n, traffic=wl, routing=mode,
                    rates=X.SaturationGrid(4))
         for mode in ("static", "adaptive")],
        cfg=cfg, name="adaptive_quickstart")
    frame = X.run(exp, device=device)
    for row in frame.rows:
        print(f"  {row['topology']:18s} routing={row['routing']:8s} "
              f"sim_saturation={row['sim_saturation']:.3f}")
    print("  -> FHT's static channel load is already flat, so its "
          "adaptive margin is small")


if __name__ == "__main__":
    main()
