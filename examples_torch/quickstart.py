"""Quickstart: build FoldedHexaTorus, route it, then evaluate a whole
topology grid through the declarative experiment API (DESIGN.md §10).

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu] \
        [--out build/examples]

The port's `examples/quickstart.py`: the same topology, grid and
simulated check, on the CUDA card unless `--device cpu` is given.  The
routing is certified by `certify_routing` (deadlock freedom,
reachability, well-formed tables).  Writes `OUT/quickstart.csv`.
"""
import argparse
import os

import repro_torch.experiments as X
from repro_torch.analysis.routing_verify import certify_routing
from repro_torch.core import topology as T, traffic as TR
from repro_torch.core.routing import build_routing
from repro_torch.core.simulator import SimConfig
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
    print("=== the core layer: one topology, routed and checked ===")
    topo = T.build("folded_hexa_torus", 64, substrate="organic")
    routing = build_routing(topo)
    assert certify_routing(routing).ok
    u = TR.uniform(topo)
    print(f"folded_hexa_torus    diam={topo.diameter:2d} "
          f"radix={topo.radix} "
          f"maxlink={topo.max_link_length_mm():5.1f}mm "
          f"analytic T_r={routing.saturation_rate(u):.3f}")

    print("\n=== the experiment API: a grid through one front door ===")
    exp = X.Experiment.grid(
        topologies=["mesh", "hexamesh", "folded_torus",
                    "folded_hexa_torus"],
        sizes=[64], name="quickstart", backend="analytic")
    frame = X.run(exp, device=device)
    for r in frame.ok():
        print(f"{r['topology']:20s} T_r={r['rel_throughput']:.3f} "
              f"flits/node/cyc  T_a={r['abs_throughput_gbps']/1e3:7.2f} "
              f"Tb/s  lat={r['latency_ns']:5.1f}ns")
    frame.to_csv(os.path.join(args.out, "quickstart.csv"))

    print("\n=== cycle-accurate check (16 chiplets, simulated) ===")
    sim_exp = X.Experiment(
        [X.Scenario("folded_hexa_torus", 16,
                    rates=X.SaturationGrid(5))],
        cfg=SimConfig(cycles=1500, warmup=500), name="quickstart_sim")
    res = X.run(sim_exp, device=device).case_result(0)
    print(f"simulated saturation {res['sim_saturation']:.3f} "
          f"(analytic bound {res['analytic_saturation']:.3f}), "
          f"latency@sat {res['latency_at_sat']:.1f} cycles")


if __name__ == "__main__":
    main()
