"""The paper's figure grids through the port's experiment API.

    python -m repro_torch.figures [--sim] [--only fig4|fig7|fig8|fig10]
                                  [--sizes 16 64 ...] [--device cpu]
                                  [--out DIR]

Runs the scenario grids of Figs. 4, 7, 8 and 10 (the same grids as the
JAX package's `benchmarks/paper_benches.py`) through
`repro_torch.experiments.run`: analytically by default (the channel-load
model; no simulation), with the cycle simulator under `--sim`, at the
benchmarks' `SimConfig(cycles=2000, warmup=700)`.  Each figure's tidy
`ResultFrame` goes to `DIR/<fig>.csv` (default `build/figures/`).

Runs on the CUDA card unless `--device cpu` is given, and raises
without a card.  A simulated figure at the paper's sizes is work for
the card; on a CPU, pass small `--sizes`.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from functools import partial

from . import experiments as X
from .core import topology as T
from .core import traffic as TR
from .core.simulator import SimConfig

#: the benchmarks' sizes and simulator settings (benchmarks/common.py)
SIZES = [16, 64, 144, 256]
SIM_CFG = SimConfig(cycles=2000, warmup=700)
OUT_DIR = os.path.join("build", "figures")

PRINCIPLED = ["mesh", "folded_torus", "hexamesh", "folded_hexa_torus",
              "octamesh", "folded_octa_torus"]
ALL_TOPOLOGIES = list(T.GENERATORS)
FIG10_TOPOLOGIES = ["mesh", "folded_torus", "hexamesh",
                    "folded_hexa_torus", "kite_medium", "sid_mesh",
                    "double_butterfly", "octamesh"]


def fig4_scenarios(sizes) -> list:
    """Fig. 4: principled topologies x 3 chiplet sizes, organic."""
    return [X.Scenario(name, n, "organic", "uniform", area=area)
            for area in (37.0, 74.0, 148.0)
            for name in PRINCIPLED
            for n in sizes]


def fig7_scenarios(sizes) -> list:
    """Fig. 7: all topologies x {homo, hetero} x {organic, glass}."""
    return [X.Scenario(name, n, substrate, pattern, roles=roles)
            for substrate in ("organic", "glass")
            for roles, pattern in (("homogeneous", "uniform"),
                                   ("hetero_cm", "hetero_mix"))
            for name in ALL_TOPOLOGIES
            for n in sizes]


def fig8_scenarios(sizes) -> list:
    """Fig. 8: permutation / tornado / neighbor on glass, homogeneous."""
    return [X.Scenario(name, n, "glass", pattern)
            for pattern in ("permutation", "tornado", "neighbor")
            for name in ALL_TOPOLOGIES
            for n in sizes]


def _region_matrix(topo, profile, region):
    return TR.trace_region_traffic(topo, profile, region)[0]


def fig10_scenarios(sizes) -> list:
    """Fig. 10: synthetic Netrace-like traces, C/M/I placement, organic
    (default sizes 64 and 144)."""
    scens = []
    for profile in ("blackscholes", "fluidanimate"):
        for region in range(5):
            intensity = TR.TRACE_PROFILES[profile][region][0]
            tr = X.CustomTraffic(f"{profile}:r{region}",
                                 partial(_region_matrix, profile=profile,
                                         region=region))
            for name in FIG10_TOPOLOGIES:
                for n in sizes:
                    scens.append(X.Scenario(
                        name, n, "organic", tr, roles="hetero_cmi",
                        tags=(("profile", profile), ("region", region),
                              ("intensity", intensity))))
    return scens


FIGURES = {
    "fig4": (fig4_scenarios, SIZES),
    "fig7": (fig7_scenarios, SIZES),
    "fig8": (fig8_scenarios, SIZES),
    "fig10": (fig10_scenarios, [64, 144]),
}


def figure(name: str, sizes=None, use_sim: bool = False,
           cfg: SimConfig = SIM_CFG, device=None,
           out_dir: str | None = OUT_DIR) -> X.ResultFrame:
    """Run one figure's grid; write `out_dir/<name>.csv` unless out_dir
    is None.  Returns the `ResultFrame`."""
    build, default_sizes = FIGURES[name]
    exp = X.Experiment(build(sizes or default_sizes), cfg=cfg, name=name,
                       backend="sim" if use_sim else "analytic")
    frame = X.run(exp, device=device)
    if out_dir is not None:
        frame.to_csv(os.path.join(out_dir, f"{name}.csv"))
    return frame


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sim", action="store_true",
                    help="cycle simulator instead of the analytic model")
    ap.add_argument("--only", choices=sorted(FIGURES), default=None)
    ap.add_argument("--sizes", type=int, nargs="+", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    print("figure,seconds,ok_rows,best_abs_throughput")
    for name in FIGURES:
        if args.only and args.only != name:
            continue
        t0 = time.perf_counter()
        frame = figure(name, args.sizes, args.sim, device=args.device,
                       out_dir=args.out)
        best = frame.best("abs_throughput_gbps")
        print(f"{name},{time.perf_counter() - t0:.3f},{len(frame.ok())},"
              f"{best['topology']}/n{best['n']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
