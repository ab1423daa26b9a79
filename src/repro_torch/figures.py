"""The paper's figures and tables through the port's experiment API.

    python -m repro_torch.figures [--sim] [--only NAME] [--sizes 16 64 ...]
                                  [--device cpu] [--out DIR]

NAME is a grid figure (fig4, fig7, fig8, fig10) or a table (fig2,
table1, table2, table3, collectives); without `--only`, all of them.
The grids are those of the JAX package's `benchmarks/paper_benches.py`:

  fig4 fig7 fig8 fig10  scenario grids through `repro_torch.experiments.
                        run`; the tidy `ResultFrame` is the CSV
  fig2                  the link model: data rate vs link length per
                        substrate
  table1                chiplet area relative to mesh (N = 64, 3 areas)
  table2                power at saturation relative to mesh, mean and
                        spread over the sizes
  table3                diameter, radix and link range of every topology
                        at N = 64 and 256
  collectives           the framework bridge: all-reduce / all-gather time
                        under each ICI topology (`core.collectives.
                        build_ici_model`, analytic)

The grids and Tables I-II run analytically by default (the channel-load
model; no simulation), with the cycle simulator under `--sim`, at the
benchmarks' `SimConfig(cycles=2000, warmup=700)`.  Each one's rows go to
`DIR/<name>.csv` (default `build/figures/`).

Runs on the CUDA card unless `--device cpu` is given, and raises
without a card (fig2, table3 and collectives compute on the host, but
take the same rule).  A simulated figure at the paper's sizes is work
for the card; on a CPU, pass small `--sizes`.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from functools import partial

import numpy as np

from . import experiments as X
from .core import linkmodel as lm
from .core import topology as T
from .core import traffic as TR
from .core.collectives import build_ici_model
from .core.simulator import SimConfig
from .device import resolve_device
from .experiments import io as xio

#: the benchmarks' sizes and simulator settings (benchmarks/common.py)
SIZES = [16, 64, 144, 256]
SIM_CFG = SimConfig(cycles=2000, warmup=700)
OUT_DIR = os.path.join("build", "figures")

PRINCIPLED = ["mesh", "folded_torus", "hexamesh", "folded_hexa_torus",
              "octamesh", "folded_octa_torus"]
AREAS = (37.0, 74.0, 148.0)          # chiplet areas (mm²) of Fig. 4, Tables I-II
ALL_TOPOLOGIES = list(T.GENERATORS)
FIG10_TOPOLOGIES = ["mesh", "folded_torus", "hexamesh",
                    "folded_hexa_torus", "kite_medium", "sid_mesh",
                    "double_butterfly", "octamesh"]


def fig4_scenarios(sizes) -> list:
    """Fig. 4: principled topologies x 3 chiplet sizes, organic."""
    return [X.Scenario(name, n, "organic", "uniform", area=area)
            for area in AREAS
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


def _frame(scenarios, use_sim, cfg, device, name) -> X.ResultFrame:
    return X.run(X.Experiment(scenarios, cfg=cfg, name=name,
                              backend="sim" if use_sim else "analytic"),
                 device=device)


def fig2_rows(sizes=None, use_sim=False, cfg=SIM_CFG, device=None) -> list:
    """Fig. 2: data rate vs link length for all substrates."""
    return [dict(substrate=sub, length_mm=float(length),
                 rate_frac=float(lm.rate_fraction(length, sub)),
                 rate_gbps=float(lm.rate_gbps(length, sub)))
            for sub in ("organic", "glass", "passive_interposer")
            for length in np.linspace(0, 75, 76)]


def table1_rows(sizes=None, use_sim=False, cfg=SIM_CFG,
                device=None) -> list:
    """Table I: chiplet area relative to mesh, N = 64."""
    frame = _frame([X.Scenario(name, 64, "organic", area=area)
                    for area in AREAS for name in PRINCIPLED],
                   use_sim, cfg, device, "table1")
    rows = []
    for area in AREAS:
        base = frame.select(topology="mesh",
                            area_mm2=area)[0]["chiplet_area_mm2"]
        for r in frame.select(area_mm2=area):
            rows.append(dict(topology=r["topology"], area_mm2=area,
                             chiplet_area_mm2=r["chiplet_area_mm2"],
                             rel_vs_mesh_pct=100 * (
                                 r["chiplet_area_mm2"] / base - 1)))
    return rows


def table2_rows(sizes=None, use_sim=False, cfg=SIM_CFG,
                device=None) -> list:
    """Table II: power at saturation relative to mesh (mean and spread
    over the sizes)."""
    frame = _frame([X.Scenario(name, n, "organic", area=area)
                    for area in AREAS for name in PRINCIPLED
                    for n in sizes or SIZES],
                   use_sim, cfg, device, "table2")
    rows = []
    for area in AREAS:
        for name in PRINCIPLED:
            rels = [100 * (r["power_w"] /
                           frame.select(topology="mesh", n=r["n"],
                                        area_mm2=area)[0]["power_w"] - 1)
                    for r in frame.select(topology=name, area_mm2=area)]
            rows.append(dict(topology=name, area_mm2=area,
                             power_rel_mean_pct=float(np.mean(rels)),
                             power_rel_std_pct=float(np.std(rels))))
    return rows


def table3_rows(sizes=None, use_sim=False, cfg=SIM_CFG,
                device=None) -> list:
    """Table III: measured diameter, radix and link range of every
    topology at N = 64 and 256."""
    rows = []
    for name in ALL_TOPOLOGIES:
        for n in (64, 256):
            if name in T.N_CONSTRAINTS and not T.N_CONSTRAINTS[name](n):
                continue
            t = T.build(name, n)
            rows.append(dict(topology=name, n=n, diameter=t.diameter,
                             radix=t.radix,
                             max_link_range=int(t.link_ranges().max()),
                             max_link_mm=round(t.max_link_length_mm(), 1)))
    return rows


def collectives_rows(sizes=None, use_sim=False, cfg=SIM_CFG,
                     device=None) -> list:
    """The framework bridge: collective time under each ICI topology
    (the analytic `IciModel`, as the JAX package's bench)."""
    rows = []
    for name in ("mesh", "hexamesh", "folded_torus", "folded_hexa_torus"):
        for n in (64, 256):
            m = build_ici_model(name, n, "organic")
            for s in (2 ** 24, 2 ** 30):
                rows.append(dict(
                    topology=name, n=n, bytes=s,
                    allreduce_ms=1e3 * m.collective_time_s("all_reduce", s),
                    allgather_ms=1e3 * m.collective_time_s("all_gather", s),
                    b_eff_gbps=m.b_eff_gbps))
    return rows


TABLES = {
    "fig2": fig2_rows,
    "table1": table1_rows,
    "table2": table2_rows,
    "table3": table3_rows,
    "collectives": collectives_rows,
}


def table(name: str, sizes=None, use_sim: bool = False,
          cfg: SimConfig = SIM_CFG, device=None,
          out_dir: str | None = OUT_DIR) -> list:
    """One table's rows (or Fig. 2's); write `out_dir/<name>.csv` unless
    out_dir is None."""
    resolve_device(device)
    rows = TABLES[name](sizes, use_sim, cfg, device)
    if out_dir is not None:
        xio.write_csv(os.path.join(out_dir, f"{name}.csv"), rows)
    return rows


def figure(name: str, sizes=None, use_sim: bool = False,
           cfg: SimConfig = SIM_CFG, device=None,
           out_dir: str | None = OUT_DIR) -> X.ResultFrame:
    """Run one figure's grid; write `out_dir/<name>.csv` unless out_dir
    is None.  Returns the `ResultFrame`."""
    build, default_sizes = FIGURES[name]
    frame = _frame(build(sizes or default_sizes), use_sim, cfg, device,
                   name)
    if out_dir is not None:
        frame.to_csv(os.path.join(out_dir, f"{name}.csv"))
    return frame


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sim", action="store_true",
                    help="cycle simulator instead of the analytic model")
    ap.add_argument("--only", choices=sorted([*FIGURES, *TABLES]),
                    default=None)
    ap.add_argument("--sizes", type=int, nargs="+", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    print("figure,seconds,ok_rows,best_abs_throughput")
    for name in [*FIGURES, *TABLES]:
        if args.only and args.only != name:
            continue
        t0 = time.perf_counter()
        if name in TABLES:
            rows = table(name, args.sizes, args.sim, device=args.device,
                         out_dir=args.out)
            print(f"{name},{time.perf_counter() - t0:.3f},{len(rows)},",
                  flush=True)
            continue
        frame = figure(name, args.sizes, args.sim, device=args.device,
                       out_dir=args.out)
        best = frame.best("abs_throughput_gbps")
        print(f"{name},{time.perf_counter() - t0:.3f},{len(frame.ok())},"
              f"{best['topology']}/n{best['n']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
