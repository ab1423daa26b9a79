"""Observability quickstart: flight recorder + span tracing
(DESIGN.md §13).

    PYTHONPATH=src python examples_torch/obs_quickstart.py \
        [--device cpu] [--out build/examples]

The port's `examples/obs_quickstart.py`: a tiny Mesh vs FoldedHexaTorus
experiment with the in-sim flight recorder on (`SimConfig(
telemetry=True)`) and host-side span tracing enabled, on the CUDA card
unless `--device cpu` is given, then the things the telemetry layer
gives you:

  1. per-link load — which directed channels carry the traffic, how
     unevenly (p95/max utilization, Gini imbalance), and why folding
     wins: its channel-load histogram is flatter at equal throughput;
  2. exact conservation — the per-node injection/ejection counters
     reconcile bitwise with the aggregate counters the simulator
     already reported, so the flight data is trustworthy, not sampled;
  3. where the wall-clock went — a Chrome-trace/Perfetto JSON of the
     plan -> execute -> dispatch/wait span tree
     (`OUT/obs_quickstart.trace.json`, load it in ui.perfetto.dev);
  4. load over TIME — `SimConfig(telemetry_windows=W)` bins the same
     counters into W time windows (DESIGN.md §16), so a drifting
     hotspot on FHT36 becomes visible as per-window Gini churn in
     `OUT/obs_quickstart_windows.csv` instead of averaging away.

Also writes the link loads to `OUT/obs_quickstart_links.csv`.  The
trace holds this run's spans only, and the printed sweep runs are this
run's (the tracer and the metrics registry are process-wide).
"""
import argparse
import os

import numpy as np

import repro_torch.experiments as X
import repro_torch.workloads as W
from repro_torch.core.simulator import SimConfig
from repro_torch.device import resolve_device
from repro_torch.obs import metrics
from repro_torch.obs.report import link_load_summary, window_summary
from repro_torch.obs.trace import (clear_trace, disable_tracing,
                                   enable_tracing, save_chrome_trace)

OUT = os.path.join("build", "examples")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT,
                    help="directory of the trace and the CSVs")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cfg = SimConfig(cycles=600, warmup=200, telemetry=True)
    exp = X.Experiment(
        [X.Scenario(name, 16, rates=X.SaturationGrid(4))
         for name in ("mesh", "folded_hexa_torus")],
        cfg=cfg, name="obs_quickstart")

    runs = metrics.get("sweep.runs")
    clear_trace()
    enable_tracing()
    frame = X.run(exp, device=device)
    disable_tracing()
    runs = metrics.get("sweep.runs") - runs

    print("=== 1. per-link load at saturation (the paper's mechanism) ===")
    for cell in link_load_summary(frame.all_link_rows()):
        print(f"  {cell['topology']:18s} links={cell['n_links']:3d} "
              f"p50={cell['util_p50']:.3f} p95={cell['util_p95']:.3f} "
              f"max={cell['util_max']:.3f} gini={cell['gini']:.3f}")
    mesh, fht = frame.rows[0], frame.rows[1]
    print(f"  -> folding flattens the load: FHT gini "
          f"{fht['link_gini']:.3f} vs mesh {mesh['link_gini']:.3f}")

    print("\n=== 2. conservation: flight counters == aggregate counters "
          "===")
    for i, row in enumerate(frame.rows):
        res = frame.results[i]
        if row["status"] != "ok" or res is None:
            continue
        np.testing.assert_array_equal(res["inj_node"].sum(axis=1),
                                      res["accepted_n"])
        np.testing.assert_array_equal(res["eject_node"].sum(axis=1),
                                      res["delivered"])
        np.testing.assert_array_equal(res["lat_hist"].sum(axis=1),
                                      res["delivered"])
        print(f"  {row['topology']:18s} sum(inj)==accepted, "
              f"sum(eject)==delivered, sum(hist)==delivered  [exact]")

    print("\n=== 3. where the wall-clock went ===")
    trace_path = os.path.join(args.out, "obs_quickstart.trace.json")
    save_chrome_trace(trace_path, metadata=dict(example="obs_quickstart"))
    # the simulator compiles nothing per shape (its CUDA graphs are
    # captured anew each run): the port has no compiled-runner cache, so
    # it prints no compile or cache counts
    print(f"  sweep runs={runs:.0f}")
    print(f"  open {trace_path} in ui.perfetto.dev for the span tree")

    frame.to_link_csv(os.path.join(args.out, "obs_quickstart_links.csv"))

    print("\n=== 4. windowed time-heatmap: a hotspot drifting across "
          "FHT36 ===")
    wcfg = SimConfig(cycles=900, warmup=300, telemetry=True,
                     telemetry_windows=6)
    drift = W.Workload("hotspot_drift",
                       lambda topo: W.hotspot_drift(topo, n_phases=6,
                                                    dwell=100))
    wexp = X.Experiment(
        [X.Scenario("folded_hexa_torus", 36, traffic=drift,
                    rates=X.SaturationGrid(3))],
        cfg=wcfg, name="obs_quickstart_windows")
    wframe = X.run(wexp, device=device)
    wframe.to_window_csv(
        os.path.join(args.out, "obs_quickstart_windows.csv"))
    print("  per-window channel-load imbalance (gini) and the "
          "escape/adaptive occupancy split:")
    for s in window_summary(wframe.all_window_rows()):
        print(f"  window {s['window']} "
              f"[t={s['t_start']:4d}..{s['t_end']:4d}) "
              f"util_p95={s['util_p95']:.3f} gini={s['gini']:.3f} "
              f"occ_esc={s['occ_escape_mean']:.3f} "
              f"occ_adapt={s['occ_adaptive_mean']:.3f}")
    print("  -> each window's hot channels move with the hotspot; the "
          "aggregate heatmap above averages this away")


if __name__ == "__main__":
    main()
