"""Declarative experiment API (DESIGN.md §10): the one front door.

The port of `repro.experiments`:

    import repro_torch.experiments as X

    exp = X.Experiment.grid(
        topologies=["mesh", "folded_hexa_torus"], sizes=[16, 64],
        substrates=["organic", "glass"],
        traffics=["uniform", my_workload],          # static + workload
        rates=X.SaturationGrid(6), cfg=SimConfig(...))
    frame = X.run(exp)                              # on the CUDA card
    frame = X.run(exp, device="cpu")                # on the CPU
    frame.to_csv("build/figures/my_grid.csv")       # versioned schema

`Scenario -> plan -> execute -> ResultFrame` lowers onto the padded
`SweepEngine` batches (`run_specs` / `run_workloads`), whose padding
invariance makes results independent of how scenarios are grouped;
tidy rows and raw results equal the JAX package's for the same
experiment (tests/test_torch_experiments.py).

Adaptive routing (`Scenario(routing="adaptive")` or the Experiment's
SimConfig) plans its own buckets.  Run with `SimConfig(telemetry=True)`
and the frame carries the flight recorder's counters: tidy rows gain
`link_util_p95` / `link_util_max` / `link_gini`, and
`ResultFrame.link_rows` / `all_link_rows` / `to_link_csv` render the
per-channel heatmap; with `telemetry_windows=W` also `window_rows` /
`all_window_rows` / `to_window_csv` (see `repro_torch.obs`).
"""
from .execute import engine_for, execute, run
from .frame import COLUMNS, ResultFrame, scenario_row
from .io import SCHEMA_VERSION, read_json, write_csv, write_json
from .plan import (Bucket, BucketKey, Plan, PlannedScenario, plan,
                   resolve_topology)
from .scenario import (CustomTraffic, Experiment, ExplicitRates,
                       RatePolicy, SaturationGrid, Scenario,
                       scenario_from_case)

__all__ = [
    "Scenario", "Experiment", "CustomTraffic", "SaturationGrid",
    "ExplicitRates", "RatePolicy", "scenario_from_case",
    "plan", "Plan", "PlannedScenario", "Bucket", "BucketKey",
    "resolve_topology",
    "execute", "run", "engine_for",
    "ResultFrame", "COLUMNS", "scenario_row",
    "SCHEMA_VERSION", "write_csv", "write_json", "read_json",
]
