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

Deferred to later slices, each raising `NotImplementedError`: scenarios
with `routing="adaptive"` (at plan time) and the flight-recorder views
of `ResultFrame` (`link_rows`, `window_rows`, ...).
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
