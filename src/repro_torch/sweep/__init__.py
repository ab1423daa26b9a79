"""repro_torch.sweep — shape padding (specs and phase schedules) and the
batched sweep engine (`run_specs`, `run_workloads`)."""
from .engine import SweepCase, SweepEngine
from .padding import (BatchSpec, PadShape, SchedBatch, pad_schedule,
                      pad_spec, stack_schedules, stack_specs)

__all__ = ["SweepCase", "SweepEngine", "BatchSpec", "PadShape",
           "pad_spec", "stack_specs", "SchedBatch", "pad_schedule",
           "stack_schedules"]
