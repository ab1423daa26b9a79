"""Workload engine: time-varying traffic through the batched sweep.

The port of `repro.workloads`.  A workload is a `Schedule` of `Phase`s
— (traffic matrix, intensity, duration, burstiness) tuples — replayed
cyclically by the cycle simulator (DESIGN.md §9).  Three generator
families, as in the JAX package:

  * `collective_workload` — the collectives of a sharded LLM training
    step mapped onto chiplet positions (configs/ + models/sharding),
    and `mixed_tenant` — the same with a serving tenant's steady
    traffic blended into every phase;
  * `trace_workload` — loadable region traces, with ON/OFF bursts;
  * `synthetic` — adversarial phase-alternating / hotspot-drift /
    bursty-uniform schedules.

Run workloads with `SweepEngine.run_workloads` or directly via
`simulator.run_batch(specs, rates, schedules=...)`.
"""
from .collective import (collective_workload, collective_workloads,
                         default_mesh_shape)
from .mixed import mixed_tenant, mixed_tenant_workload, superimpose
from .schedule import Phase, Schedule, Workload, static_schedule
from .synthetic import bursty_uniform, hotspot_drift, phase_alternating
from .traces import (Trace, TraceRegion, builtin_traces, from_profile,
                     load_trace, trace_workload, trace_workloads)

__all__ = [
    "Phase", "Schedule", "Workload", "static_schedule",
    "collective_workload", "collective_workloads", "default_mesh_shape",
    "mixed_tenant", "mixed_tenant_workload", "superimpose",
    "trace_workload", "trace_workloads", "Trace", "TraceRegion",
    "builtin_traces", "from_profile", "load_trace",
    "phase_alternating", "hotspot_drift", "bursty_uniform",
]
