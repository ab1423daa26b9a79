"""Workload engine: time-varying traffic through the batched sweep.

The port of `repro.workloads`.  A workload is a `Schedule` of `Phase`s
— (traffic matrix, intensity, duration, burstiness) tuples — replayed
cyclically by the cycle simulator (DESIGN.md §9).  Two generator
families are ported:

  * `trace_workload` — loadable region traces, with ON/OFF bursts;
  * `synthetic` — adversarial phase-alternating / hotspot-drift /
    bursty-uniform schedules.

The collective workloads (`collective_workload`, `mixed_tenant`, ...)
map a sharded LLM training step's collectives onto chiplets; they need
a jax-free copy of the reference's `step_collective_ops` and come with
the collective-workloads slice of the port: until then they raise
`NotImplementedError`.

Run workloads with `SweepEngine.run_workloads` or directly via
`simulator.run_batch(specs, rates, schedules=...)`.
"""
from .schedule import Phase, Schedule, Workload, static_schedule
from .synthetic import bursty_uniform, hotspot_drift, phase_alternating
from .traces import (Trace, TraceRegion, builtin_traces, from_profile,
                     load_trace, trace_workload, trace_workloads)


def _collective_slice(name):
    def deferred(*args, **kwargs):
        raise NotImplementedError(
            f"workloads.{name} comes with the collective-workloads slice "
            f"of the port (it needs a jax-free step_collective_ops)")
    deferred.__name__ = name
    return deferred


collective_workload = _collective_slice("collective_workload")
collective_workloads = _collective_slice("collective_workloads")
default_mesh_shape = _collective_slice("default_mesh_shape")
mixed_tenant = _collective_slice("mixed_tenant")
mixed_tenant_workload = _collective_slice("mixed_tenant_workload")
superimpose = _collective_slice("superimpose")

__all__ = [
    "Phase", "Schedule", "Workload", "static_schedule",
    "collective_workload", "collective_workloads", "default_mesh_shape",
    "mixed_tenant", "mixed_tenant_workload", "superimpose",
    "trace_workload", "trace_workloads", "Trace", "TraceRegion",
    "builtin_traces", "from_profile", "load_trace",
    "phase_alternating", "hotspot_drift", "bursty_uniform",
]
