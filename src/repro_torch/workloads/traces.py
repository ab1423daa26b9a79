"""Loadable, replayable region traces (DESIGN.md §9, paper §V-E).

The port's copy of `repro.workloads.traces`.  Two synthetic
Netrace-like profiles are 5-element `(intensity, mem_frac)` lists
(`traffic.TRACE_PROFILES`); this module generalizes them into a
first-class trace format:

  * a `Trace` is a named list of `TraceRegion`s, each with an intensity
    multiplier, a C/M/I memory fraction, a duration in cycles, and
    optional ON/OFF burst parameters;
  * traces round-trip through JSON (`Trace.save` / `load_trace`) so
    externally-profiled workloads can be replayed without code changes;
  * `Trace.to_schedule(topo)` materializes the regions as workload
    phases at a concrete topology/placement — the simulator then walks
    the regions cycle by cycle instead of evaluating each region as an
    independent stationary experiment (the fig10 approximation).

The built-in profiles reproduce the blackscholes (compute-heavy,
low traffic) and fluidanimate (memory-heavy bursts) shapes; the
fluidanimate regions carry ON/OFF bursts to model its phase-coupled
memory waves.
"""
from __future__ import annotations

import dataclasses
import json

from ..core import traffic as TR
from ..core.topology import Topology

from .schedule import Phase, Schedule, Workload


@dataclasses.dataclass
class TraceRegion:
    """One trace region -> one workload phase."""
    intensity: float            # injection-rate multiplier
    mem_frac: float             # C->M share of the region's flows
    duration: int = 500         # cycles
    burst_on: int = 0           # ON/OFF arrival modulation (0 = off)
    burst_off: int = 0


@dataclasses.dataclass
class Trace:
    name: str
    regions: list[TraceRegion]

    def to_schedule(self, topo: Topology) -> Schedule:
        """Regions -> phases at this topology's size and C/M/I placement."""
        phases = [Phase(traffic=TR.region_traffic(topo, r.mem_frac),
                        intensity=r.intensity, duration=r.duration,
                        burst_on=r.burst_on, burst_off=r.burst_off,
                        label=f"region{i}")
                  for i, r in enumerate(self.regions)]
        return Schedule(phases, name=f"trace:{self.name}")

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(dict(name=self.name,
                           regions=[dataclasses.asdict(r)
                                    for r in self.regions]), f, indent=2)


def load_trace(path: str) -> Trace:
    with open(path) as f:
        rec = json.load(f)
    return Trace(name=rec["name"],
                 regions=[TraceRegion(**r) for r in rec["regions"]])


def from_profile(profile: str, region_cycles: int = 500,
                 burst: tuple[int, int] = (0, 0)) -> Trace:
    """Lift a legacy `traffic.TRACE_PROFILES` entry into a Trace."""
    regions = [TraceRegion(intensity=i, mem_frac=m, duration=region_cycles,
                           burst_on=burst[0], burst_off=burst[1])
               for i, m in TR.TRACE_PROFILES[profile]]
    return Trace(name=profile, regions=regions)


# built-in traces: the two profiles, with fluidanimate's memory waves
# modelled as ON/OFF bursts (§V-E "memory-heavy bursts")
def builtin_traces(region_cycles: int = 500) -> dict[str, Trace]:
    t = {name: from_profile(name, region_cycles)
         for name in TR.TRACE_PROFILES}
    for r in t["fluidanimate"].regions:
        r.burst_on, r.burst_off = 25, 75
    return t


def trace_workload(topo: Topology, trace: str | Trace = "fluidanimate",
                   region_cycles: int = 500) -> Schedule:
    """Replayable schedule for a built-in profile name, a `Trace`, or a
    path to a saved trace JSON."""
    if isinstance(trace, str):
        if trace in TR.TRACE_PROFILES:
            trace = builtin_traces(region_cycles)[trace]
        else:
            trace = load_trace(trace)
    return trace.to_schedule(topo)


def trace_workloads(region_cycles: int = 500) -> list[Workload]:
    """Built-in traces wrapped for the sweep engine."""
    return [Workload(name=f"trace:{name}",
                     build=lambda topo, t=t: t.to_schedule(topo))
            for name, t in builtin_traces(region_cycles).items()]
