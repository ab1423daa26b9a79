"""Collective-derived workloads: LLM training traffic on chiplets.

The port of `repro.workloads.collective` (numpy; the schedules equal
the JAX package's for the same config and topology).

`collective_workload` compiles a sharded model training step into a
phase schedule (DESIGN.md §9):

  1. `models.sharding.step_collective_ops` derives the step's ordered
     collectives (FSDP all-gather, per-layer TP all-reduces, MoE
     all-to-all, gradient reduce-scatter) and their bytes from the
     architecture config and a logical mesh shape;
  2. `core.collectives.mesh_axis_groups` maps the mesh onto the chiplet
     placement (model groups physically contiguous) and
     `collective_flow` turns each collective into an [N, N] byte-flow
     matrix over those groups;
  3. ops sharing a phase are summed, phase durations are split
     proportionally to phase bytes (time ~ data over fixed wires), and
     intensities carry each phase's per-source demand *rate* so heavy
     concentrated phases drive the network harder than diffuse ones.

The result connects the repo's dormant LLM stack (configs/, models/) to
the cycle-accurate network simulator: the headline question "how does
FoldedHexaTorus hold up under qwen3-style training traffic on glass vs
organic?" becomes one batched `run_workloads` call
(benchmarks/workload_bench.py).
"""
from __future__ import annotations

import numpy as np

from ..core.collectives import collective_flow, mesh_axis_groups
from ..core.topology import Topology
from ..models.sharding import step_collective_ops

from .schedule import Phase, Schedule, Workload


def default_mesh_shape(n: int, model_parallel: int = 0) -> dict:
    """{"data": D, "model": T} with T*D == N; prefers TP degree 8/4/2."""
    if model_parallel:
        if n % model_parallel:
            raise ValueError(f"model_parallel {model_parallel} does not "
                             f"divide N={n}")
        return {"data": n // model_parallel, "model": model_parallel}
    for tm in (8, 4, 2):
        if n % tm == 0 and n // tm >= 2:
            return {"data": n // tm, "model": tm}
    return {"data": n, "model": 1}


def collective_workload(config, topo: Topology, *, mesh_shape: dict = None,
                        seq_len: int = 2048, global_batch: int = 0,
                        step_cycles: int = 1000, min_phase: int = 50,
                        dtype_bytes: int = 2) -> Schedule:
    """Phase schedule of one sharded training step of `config` on `topo`.

    config: a `ModelConfig` (or any object with its size fields);
    mesh_shape defaults to TP-8/4/2 x FSDP over the remaining chiplets;
    global_batch defaults to 4 sequences per data shard; step_cycles is
    the replayed step's length, split across phases by bytes moved.
    """
    mesh_shape = mesh_shape or default_mesh_shape(topo.n)
    dm = int(mesh_shape.get("data", 1))
    global_batch = global_batch or 4 * dm
    ops = step_collective_ops(config, mesh_shape, seq_len=seq_len,
                              global_batch=global_batch,
                              dtype_bytes=dtype_bytes)
    # phase -> flow matrix + payload bytes, in op order
    flows: dict[str, np.ndarray] = {}
    payload: dict[str, float] = {}
    for op in ops:
        groups = mesh_axis_groups(topo, mesh_shape, op.axis)
        f = collective_flow(topo.n, op.kind, groups, op.bytes_per_chip)
        if f.sum() <= 0:        # degenerate axis (groups of 1): skip
            continue
        flows[op.phase] = flows.get(op.phase, 0) + f
        payload[op.phase] = payload.get(op.phase, 0.0) + op.bytes_per_chip
    if not flows:
        raise ValueError("sharded step issues no collectives on this mesh")

    total = sum(payload.values())
    durations = {p: max(min_phase, int(round(step_cycles * b / total)))
                 for p, b in payload.items()}
    # per-source demand rate: heaviest row of the phase's flow matrix,
    # spread over the phase's duration; normalized so the peak phase
    # drives intensity 1.0 (the rate sweep scales everything together)
    rates = {p: flows[p].sum(axis=1).max() / durations[p] for p in flows}
    peak = max(rates.values())
    phases = [Phase(traffic=flows[p], intensity=rates[p] / peak,
                    duration=durations[p], label=p) for p in flows]
    return Schedule(phases, name=f"collective:{config.name}")


def collective_workloads(configs, **kw) -> list[Workload]:
    """Wrap architecture configs for the sweep engine."""
    return [Workload(name=f"collective:{c.name}",
                     build=lambda topo, c=c: collective_workload(
                         c, topo, **kw))
            for c in configs]
