"""Collective-derived workloads: LLM training traffic on chiplets.

The port of `repro.workloads.collective` (numpy; the schedules equal
the JAX package's for the same config and topology).

`collective_workload` compiles a sharded model training step into a
phase schedule (DESIGN.md §9):

  1. the step's ordered collectives and their bytes come from the
     architecture config and a logical mesh shape: on a {"data",
     "model"} mesh `models.sharding.step_collective_ops` (FSDP
     all-gather, per-layer TP all-reduces, MoE all-to-all, gradient
     reduce-scatter), on a {"pipe", "node", "local"} mesh
     `models.pipeline_step.step_collective_ops` (pipeline sends,
     two-stage expert dispatch and combine, ZeRO-1's reduce-scatter
     and all-gather, each op of one stage);
  2. `core.collectives.mesh_axis_groups` maps the mesh onto the chiplet
     placement (model groups physically contiguous) and
     `collective_flow` turns each collective into an [N, N] byte-flow
     matrix over those groups (`op_flow`);
  3. ops sharing a phase are summed, phase durations are split
     proportionally to phase bytes (time ~ data over fixed wires), and
     intensities carry each phase's per-source demand *rate* so heavy
     concentrated phases drive the network harder than diffuse ones.

The result connects the repo's dormant LLM stack (configs/, models/) to
the cycle-accurate network simulator: the headline question "how does
FoldedHexaTorus hold up under qwen3-style training traffic on glass vs
organic?" becomes one batched `run_workloads` call (the benchmark's
`collectives-*` and `deepseek-v3-*` cells under `perfbench/`).
"""
from __future__ import annotations

import numpy as np

from ..core.collectives import collective_flow, mesh_axis_groups, \
    mesh_coords
from ..core.topology import Topology
from ..models import pipeline_step as PS
from ..models.sharding import step_collective_ops
from ..obs.metrics import metrics
from ..obs.trace import trace

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


def op_flow(topo: Topology, mesh_shape: dict, op) -> np.ndarray:
    """[N, N] byte flows of one op: its mesh axes' groups on the
    placement, its kind's flow within each group; an op of one pipeline
    stage keeps the rows of that stage's chiplets alone."""
    groups = mesh_axis_groups(topo, mesh_shape, op.axis)
    if not isinstance(op, PS.StageOp):
        return collective_flow(topo.n, op.kind, groups, op.bytes_per_chip)
    f = collective_flow(topo.n, op.kind, groups, op.bytes_per_chip,
                        op.shares)
    f[mesh_coords(topo, mesh_shape)[PS.PIPE] != op.stage] = 0.0
    return f


def step_ops(config, mesh_shape: dict, *, seq_len: int, global_batch: int,
             dtype_bytes: int, dispatch_bytes: int) -> tuple:
    """(scheme, ops) of one training step on `mesh_shape`: "pp_ep_zero1"
    on a pipe x node x local mesh, which needs global_batch and
    dispatch_bytes; else "tp_fsdp", which takes no dispatch_bytes and
    whose global_batch 0 is 4 sequences per data rank."""
    pipeline = PS.is_pipeline_mesh(mesh_shape)
    if bool(dispatch_bytes) != pipeline or pipeline and not global_batch:
        raise ValueError(
            "a pipe x node x local mesh, and no other, takes dispatch_bytes"
            f" and needs global_batch; got {mesh_shape}, dispatch_bytes="
            f"{dispatch_bytes}, global_batch={global_batch}")
    if pipeline:
        return "pp_ep_zero1", PS.step_collective_ops(
            config, mesh_shape, seq_len=seq_len, global_batch=global_batch,
            dtype_bytes=dtype_bytes, dispatch_bytes=dispatch_bytes)
    dm = int(mesh_shape.get("data", 1))
    return "tp_fsdp", step_collective_ops(
        config, mesh_shape, seq_len=seq_len,
        global_batch=global_batch or 4 * dm, dtype_bytes=dtype_bytes)


def collective_workload(config, topo: Topology, *, mesh_shape: dict = None,
                        seq_len: int = 2048, global_batch: int = 0,
                        step_cycles: int = 1000, min_phase: int = 50,
                        dtype_bytes: int = 2,
                        dispatch_bytes: int = 0) -> Schedule:
    """Phase schedule of one sharded training step of `config` on `topo`.

    config: a `ModelConfig` (or any object with its size fields; the
    pipeline scheme reads the published `config.json` keys);
    mesh_shape defaults to TP-8/4/2 x FSDP over the remaining chiplets;
    global_batch defaults to 4 sequences per data shard; step_cycles is
    the replayed step's length, split across phases by bytes moved;
    a pipe x node x local mesh needs global_batch and dispatch_bytes,
    the expert dispatch's payload width, and no other mesh takes it.
    """
    mesh_shape = mesh_shape or default_mesh_shape(topo.n)
    with trace("plan.collective", cat="workloads", n=topo.n) as sp:
        scheme, ops = step_ops(config, mesh_shape, seq_len=seq_len,
                               global_batch=global_batch,
                               dtype_bytes=dtype_bytes,
                               dispatch_bytes=dispatch_bytes)
        # phase -> flow matrix + payload bytes, in op order
        flows: dict[str, np.ndarray] = {}
        payload: dict[str, float] = {}
        for op in ops:
            metrics.inc(f"collective.ops.{op.kind}")
            f = op_flow(topo, mesh_shape, op)
            if f.sum() <= 0:    # degenerate axis (groups of 1): skip
                continue
            flows[op.phase] = flows.get(op.phase, 0) + f
            payload[op.phase] = payload.get(op.phase, 0.0) \
                + op.bytes_per_chip
        total = sum(payload.values())
        sp.set(scheme=scheme, ops=len(ops), phases=len(flows), bytes=total)
    if not flows:
        raise ValueError("sharded step issues no collectives on this mesh")

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
