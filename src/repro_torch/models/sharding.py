"""The collective plan of a sharded training step, without a mesh.

The JAX package's `models/sharding.py` maps logical axes onto a JAX
device mesh (`ParallelCtx`, `to_pspec`, the sharded paths) and, beside
that, derives the ordered collectives a sharded train step issues from
the architecture config alone (`CollectiveOp`, `step_collective_ops`).
This module holds the second part, which the collective workloads
(`workloads/collective.py`) need; it is the same arithmetic and needs
neither jax nor torch.  `ParallelCtx` and the sharded paths come with
the `torch.distributed` slice of the port (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective a sharded train step issues, as traffic demand.

    phase groups ops that overlap in time (the workload engine turns
    each phase into one flow matrix); axis names the mesh axis whose
    groups communicate; bytes_per_chip is the payload each participant
    contributes.
    """
    phase: str                  # fsdp_gather | fwd_tp | moe_a2a | ...
    kind: str                   # all_reduce | all_gather | ...
    axis: str                   # mesh axis ("data" | "model")
    bytes_per_chip: float


def step_collective_ops(config, mesh_shape: dict, seq_len: int = 2048,
                        global_batch: int = 32, dtype_bytes: int = 2,
                        ) -> list[CollectiveOp]:
    """The ordered collectives of one training step under the JAX
    package's sharding rules (tensor axes -> "model", ZeRO-3 weight
    "embed" -> "data"), sized from the architecture config alone: per
    step
      1. all-gather the data-sharded weights        (fsdp_gather, data)
      2. 2 activation all-reduces per layer forward (fwd_tp, model)
      3. MoE token all-to-all, if experts exist     (moe_a2a, model)
      4. 2 activation all-reduces per layer backward (bwd_tp, model)
      5. reduce-scatter the gradients               (grad_reduce, data)
    `config` is duck-typed (any object with ModelConfig's size fields).
    """
    tm = int(mesh_shape.get("model", 1))
    dm = int(mesh_shape.get("data", 1))
    b_local = max(global_batch // max(dm, 1), 1)
    d = config.d_model
    hd = config.head_dim or d // config.n_heads
    attn = d * config.n_heads * hd + 2 * d * config.n_kv_heads * hd \
        + config.n_heads * hd * d
    dense_mlp = 3 * d * config.d_ff
    n_moe = config.n_layers // max(config.moe_every, 1) \
        if config.n_experts else 0
    mlp = (config.n_layers - n_moe) * dense_mlp \
        + n_moe * config.n_experts * dense_mlp
    params_tp = (config.n_layers * attn + mlp + 2 * config.vocab * d) / tm
    act = float(b_local) * seq_len * d * dtype_bytes

    # bytes_per_chip is always the FULL buffer size per participant;
    # ring-schedule (k-1)/k factors are applied downstream by
    # `collectives.collective_flow`, matching IciModel.collective_time_s
    ops: list[CollectiveOp] = []
    params_bytes = params_tp * dtype_bytes
    if dm > 1:
        ops.append(CollectiveOp("fsdp_gather", "all_gather", "data",
                                params_bytes))
    if tm > 1:
        ops.append(CollectiveOp("fwd_tp", "all_reduce", "model",
                                2 * config.n_layers * act))
        if n_moe:
            ops.append(CollectiveOp("moe_a2a", "all_to_all", "model",
                                    n_moe * act * max(config.top_k, 1)))
        ops.append(CollectiveOp("bwd_tp", "all_reduce", "model",
                                2 * config.n_layers * act))
    if dm > 1:
        ops.append(CollectiveOp("grad_reduce", "reduce_scatter", "data",
                                params_bytes))
    if not ops:   # unsharded mesh: the step still syncs grads pairwise
        ops.append(CollectiveOp("grad_reduce", "all_reduce", "data",
                                params_bytes))
    return ops
