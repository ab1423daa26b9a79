"""The collectives of a pipeline x expert x ZeRO-1 training step.

DeepSeek-V3's layout (arXiv:2412.19437 §3.2, §3.4), sized from the
model's published `config.json` keys (MLA's `q_lora_rank`,
`kv_lora_rank`, `qk_nope_head_dim`, `qk_rope_head_dim`, `v_head_dim`;
`first_k_dense_replace`, `moe_layer_freq`, `n_routed_experts`,
`n_shared_experts`, `moe_intermediate_size`, `num_experts_per_tok`,
`n_group`, `topk_group`, `num_nextn_predict_layers`).

The mesh {"pipe": P, "node": G, "local": L} has P pipeline stages of
G x L chiplets; a stage's G x L chiplets are its data ranks (ZeRO-1)
and its expert ranks at once, in G nodes of L chiplets.  No tensor
parallelism.

  * Stages: floor(layers / P) layers each; the last takes the rest and
    the MTP modules.  Stage 0 holds the embedding, the last the output
    head and the final norm.
  * A stage's routed experts are spread over its G x L chiplets; every
    other parameter of the stage (MLA, norms, dense MLPs, shared
    experts, the router) is replicated there and kept ZeRO-1 over them.
  * A data rank runs global_batch / (G L) sequences of seq_len tokens:
    T tokens.

Per step, each op's bytes per sending chiplet, d = hidden_size, M(s) the
MoE blocks of stage s (the MTP modules' included), R(s) its replicated
parameters:

  pp_fwd         send_next on "pipe", stage s < P - 1:  T d dtype_bytes
  ep_dispatch    dispatch on (node, local):        M(s) T d dispatch_bytes
  ep_combine     combine on (node, local):         M(s) T d dtype_bytes
  grad_dispatch  dispatch on (node, local):        M(s) T d dtype_bytes
  grad_combine   combine on (node, local):         M(s) T d dtype_bytes
  pp_bwd         send_prev on "pipe", stage s > 0:      T d dtype_bytes
  grad_reduce    reduce_scatter on (node, local):  R(s) dtype_bytes
  param_gather   all_gather on (node, local):      R(s) dtype_bytes

The backward pass's gradients take the forward's shapes reversed: the
combine's gradient goes out as a dispatch, the dispatch's comes back as
a combine.  The dispatch is the expected flow under uniform routing over
the chosen groups: a token reaches topk_group of n_group groups, each on
one node, first through the chiplet of its own `local` index there, then
num_experts_per_tok / topk_group experts in each, n_routed_experts /
(G L) experts a chiplet.  Of a chiplet's payload,

  inter = topk_group / G            goes to each other node's chiplet,
  intra = num_experts_per_tok / L   to each other chiplet of its node

(a node handles topk_group / G copies from each of its G peers of one
`local` index, topk_group in all, and forwards each to the chiplets of
its num_experts_per_tok / topk_group experts: 1 / L of them to each
chiplet; a copy per chosen group and per expert, none merged).  Every
share is a power of two at the published sizes (1/2 and 1 at G = L = 8),
and every byte count a Python integer, so the flows are exact.
"""
from __future__ import annotations

import dataclasses

from .sharding import CollectiveOp

PIPE, NODE, LOCAL = "pipe", "node", "local"
#: the mesh's axes, major first; a stage is one coordinate of PIPE
AXES = (PIPE, NODE, LOCAL)
#: the axes of a stage's data and expert ranks
STAGE_AXES = (NODE, LOCAL)


def is_pipeline_mesh(mesh_shape: dict) -> bool:
    """Whether a mesh is this scheme's: exactly the axes of AXES."""
    return set(mesh_shape) == set(AXES)


@dataclasses.dataclass(frozen=True)
class StageOp(CollectiveOp):
    """A collective of one pipeline stage: `stage` is the coordinate on
    PIPE of the chiplets that send, `axis` may be a tuple of axes, and
    `shares` are a dispatch's or combine's (inter, intra)
    (`core.collectives.collective_flow`)."""
    stage: int
    shares: tuple = ()


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: its main-model layers, its MoE blocks (the
    MTP modules' included) and its replicated parameters."""
    layers: range
    moe_blocks: int
    replicated: int


def _is_moe(c, layer: int) -> bool:
    return layer >= c.first_k_dense_replace and layer % c.moe_layer_freq == 0


def _attention(c) -> int:
    """MLA's parameters, its two latent norms included."""
    d, h = c.hidden_size, c.num_attention_heads
    qk = c.qk_nope_head_dim + c.qk_rope_head_dim
    q = d * c.q_lora_rank + c.q_lora_rank + c.q_lora_rank * h * qk
    kv = (d * (c.kv_lora_rank + c.qk_rope_head_dim) + c.kv_lora_rank
          + c.kv_lora_rank * h * (c.qk_nope_head_dim + c.v_head_dim))
    return q + kv + h * c.v_head_dim * d


def _layer(c, moe: bool) -> tuple:
    """(replicated, routed) parameters of one decoder layer: attention,
    two norms and a dense MLP, or shared experts and the router (its
    weight and its bias) beside the routed experts."""
    d = c.hidden_size
    base = _attention(c) + 2 * d
    if not moe:
        return base + 3 * d * c.intermediate_size, 0
    expert = 3 * d * c.moe_intermediate_size
    return (base + c.n_shared_experts * expert + c.n_routed_experts * d
            + c.n_routed_experts, c.n_routed_experts * expert)


def stages(config, pipe: int) -> list:
    """The P stages of the model: floor(layers / P) layers each, the
    rest and the MTP modules on the last."""
    c = config
    d, n = c.hidden_size, c.num_hidden_layers
    per = n // pipe
    if per < 1:
        raise ValueError(f"{n} layers cannot fill {pipe} pipeline stages")
    # an MTP module: its projection of [h; emb], two norms, an MoE
    # decoder layer and its final norm (embedding and head are shared)
    mtp = 2 * d * d + 2 * d + _layer(c, True)[0] + d
    out = []
    for s in range(pipe):
        layers = range(s * per, n if s == pipe - 1 else (s + 1) * per)
        moe = sum(_is_moe(c, i) for i in layers)
        rep = sum(_layer(c, _is_moe(c, i))[0] for i in layers)
        if s == 0:
            rep += c.vocab_size * d
        if s == pipe - 1:
            k = c.num_nextn_predict_layers
            rep += d + k * mtp + c.vocab_size * d   # norm, MTP, head
            moe += k
        out.append(Stage(layers, moe, rep))
    return out


def step_collective_ops(config, mesh_shape: dict, *, seq_len: int,
                        global_batch: int, dtype_bytes: int,
                        dispatch_bytes: int) -> list:
    """The ordered collectives of one training step (module docstring),
    phase by phase and stage by stage within a phase."""
    c = config
    pipe, nodes, local = (int(mesh_shape[a]) for a in AXES)
    ranks = nodes * local
    if global_batch % ranks:
        raise ValueError(f"global_batch {global_batch} does not split over "
                         f"{ranks} data ranks")
    tokens = global_batch // ranks * seq_len
    d = c.hidden_size
    act = tokens * d * dtype_bytes
    shares = (c.topk_group / nodes, c.num_experts_per_tok / local)
    layout = stages(c, pipe)
    ops = [StageOp("pp_fwd", "send_next", PIPE, act, stage=s)
           for s in range(pipe - 1)]
    for phase, kind, width in (("ep_dispatch", "dispatch", dispatch_bytes),
                               ("ep_combine", "combine", dtype_bytes),
                               ("grad_dispatch", "dispatch", dtype_bytes),
                               ("grad_combine", "combine", dtype_bytes)):
        ops += [StageOp(phase, kind, STAGE_AXES,
                             st.moe_blocks * tokens * d * width, stage=s,
                             shares=shares)
                for s, st in enumerate(layout) if st.moe_blocks]
    ops += [StageOp("pp_bwd", "send_prev", PIPE, act, stage=s)
            for s in range(1, pipe)]
    for phase, kind in (("grad_reduce", "reduce_scatter"),
                        ("param_gather", "all_gather")):
        ops += [StageOp(phase, kind, STAGE_AXES,
                             st.replicated * dtype_bytes, stage=s)
                for s, st in enumerate(layout)]
    return ops
