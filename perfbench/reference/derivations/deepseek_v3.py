"""DeepSeek-V3's training step (arXiv:2412.19437 §3.2, §3.4) as the
reference derives it: pipeline stages on the mesh's "pipe" axis, expert
parallelism and ZeRO-1 data parallelism over a stage's "node" x "local"
chiplets, no tensor parallelism; written from the paper and the
published `config.json`, in plain Python and numpy.

Parameters are counted tensor by tensor, as the published checkpoint
names them (`_decoder_tensors`, `_mtp_tensors`).  A stage holds
floor(61 / pipe) layers, the last stage the remainder and the MTP
module; stage 0 the embedding, the last stage the final norm and the
output head.  A stage's chiplets hold its routed experts between them
(no copy), so only the rest, its replicated parameters, is
reduce-scattered and all-gathered.

Each op is one stage's: the chiplets with that "pipe" coordinate send.
Its flow (`op_flow`) is drawn from the chiplets' mesh coordinates:

  next / prev   (node, local) equal, pipe one on / one back: the payload
  dispatch      same stage; to each chiplet of the same `local` in
                another node, payload x topk_group / nodes (one copy a
                chosen group, the groups split evenly over the nodes);
                to each other chiplet of the same node, payload x
                num_experts_per_tok / local (each of a token's experts
                in that node is on a given chiplet with 1 / local odds)
  combine       the dispatch transposed
  ring          same stage; rank node x local + local to the next rank,
                wrapping: payload x (ranks - 1) / ranks

With integer payloads and power-of-two shares every entry is exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..collectives import mesh_coords


@dataclasses.dataclass(frozen=True)
class StepOp:
    """One stage's collective: its phase, its flow's shape, the stage
    whose chiplets send, the payload of each sender, and for a dispatch
    or combine the routing's (topk_group, num_experts_per_tok)."""
    phase: str
    kind: str                   # next | prev | dispatch | combine | ring
    stage: int
    bytes_per_chip: int
    route: tuple = ()


def _decoder_tensors(c, moe: bool) -> dict:
    """Element counts of one decoder layer's tensors by checkpoint name."""
    d, h = c.hidden_size, c.num_attention_heads
    t = {
        "self_attn.q_a_proj": d * c.q_lora_rank,
        "self_attn.q_a_layernorm": c.q_lora_rank,
        "self_attn.q_b_proj": c.q_lora_rank * h
        * (c.qk_nope_head_dim + c.qk_rope_head_dim),
        "self_attn.kv_a_proj_with_mqa": d * (c.kv_lora_rank
                                             + c.qk_rope_head_dim),
        "self_attn.kv_a_layernorm": c.kv_lora_rank,
        "self_attn.kv_b_proj": c.kv_lora_rank * h
        * (c.qk_nope_head_dim + c.v_head_dim),
        "self_attn.o_proj": h * c.v_head_dim * d,
        "input_layernorm": d,
        "post_attention_layernorm": d,
    }
    if moe:
        f = c.moe_intermediate_size
        t["mlp.experts"] = c.n_routed_experts * 3 * d * f
        t["mlp.shared_experts"] = c.n_shared_experts * 3 * d * f
        t["mlp.gate.weight"] = c.n_routed_experts * d
        t["mlp.gate.e_score_correction_bias"] = c.n_routed_experts
    else:
        t["mlp"] = 3 * d * c.intermediate_size
    return t


def _mtp_tensors(c) -> dict:
    """One MTP module (§2.2): the projection of the concatenated normed
    hidden state and embedding, its two norms, an MoE decoder layer and
    its final norm; it shares the main model's embedding and head."""
    d = c.hidden_size
    t = {"enorm": d, "hnorm": d, "eh_proj": 2 * d * d,
         "shared_head.norm": d}
    t.update(_decoder_tensors(c, True))
    return t


def _moe(c, i: int) -> bool:
    return i >= c.first_k_dense_replace and i % c.moe_layer_freq == 0


def parameters(c) -> tuple:
    """(total, activated) parameters of the main model, MTP excluded."""
    d = c.hidden_size
    total = active = 2 * c.vocab_size * d + d       # embed, head, norm
    for i in range(c.num_hidden_layers):
        t = _decoder_tensors(c, _moe(c, i))
        total += sum(t.values())
        routed = t.pop("mlp.experts", 0)
        active += sum(t.values()) \
            + routed * c.num_experts_per_tok // c.n_routed_experts
    return total, active


def _stages(c, pipe: int) -> list:
    """(MoE blocks, replicated parameters) of each stage."""
    per, n = c.num_hidden_layers // pipe, c.num_hidden_layers
    out = []
    for s in range(pipe):
        last = s == pipe - 1
        layers = list(range(s * per, n if last else s * per + per))
        tensors = [_decoder_tensors(c, _moe(c, i)) for i in layers]
        if last:
            tensors += [_mtp_tensors(c)] * c.num_nextn_predict_layers
        blocks = sum("mlp.experts" in t for t in tensors)
        held = sum(v for t in tensors for k, v in t.items()
                   if k != "mlp.experts")
        if s == 0:
            held += c.vocab_size * c.hidden_size    # embed_tokens
        if last:
            held += c.hidden_size + c.vocab_size * c.hidden_size
        out.append((blocks, held))
    return out


def step_collective_ops(config, mesh_shape, *, seq_len, global_batch,
                        dtype_bytes, dispatch_bytes):
    """The step's ops, phase by phase, each stage's in stage order: the
    forward sends, the expert dispatch (FP8: `dispatch_bytes`) and
    combine, their gradients reversed, the backward sends, then ZeRO-1's
    gradient reduce-scatter and parameter all-gather."""
    c = config
    pipe = mesh_shape["pipe"]
    ranks = mesh_shape["node"] * mesh_shape["local"]
    tokens = seq_len * (global_batch // ranks)
    row = tokens * c.hidden_size          # one token row per MoE block
    stages = _stages(c, pipe)
    ops = [StepOp("pp_fwd", "next", s, row * dtype_bytes)
           for s in range(pipe - 1)]
    for phase, kind, width in [("ep_dispatch", "dispatch", dispatch_bytes),
                               ("ep_combine", "combine", dtype_bytes),
                               ("grad_dispatch", "dispatch", dtype_bytes),
                               ("grad_combine", "combine", dtype_bytes)]:
        for s, (blocks, _held) in enumerate(stages):
            ops.append(StepOp(phase, kind, s, blocks * row * width,
                              (c.topk_group, c.num_experts_per_tok)))
    ops += [StepOp("pp_bwd", "prev", s, row * dtype_bytes)
            for s in range(1, pipe)]
    for phase in ("grad_reduce", "param_gather"):
        ops += [StepOp(phase, "ring", s, held * dtype_bytes)
                for s, (_blocks, held) in enumerate(stages)]
    return ops


def op_flow(topo, mesh_shape, op) -> np.ndarray:
    """[N, N] bytes of one op (the module docstring's table)."""
    co = mesh_coords(topo, mesh_shape)
    p, g, loc = co["pipe"], co["node"], co["local"]
    nodes, local = mesh_shape["node"], mesh_shape["local"]
    sender = (p == op.stage)[:, None]
    same_p = p[:, None] == p[None, :]
    same_g = g[:, None] == g[None, :]
    same_l = loc[:, None] == loc[None, :]
    b = op.bytes_per_chip
    f = np.zeros((topo.n, topo.n))
    if op.kind in ("next", "prev"):
        step = 1 if op.kind == "next" else -1
        f[sender & same_g & same_l & (p[None, :] == p[:, None] + step)] = b
    elif op.kind in ("dispatch", "combine"):
        groups, experts = op.route
        f[sender & same_p & same_l & ~same_g] = b * groups / nodes
        f[sender & same_p & same_g & ~same_l] = b * experts / local
        if op.kind == "combine":
            f = np.ascontiguousarray(f.T)
    else:
        k = nodes * local
        r = g * local + loc
        f[sender & same_p & (r[None, :] == (r[:, None] + 1) % k)] = \
            b * (k - 1) / k
    return f
