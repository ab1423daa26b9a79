"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 every other layer, Mamba:attention 7:1
(one attention layer per 8-layer block).  The Mamba blocks use the SSD
(mamba2) chunked form — the TPU-friendly adaptation (DESIGN.md §4).
[arXiv:2403.19887; hf]"""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=14336, vocab=65536,
    attn_kind="gqa", rope_theta=1e4,
    n_experts=16, top_k=2, moe_every=2, attn_every=8,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64)

SMOKE = ModelConfig(
    name="jamba-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, attn_kind="gqa",
    n_experts=4, top_k=2, moe_every=2, attn_every=4,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=8)
