"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  Experts are split into 2 virtual
half-d_ff experts so the 8-expert dimension tiles the 16-way model mesh
axis (see models/layers.moe_ep_local).  [hf:xai-org/grok-1; unverified]"""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, head_dim=128, d_ff=32768, vocab=131072,
    attn_kind="gqa", rope_theta=1e4,
    n_experts=8, top_k=2, moe_every=1, moe_virtual_split=2)

SMOKE = ModelConfig(
    name="grok-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=64, vocab=512, attn_kind="gqa",
    n_experts=4, top_k=2, moe_every=1, moe_virtual_split=2)
