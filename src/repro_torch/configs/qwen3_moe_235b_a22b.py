"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936, MoE 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B family; hf]"""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
    n_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
    attn_kind="gqa", qk_norm=True, rope_theta=1e6,
    n_experts=128, top_k=8, moe_every=1, capacity_factor=1.25)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=64, vocab=512, attn_kind="gqa",
    qk_norm=True, n_experts=8, top_k=2, moe_every=1)
