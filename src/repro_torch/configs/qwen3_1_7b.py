"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936; qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=8, head_dim=128, d_ff=6144, vocab=151936,
    attn_kind="gqa", qk_norm=True, rope_theta=1e6)

SMOKE = ModelConfig(
    name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, attn_kind="gqa", qk_norm=True)
