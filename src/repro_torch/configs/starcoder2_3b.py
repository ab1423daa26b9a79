"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152; GQA + RoPE. [arXiv:2402.19173; hf]"""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24,
    n_kv_heads=2, head_dim=128, d_ff=12288, vocab=49152,
    attn_kind="gqa", rope_theta=999999.0)

SMOKE = ModelConfig(
    name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, attn_kind="gqa")
