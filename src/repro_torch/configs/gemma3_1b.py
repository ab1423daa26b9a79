"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144; 5 local : 1 global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", n_layers=26, d_model=1152, n_heads=4,
    n_kv_heads=1, head_dim=256, d_ff=6912, vocab=262144,
    attn_kind="gqa", qk_norm=True, rope_theta=1e6,
    window=1024, global_every=6)

SMOKE = ModelConfig(
    name="gemma3-smoke", n_layers=6, d_model=64, n_heads=2, n_kv_heads=1,
    head_dim=32, d_ff=128, vocab=512, attn_kind="gqa", qk_norm=True,
    window=8, global_every=3)
