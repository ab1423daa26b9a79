"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448;
MLA (multi-head latent attention): q_lora=768, kv_lora=256,
nope/rope head dims 64/32.  [hf:openbmb/MiniCPM3-4B; hf]"""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
    n_kv_heads=40, head_dim=64, d_ff=6400, vocab=73448,
    attn_kind="mla", q_lora_rank=768, kv_lora_rank=256,
    mla_nope_dim=64, mla_rope_dim=32, rope_theta=1e4)

SMOKE = ModelConfig(
    name="minicpm3-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
    attn_kind="mla", q_lora_rank=32, kv_lora_rank=16,
    mla_nope_dim=16, mla_rope_dim=8)
