"""mamba2-1.3b [ssm] — 48L d_model=2048 attention-free, vocab=50280,
ssm_state=128; SSD (state-space duality) chunked form.
[arXiv:2405.21060; unverified]"""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", n_layers=48, d_model=2048, n_heads=1,
    n_kv_heads=1, head_dim=64, d_ff=0, vocab=50280,
    attn_kind="none", ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=256)

SMOKE = ModelConfig(
    name="mamba2-smoke", n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
    head_dim=16, d_ff=0, vocab=512, attn_kind="none", ssm_state=16,
    ssm_expand=2, ssm_head_dim=16, ssm_chunk=8)
