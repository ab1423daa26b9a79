"""seamless-m4t-medium [audio] — enc-dec transformer backbone:
12L encoder + 12L decoder, d_model=1024 16H d_ff=4096 vocab=256206.
The speech frontend is a STUB: input_specs() supplies precomputed frame
embeddings [B, T, d_model].  [arXiv:2308.11596; hf]"""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", n_layers=12, n_enc_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096,
    vocab=256206, attn_kind="gqa", arch_kind="encdec",
    frontend="audio_frames", rope_theta=1e4)

SMOKE = ModelConfig(
    name="seamless-smoke", n_layers=2, n_enc_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
    attn_kind="gqa", arch_kind="encdec", frontend="audio_frames")
