"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early-fusion: VQ image tokens share the text vocabulary, so
the modality frontend is the tokenizer itself (stub — input_specs()
supplies token ids that may be image codes).  qk-norm per the paper.
[arXiv:2405.09818; unverified]"""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", n_layers=48, d_model=8192, n_heads=64,
    n_kv_heads=8, head_dim=128, d_ff=22016, vocab=65536,
    attn_kind="gqa", qk_norm=True, rope_theta=1e4)

SMOKE = ModelConfig(
    name="chameleon-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, attn_kind="gqa",
    qk_norm=True)
