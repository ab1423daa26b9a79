"""Forward flash attention: the hand-written Hopper kernel, its GQA
wrapper and its plain version."""
from .ops import flash_attention, flash_attention_plain  # noqa: F401
from .ref import attention_ref  # noqa: F401
