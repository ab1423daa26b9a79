"""Optimizers and LR schedules (AdamW + warmup-cosine) for the training
stack."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa
                    clip_by_global_norm)
from .schedule import warmup_cosine  # noqa
