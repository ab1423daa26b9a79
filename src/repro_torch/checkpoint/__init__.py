"""Checkpoint save/restore with async host offload for the training stack."""
from .checkpoint import (save_checkpoint, restore_checkpoint,  # noqa
                         latest_step, AsyncCheckpointer, is_writer)
