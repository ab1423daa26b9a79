"""Mamba2 SSD chunked scan: the hand-written Hopper kernel, its wrapper
and its plain versions."""
from .ops import ssd_scan  # noqa: F401
from .ref import ssd_chunked_core, ssd_naive, ssd_ref  # noqa: F401
