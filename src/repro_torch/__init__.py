"""repro_torch — the PyTorch/CUDA port of `repro`, slice by slice.

This slice carries the paper's static evaluation path: topology
generators -> up*/down* routing -> `SimSpec` -> padded batch -> the
batched cycle simulator (`core.simulator.run_batch`) -> saturation
throughput and latency, with the per-cycle switch allocator `netstep`
as a hand-written CUDA kernel for Hopper (`kernels/netstep`).

The package imports torch, numpy and scipy only — never jax, and
nothing of `repro`; it keeps its own copies of the host-side modules it
needs.  Entry points run on the CUDA card unless the caller passes
`device="cpu"` (`device.resolve_device`).
"""
from .device import resolve_device  # noqa: F401
