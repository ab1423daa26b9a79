"""repro_torch — the PyTorch/CUDA port of `repro`, slice by slice.

Two paths are ported so far:

- the paper's static evaluation path: topology generators -> up*/down*
  routing -> `SimSpec` -> padded batch -> the batched cycle simulator
  (`core.simulator.run_batch`) -> saturation throughput and latency,
  with the per-cycle switch allocator `netstep` as a hand-written CUDA
  kernel for Hopper (`kernels/netstep`);
- the LM serving path of the framework bridge: `models` (GQA and
  Mamba2 decoders), `configs` (qwen3-1.7b, mamba2-1.3b) and
  `launch.serve`, whose prefill runs the hand-written Hopper kernels
  `kernels/flash_attention` and `kernels/ssd_scan`.

The package imports torch, numpy and scipy only — never jax, and
nothing of `repro`; it keeps its own copies of the host-side modules it
needs.  Entry points run on the CUDA card unless the caller passes
`device="cpu"` (`device.resolve_device`).
"""
from .device import resolve_device  # noqa: F401
