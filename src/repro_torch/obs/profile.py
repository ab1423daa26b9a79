"""Runner profiling for the batched simulator (DESIGN.md §16).

The port's analogue of `repro.obs.profile`.  `run_batch` records one
profile per runner key — padded shape (n, p, c, d) + SimConfig + alloc
impl + kmax + device type, the reference's cache key — so the profile
answers "what does this PadShape cost to run", the denominator the
pad-waste investigation divides live work by.

The reference asks XLA for a compiled executable's analytic cost and
buffer breakdown.  The port compiles no program, so it counts what the
card can answer, from a short pass of the key's own batch
(`PROFILE_CYCLES` cycles, every one measured):

  * `argument_bytes`, `state_bytes`, `output_bytes` — the uploaded
    batch (phase tables for the key's full cycle count included), the
    simulator state carried across cycles and the raw counters returned,
    counted from the tensors;
  * `peak_device_bytes` — `torch.cuda.max_memory_allocated` over the
    pass, above what was allocated before it (the state and the
    per-cycle working set do not grow with the cycle count);
  * `device_launches_per_cycle`, `device_busy_s`, `device_idle_share`
    — `torch.profiler` over a second pass, recording device activity
    only (the host ops of hundreds of launches per cycle would multiply
    the events its trace parse walks): device operations (kernels,
    copies, fills) of the upload and the cycle loop per simulated cycle,
    and the share of the pass's wall time the card sat idle.

Fields with no torch analogue record None: XLA's `flops`,
`bytes_accessed`, `transcendentals`, `temp_bytes`,
`generated_code_bytes` and `compile_s`; on the CPU the device fields too.

Design constraints, as in the reference:

  * **off is free**: profiling is disabled by default and the hot-path
    check is one attribute read;
  * **never in timed regions**: `run_batch` captures before its timed
    dispatch span, in passes of its own, once per key;
  * **robust to gaps**: the profiler on the card sometimes records no
    device event in a session; a capture retries a few sessions and
    records None rather than raising mid-experiment.
"""
from __future__ import annotations

import threading
import time

__all__ = [
    "ProfileRegistry", "PROFILER", "PROFILE_CYCLES", "profiling_enabled",
    "enable_profiling", "disable_profiling", "clear_profiles",
    "get_profiles", "record_runner_profile",
]

#: simulated cycles of a capture's passes
PROFILE_CYCLES = 20
#: profiler sessions tried before the device fields record None
_SESSIONS = 3

#: reference fields the port cannot answer (it compiles no program)
_XLA_ONLY = ("compile_s", "flops", "bytes_accessed", "transcendentals",
             "temp_bytes", "generated_code_bytes")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "element_size"))


def _arg_tensors(args) -> list:
    """The tensors of `_simulate_rows`'s (leaves, srow, rate, sched)."""
    lv, srow, rate, sched = args
    out = list(lv.values()) + [srow, rate]
    if sched is not None:
        out += [v for v in sched.values() if hasattr(v, "element_size")]
    return out


def _device_us(event) -> float:
    """Self device time (us) of a profiler row, across torch versions."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _launches(torch, run, cfg, dev) -> dict:
    """torch.profiler over one pass: device ops per cycle, busy s and
    idle share; None where no session recorded a device event."""
    from torch.profiler import ProfilerActivity, profile
    busy, rows, wall = 0.0, [], None
    for _ in range(_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(cfg)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and _device_us(e) > 0]
        busy = sum(_device_us(e) for e in rows) / 1e6
        if busy > 0:
            break
    seen = busy > 0
    return dict(
        device_launches_per_cycle=sum(e.count for e in rows) / cfg.cycles
        if seen else None,
        device_busy_s=busy if seen else None,
        device_idle_share=1 - busy / wall if seen else None)


class ProfileRegistry:
    """Thread-safe once-per-key profile store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._profiles: dict = {}
        self._enabled = False

    # ---- lifecycle -----------------------------------------------------
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def clear(self) -> None:
        with self._lock:
            self._profiles = {}

    # ---- capture -------------------------------------------------------
    def capture(self, key: tuple, run, cfg, device) -> dict:
        """Profile one runner key, once (cached thereafter).

        `run(cfg, probe)` simulates the key's batch under `cfg`, fills
        `probe["state_bytes"]`, and returns (raw counters, device
        arguments).  Two passes of `PROFILE_CYCLES` cycles run here —
        call this outside any timed region.
        """
        import torch
        with self._lock:
            prof = self._profiles.get(key)
        if prof is not None:
            return prof
        dev = torch.device(device)
        cuda = dev.type == "cuda"
        cycles = min(cfg.cycles, PROFILE_CYCLES)
        pcfg = cfg._replace(cycles=cycles, warmup=0, telemetry_windows=min(
            cfg.telemetry_windows, cycles))
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        probe: dict = {}
        raw, args = run(pcfg, probe)
        peak = None
        if cuda:
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - base
        prof = dict(key=[_jsonable(k) for k in key], device=str(dev),
                    profile_cycles=cycles,
                    **dict.fromkeys(_XLA_ONLY),
                    argument_bytes=_nbytes(_arg_tensors(args)),
                    state_bytes=probe.get("state_bytes"),
                    output_bytes=_nbytes(raw),
                    peak_device_bytes=peak)
        del raw, args
        if cuda:
            prof.update(_launches(torch, lambda c: run(c, None), pcfg, dev))
        else:
            prof.update(device_launches_per_cycle=None, device_busy_s=None,
                        device_idle_share=None)
        prof["capture_s"] = round(time.perf_counter() - t0, 4)
        with self._lock:
            self._profiles.setdefault(key, prof)
        return prof

    def profiles(self) -> list[dict]:
        """All captured profiles (insertion order)."""
        with self._lock:
            return list(self._profiles.values())


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# ---------------------------------------------------------------------
# process-wide default registry + module-level convenience API
# ---------------------------------------------------------------------

PROFILER = ProfileRegistry()


def profiling_enabled() -> bool:
    return PROFILER.enabled


def enable_profiling() -> None:
    PROFILER.enable()


def disable_profiling() -> None:
    PROFILER.disable()


def clear_profiles() -> None:
    PROFILER.clear()


def get_profiles() -> list[dict]:
    return PROFILER.profiles()


def record_runner_profile(shape, cfg, alloc_impl: str, kmax: int, device,
                          run) -> dict:
    """Profile a batched run under its runner key.

    Called by `run_batch` when profiling is enabled; the key mirrors the
    reference's `get_batch_runner` key, with the device type in place of
    the JAX backend, so there is one profile per padded shape and config
    however many topologies share it.
    """
    import torch
    key = (shape.n, shape.p, shape.c, shape.d, cfg, alloc_impl, kmax,
           torch.device(device).type)
    return PROFILER.capture(key, run, cfg, device)
