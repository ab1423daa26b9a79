"""Opt-in observability (DESIGN.md §13, §16): the port's `repro_torch.obs`.

Two halves, both off by default and inert when off:

  * **host-side**: `trace(...)` spans (Chrome-trace/Perfetto JSON via
    `save_chrome_trace`) and a process-wide `metrics` registry
    (counters, events, JSONL log) that also absorbs the routing cache
    hit/miss/eviction counters;
  * **in-sim**: the flight recorder — `SimConfig(telemetry=True)` makes
    the batched simulator carry per-link / per-node counters through the
    cycle loop, `SimConfig(telemetry_windows=W)` bins them over time;
    `obs.flight` turns them into tidy per-link and per-window rows and
    `obs.report` into link-load heatmap / summary CSVs.

The performance half: per-runner-key profiles of the simulator's
batches (`obs.profile`: bytes, peak device memory, device launches per
cycle) and the structured benchmark document with its regression gate
(`obs.bench`, `python -m repro_torch.obs.bench compare OLD NEW`).
"""
from .trace import (Span, clear_trace, disable_tracing, enable_tracing,  # noqa
                    get_spans, save_chrome_trace, span_summary, trace,
                    tracing_enabled)
from .metrics import (MetricsRegistry, cache_counters, metrics)  # noqa
from .flight import link_rows, window_rows, LINK_COLUMNS, WINDOW_COLUMNS  # noqa
from .report import (gini, link_load_summary, window_summary,  # noqa
                     write_link_reports, write_window_reports)
from .profile import (ProfileRegistry, clear_profiles, disable_profiling,  # noqa
                      enable_profiling, get_profiles, profiling_enabled)
from .bench import (BENCH_SCHEMA_VERSION, bench_doc, compare,  # noqa
                    load_bench, write_bench)
