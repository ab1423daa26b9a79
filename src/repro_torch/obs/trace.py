"""Lightweight span tracing (DESIGN.md §13): `with trace("name"): ...`.

The port's own copy of `repro.obs.trace` (standard library only).

A span is one timed region of host-side work — planning, bucketing,
compilation, device execution.  Spans are recorded in-process by a
thread-safe collector and exported as Chrome-trace/Perfetto JSON
(`save_chrome_trace`), the format `chrome://tracing`, Perfetto UI and
`speedscope` all read.

Design constraints, in order:

  * **off is free**: tracing is disabled by default and a disabled
    `trace(...)` does no clock reads, no allocation beyond a shared
    no-op span, and takes no lock — it is safe to leave on hot paths;
  * **timing is honest**: `perf_counter_ns` (monotonic), duration is
    measured around the `with` body only, and nothing here ever
    synchronizes a device — callers that want dispatch/wait splits
    synchronize themselves in a second span;
  * **thread-safe**: spans carry the recording thread's id and the
    collector appends under a lock, so worker threads can trace freely.

Spans nest lexically ("X" phase events; the viewer reconstructs the
stack per thread from the timestamps).  Attributes are free-form
key/values: pass them at open (`trace("run", shape=str(s))`) or attach
mid-span (`with trace("run") as sp: sp.set(cold=True)`).
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    """One recorded region; `ts`/`dur` are perf_counter nanoseconds."""
    name: str
    cat: str = ""
    ts: int = 0
    dur: int = 0
    tid: int = 0
    args: dict = field(default_factory=dict)

    def set(self, **attrs) -> "Span":
        """Attach attributes to a live (or finished) span."""
        self.args.update(attrs)
        return self


class _SpanCM:
    """Context manager recording one span into a tracer."""
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._span.ts = time.perf_counter_ns()
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        sp = self._span
        sp.dur = time.perf_counter_ns() - sp.ts
        if exc_type is not None:
            sp.args.setdefault("error", exc_type.__name__)
        self._tracer._record(sp)


class _NullCM:
    """Shared no-op for disabled tracers: no clock, no lock, no append."""
    __slots__ = ()
    _SPAN = Span(name="")         # .set() works but goes nowhere visible

    def __enter__(self) -> Span:
        return self._SPAN

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NULL = _NullCM()


class Tracer:
    """Thread-safe span collector; one process-wide instance below."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: list[Span] = []
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
            self._spans = []

    # ---- recording -----------------------------------------------------
    def trace(self, name: str, cat: str = "", **attrs):
        if not self._enabled:
            return _NULL
        return _SpanCM(self, Span(name=name, cat=cat,
                                  tid=threading.get_ident(), args=attrs))

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    # ---- export --------------------------------------------------------
    def chrome_events(self) -> list[dict]:
        """Complete ("X") events, microsecond timestamps, one per span.

        Sorted by start time: spans are *recorded* at close (children
        before parents), but trace viewers reconstruct per-thread nesting
        from event order and timestamps, so parents must come first for
        correct nested-span attribution."""
        pid = os.getpid()
        return sorted(
            (dict(name=s.name, cat=s.cat or "repro", ph="X",
                  ts=s.ts / 1e3, dur=s.dur / 1e3, pid=pid, tid=s.tid,
                  args={k: _jsonable(v) for k, v in s.args.items()})
             for s in self.spans()),
            key=lambda e: (e["tid"], e["ts"], -e["dur"]))

    def save_chrome_trace(self, path: str, metadata: dict | None = None
                          ) -> int:
        """Write the Chrome-trace JSON document; returns #events."""
        events = self.chrome_events()
        doc = dict(traceEvents=events, displayTimeUnit="ms",
                   metadata=metadata or {})
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"[obs] wrote {path} ({len(events)} spans)")
        return len(events)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def span_summary(spans) -> dict[str, dict]:
    """Aggregate a span list by name: {name: {count, total_s, max_s}}.

    The compact per-phase rollup the benchmark harness embeds in BENCH
    JSON (DESIGN.md §16) — how many times each phase ran and where the
    wall-clock went, without shipping the full trace."""
    out: dict[str, dict] = {}
    for s in spans:
        agg = out.setdefault(s.name, dict(count=0, total_s=0.0, max_s=0.0))
        agg["count"] += 1
        dur = s.dur / 1e9
        agg["total_s"] += dur
        agg["max_s"] = max(agg["max_s"], dur)
    for agg in out.values():
        agg["total_s"] = round(agg["total_s"], 6)
        agg["max_s"] = round(agg["max_s"], 6)
    return out


# ---------------------------------------------------------------------
# process-wide default tracer + module-level convenience API
# ---------------------------------------------------------------------

TRACER = Tracer()


def trace(name: str, cat: str = "", **attrs):
    """`with trace("phase", key=val) as sp:` — record one span."""
    return TRACER.trace(name, cat, **attrs)


def enable_tracing() -> None:
    TRACER.enable()


def disable_tracing() -> None:
    TRACER.disable()


def tracing_enabled() -> bool:
    return TRACER.enabled


def clear_trace() -> None:
    TRACER.clear()


def get_spans() -> list[Span]:
    return TRACER.spans()


def save_chrome_trace(path: str, metadata: dict | None = None) -> int:
    return TRACER.save_chrome_trace(path, metadata)
