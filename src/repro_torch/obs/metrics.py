"""Unified metrics registry (DESIGN.md §13): counters, events, JSONL.

The port's copy of `repro.obs.metrics` (standard library only).  One
process-wide `metrics` instance gathers the host-side numbers: sweep
engine run stats, executor chunk outcomes.  Three primitives:

  * `inc(name, n)` — monotonic counters (thread-safe);
  * `observe(name, value)` — running count/sum/min/max of a value
    (wall-clock seconds, batch sizes, ...);
  * `event(name, **fields)` — an append-only structured log entry,
    wall-clock stamped, optionally mirrored to a JSONL sink file
    (`set_sink`), so failures and skips are never silent.

`snapshot()` additionally absorbs the routing cache's counters
(`routing.routing_cache_info()`) under `cache.routing.*` keys, and
`cache_counters()` exposes those monotonic hit/miss/eviction counters
for before/after deltas.

The port has no compiled-runner cache: the simulator's cycle loop
captures its CUDA graphs anew each run and keeps none, so nothing is
compiled or cached per padded shape (`sim.graph_captures` and
`sim.graph_replays` count the graphs and their launches).  The
`cache.runner.*` keys stay, so readers of the reference's keys keep
working, and always read 0 — hence `SweepEngine.stats["compiles"]` and
the executor's `compiled` progress field are 0 in the port.
"""
from __future__ import annotations

import json
import os
import threading
import time


class MetricsRegistry:
    """Thread-safe counters + observations + structured event log."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._observations: dict[str, dict] = {}
        self._events: list[dict] = []
        self._sink: str | None = None
        self._buffered = False
        self._pending: list[str] = []

    # ---- counters ------------------------------------------------------
    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._counters.get(name, default)

    # ---- observations --------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        with self._lock:
            o = self._observations.get(name)
            if o is None:
                o = self._observations[name] = dict(
                    count=0, sum=0.0, min=value, max=value)
            o["count"] += 1
            o["sum"] += value
            o["min"] = min(o["min"], value)
            o["max"] = max(o["max"], value)

    # ---- events --------------------------------------------------------
    def set_sink(self, path: str | None, *, buffered: bool = False
                 ) -> None:
        """Mirror every subsequent event to `path` as one JSON line.

        buffered=True holds lines in memory until `flush()` /
        `close_sink()` — one write syscall per flush instead of per
        event, and nothing hits disk for a sink that is reset before
        flushing.  Switching sinks flushes the old one first so no
        buffered event is ever silently dropped.
        """
        if path is not None:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
        self.flush()
        with self._lock:
            self._sink = path
            self._buffered = buffered

    def event(self, name: str, **fields) -> dict:
        e = dict(event=name, t=time.time(), **fields)
        line = None
        with self._lock:
            self._events.append(e)
            sink = self._sink
            if sink is not None:
                line = json.dumps(e, default=str)
                if getattr(self, "_buffered", False):
                    self._pending.append(line)
                    line = None
        if line is not None:
            with open(sink, "a") as f:
                f.write(line + "\n")
        return e

    def flush(self) -> int:
        """Write buffered event lines to the sink; returns #flushed."""
        with self._lock:
            sink, pending = self._sink, self._pending
            self._pending = []
        if sink is None or not pending:
            return 0
        with open(sink, "a") as f:
            f.write("\n".join(pending) + "\n")
        return len(pending)

    def close_sink(self) -> None:
        """Flush any buffered lines, then detach the sink."""
        self.flush()
        with self._lock:
            self._sink = None
            self._buffered = False

    def events(self, name: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if name is None else [e for e in evs
                                         if e["event"] == name]

    def save_jsonl(self, path: str) -> int:
        """Write the full event log (one JSON object per line)."""
        evs = self.events()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for e in evs:
                f.write(json.dumps(e, default=str) + "\n")
        print(f"[obs] wrote {path} ({len(evs)} events)")
        return len(evs)

    # ---- snapshots -----------------------------------------------------
    def snapshot(self) -> dict:
        """Counters + observations + absorbed cache counters."""
        with self._lock:
            out = dict(self._counters)
            out.update({k: dict(v) for k, v in self._observations.items()})
        out.update(cache_counters())
        return out

    def with_prefix(self, prefix: str) -> dict:
        """Counter/observation snapshot filtered to one namespace
        (e.g. "analysis." for the static-verifier counters) — cheap to
        assert on in tests without wading through cache counters."""
        return {k: v for k, v in self.snapshot().items()
                if k.startswith(prefix)}

    def reset(self) -> None:
        """Return the registry to a pristine state: counters,
        observations and events cleared AND the sink detached (buffered
        lines flushed first).  A test or engine that `reset()`s can no
        longer leak events into a sink file another run attached —
        snapshot isolation between runs in one process."""
        self.close_sink()
        with self._lock:
            self._counters.clear()
            self._observations.clear()
            self._events.clear()


def cache_counters() -> dict:
    """Monotonic hit/miss/eviction counters under stable keys.  Misses
    count cache *builds* (routed structures), so a before/after miss
    delta counts new work exactly.  `cache.runner.*` are 0: the port
    compiles no runner per shape (see the module docstring)."""
    from ..core.routing import routing_cache_info
    t = routing_cache_info()
    return {
        "cache.runner.hits": 0,
        "cache.runner.misses": 0,
        "cache.runner.evictions": 0,
        "cache.runner.size": 0,
        "cache.routing.hits": t["hits"],
        "cache.routing.misses": t["misses"],
        "cache.routing.evictions": t["evictions"],
        "cache.routing.size": t["size"],
    }


#: process-wide registry (`from repro_torch.obs.metrics import metrics`)
metrics = MetricsRegistry()
