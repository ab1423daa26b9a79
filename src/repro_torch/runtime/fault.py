"""Fault-tolerance primitives for the training loop.

At 1000+-node scale the failure model is: slow devices (stragglers),
dead hosts (checkpoint/restart), and transient IO/build errors (retry).
Data-parallel training is bulk-synchronous, so straggler *mitigation* is
detection + replacement (the watchdog flags the condition for the
cluster layer; within a step it cannot be hidden), while *recovery* is
checkpoint/restart (`repro_torch.checkpoint`).  Pure Python: the same
primitives as the JAX package's `runtime.fault`, in a copy of the port's
own.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque


def retry(fn, *, retries: int = 3, backoff_s: float = 0.5,
          on=(RuntimeError, OSError)):
    """Retry transient failures with exponential backoff."""
    def wrapped(*a, **kw):
        delay = backoff_s
        for attempt in range(retries + 1):
            try:
                return fn(*a, **kw)
            except on:
                if attempt == retries:
                    raise
                time.sleep(delay)
                delay *= 2
        raise AssertionError("unreachable")
    return wrapped


class StepWatchdog:
    """Track step times; flag stragglers (step > factor x rolling median).

    On a real cluster the flag feeds the controller that cordons the slow
    host and triggers an elastic restart; here it is surfaced in metrics
    and the log.
    """

    def __init__(self, window: int = 32, factor: float = 2.5):
        self.times = deque(maxlen=window)
        self.factor = factor
        self.flagged = 0

    def observe(self, seconds: float) -> bool:
        slow = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            slow = seconds > self.factor * med
            self.flagged += int(slow)
        self.times.append(seconds)
        return slow


class Heartbeat:
    """Periodic liveness file for an external supervisor to watch."""

    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self.beat()

    def beat(self, extra: dict | None = None):
        payload = {"time": time.time(), "pid": os.getpid()}
        if extra:
            payload.update(extra)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)

    def start(self):
        self.beat()
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()


def elastic_batch(global_batch: int, world: int, prev_world: int | None
                  = None) -> tuple[int, float]:
    """Per-host batch + LR rescale after an elastic world-size change.

    Keeps the global batch constant when divisible; otherwise rounds the
    per-host batch up and returns the LR scale that compensates for the
    effective-batch change (linear scaling rule).
    """
    per = -(-global_batch // world)          # ceil
    eff = per * world
    lr_scale = eff / global_batch
    return per, lr_scale
