"""Device time from `torch.profiler`: busy time, launches, kernels by
name, and the device's idle gaps named by the host span open in them.

`busy_s` and `idle share = 1 - busy / wall` are the arithmetic of
`chip_smoke`'s `profile_cycles` (commit 1dee169): a session records
device activity only, and a session that saw no device event is
repeated, up to three times.  The session is read from the profiler's
raw events, not from `key_averages()`, which builds a Python object per
event and takes minutes over the hundreds of thousands of launches of a
whole simulated group.
"""
from __future__ import annotations

import time


def device_events(prof, device: str = "CUDA") -> list:
    """(name, start ns, end ns) of every event the profiler recorded on
    `device` ("CUDA": kernels, copies, fills), in its own clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith(device):
            continue
        t0 = e.start_ns()
        out.append((e.name(), t0, t0 + e.duration_ns()))
    return out


def by_name(events: list) -> list:
    """[(name, seconds, count)] of the events, summed by name."""
    acc: dict = {}
    for name, t0, t1 in events:
        s, c = acc.get(name, (0, 0))
        acc[name] = (s + t1 - t0, c + 1)
    return [(k, s / 1e9, c) for k, (s, c) in acc.items()]


def _merge(iv: list) -> list:
    merged: list = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


#: the clock marks' kernel: a float64 fill, which the simulator never
#: launches (its device tensors are integer, bool and float32)
MARK = "FillFunctor<double>"


def session(torch, run, sessions: int = 3, kernel: str = "",
            launched=None) -> dict | None:
    """Profile `run()` (which ends synchronised) with device activity
    only, between two clock marks: a one-element float64 fill launched on
    an idle device at a known host time, before and after the run.  The
    last mark found ties the profiler's clock to `time.perf_counter_ns`.
    Returns None if no session saw a device event; else the session's
    rows (the marks left out), host span of the run (`t0_ns`, `t1_ns`),
    wall seconds, busy seconds, launch count and device intervals in
    perf_counter nanoseconds (none where no mark was found).

    The profiler can drop device events.  Where the program counts its
    own launches of a kernel (`launched()`, a running count), a session
    whose rows of `kernel` count fewer launches than the program made in
    it is repeated too; after the last attempt it is taken as it is."""
    from torch.profiler import ProfilerActivity, profile
    mark = torch.zeros(1, dtype=torch.float64, device="cuda")
    events = []
    for _ in range(sessions):
        torch.cuda.synchronize()
        before = launched() if launched else 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            m0 = time.perf_counter_ns()
            mark.fill_(1.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            run()
            torch.cuda.synchronize()
            t1 = time.perf_counter_ns()
            mark.fill_(2.0)
            torch.cuda.synchronize()
        made = launched() - before if launched else 0
        events = device_events(prof)
        seen = sum(1 for name, _, _ in events if kernel and kernel in name)
        if any(MARK not in name for name, _, _ in events) and seen >= made:
            break
    marks = sorted(t0_ for name, t0_, _ in events if MARK in name)
    iv = sorted((a, b) for name, a, b in events if MARK not in name)
    if not iv:
        return None
    merged, off = [], None
    if marks:
        # a mark starts a launch latency after its host time: the one
        # after every other event at t1, the one before them all at m0
        if marks[-1] >= iv[-1][0]:
            off = marks[-1] - t1
        elif marks[0] <= iv[0][0]:
            off = marks[0] - m0
    if off is not None:
        merged = [(s - off, e - off) for s, e in _merge(iv)]
    rows = by_name([ev for ev in events if MARK not in ev[0]])
    rows_busy = sum(t for _, t, _ in rows)
    # busy: the union of the device's intervals where the clocks are
    # tied, else the sum of the events' device time (one stream: the same)
    busy = sum(e - s for s, e in merged) / 1e9 if merged else rows_busy
    return dict(rows=rows, t0_ns=t0, t1_ns=t1, wall_s=(t1 - t0) / 1e9,
                busy_s=busy, rows_busy_s=rows_busy, launches=len(iv),
                intervals_ns=merged, marks=len(marks))


def idle_gaps(sess: dict, spans: list, top: int = 10) -> list:
    """The device's idle time in the session by host span: each idle gap
    is cut where a span (name, perf_counter ns start, duration) opens or
    closes, and each piece goes to the innermost span open over it;
    [[name, seconds], ...], largest first."""
    iv = sess["intervals_ns"]
    if not iv:
        return []
    edges = [(sess["t0_ns"], iv[0][0])]
    edges += [(iv[k][1], iv[k + 1][0]) for k in range(len(iv) - 1)]
    edges.append((iv[-1][1], sess["t1_ns"]))
    by: dict = {}
    for g0, g1 in edges:
        if g1 <= g0:
            continue
        cuts = sorted({g0, g1} | {t for _, ts, dur in spans
                                  for t in (ts, ts + dur) if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            best = None
            for name, ts, dur in spans:
                if ts <= mid < ts + dur and (best is None or dur < best[1]):
                    best = (name, dur)
            name = best[0] if best else "outside any span"
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:top]
