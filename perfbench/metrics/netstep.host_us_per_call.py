"""netstep.host_us_per_call: the host's microseconds per call of the
allocator (the `netstep` wrapper and its launch) in the window's cycle
loop: the `alloc_ns` over the `alloc_calls` of the window's `sim.cycles`
spans, stamped at the call site.  Nothing when the program records no
such span."""


def read(rec):
    ns = calls = 0
    for sp in rec["spans"]:
        if sp.name == "sim.cycles":
            ns += int(sp.args.get("alloc_ns", 0))
            calls += int(sp.args.get("alloc_calls", 0))
    return ns / 1e3 / calls if calls else None
