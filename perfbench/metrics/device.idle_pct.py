"""device.idle_pct: the share of the traced stretch's wall time in which
no operation ran on the device, read from the profiler's trace of that
stretch (every group shape for 10 warm-up and 60 measured cycles; the
`device` block's `busy_s` over its `window_s`).  The profiler slows the
host's issue of each cycle, so this reads above the unprofiled window's
idle share."""


def read(rec):
    p = rec["profile"]
    if not p.get("wall_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
