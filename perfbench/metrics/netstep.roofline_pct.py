"""netstep.roofline_pct: the allocation's bound at the shapes handed to
it (inputs read once, outputs written once, over 3.35 TB/s; or its
operations over 67 TFLOP/s, whichever is longer; `perfbench.roofline`)
over the `netstep` kernel's mean device time per launch in the traced
stretch.  Nothing when no kernel of that name ran."""


def read(rec):
    p = rec["profile"]
    if not p.get("netstep_device_ms"):
        return None
    return 100.0 * p["netstep_bound_ms"] / p["netstep_device_ms"]
