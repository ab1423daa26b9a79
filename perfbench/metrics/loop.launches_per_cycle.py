"""loop.launches_per_cycle: device launches (kernels, copies, fills) per
steady measured cycle, averaged over the cell's group shapes: the
profiler's launch count of each shape's long pass less its short pass,
over the measured cycles between them."""


def read(rec):
    return rec["profile"].get("launches_per_cycle")
