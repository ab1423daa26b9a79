"""group.outside_loop_pct: the share of the window's executor time that
lies outside the cycle loop, a group's fixed work (stacking and padding
the batch, the upload and state allocation, the readback, the sweep
engine and the result rows): 100 x (1 - the summed durations of the
`sim.cycles` spans over those of the `experiment.execute` spans).
Nothing when the program records no `sim.cycles` span."""


def read(rec):
    loop = total = 0
    for sp in rec["spans"]:
        if sp.name == "sim.cycles":
            loop += sp.dur
        elif sp.name == "experiment.execute":
            total += sp.dur
    if not loop or not total:
        return None
    return 100.0 * (1.0 - loop / total)
