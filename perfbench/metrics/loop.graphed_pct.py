"""loop.graphed_pct: the share of the window's simulated cycles that the
cycle loop replayed from a CUDA graph: 100 x the summed `graphed` over
the summed `cycles` of the window's `sim.cycles` spans.  Nothing when no
span carries `graphed` (a program whose loop has no graphs), and nothing
off the card, where there are no graphs to replay and the loop always
runs eagerly."""


def read(rec):
    if rec["device"]["platform"] != "gpu":
        return None
    graphed = cycles = 0
    seen = False
    for sp in rec["spans"]:
        if sp.name == "sim.cycles" and "graphed" in sp.args:
            seen = True
            graphed += int(sp.args["graphed"])
            cycles += int(sp.args["cycles"])
    return 100.0 * graphed / cycles if seen and cycles else None
