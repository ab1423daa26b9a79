"""loop.host_us_per_cycle: the host's microseconds per simulated cycle
inside the cycle loop, with no profiler attached: the summed durations of
the window's `sim.cycles` spans (one per chunk of cycles of a group, from
the program's own clock) over the cycles they hold.  Nothing when the
program records no such span."""


def read(rec):
    ns = cycles = 0
    for sp in rec["spans"]:
        if sp.name == "sim.cycles":
            ns += sp.dur
            cycles += int(sp.args["cycles"])
    return ns / 1e3 / cycles if cycles else None
