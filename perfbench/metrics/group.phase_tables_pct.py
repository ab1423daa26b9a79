"""group.phase_tables_pct: the share of the window's executor time that
a workload group spends on its phase tables: stacking and padding the
schedules, the per-cycle tables and their upload (100 x the summed
durations of the `sim.phase_tables` spans over those of the
`experiment.execute` spans).  Nothing when the program records no
`sim.phase_tables` span (a static cell, or a program without it)."""


def read(rec):
    tables = total = 0
    for sp in rec["spans"]:
        if sp.name == "sim.phase_tables":
            tables += sp.dur
        elif sp.name == "experiment.execute":
            total += sp.dur
    if not tables or not total:
        return None
    return 100.0 * tables / total
