"""sim_router_cycles_per_s: live (scenario, rate) rows x that scenario's
chiplets x cycles simulated, summed over the window's completed groups,
over the window's wall seconds (host clock, synchronised at the end).
Padded rows are not counted."""


def read(rec):
    work = sum(n * rec["n_rates"] * rec["cycles"]
               for g in rec["window"] for n, _, _, _ in g["dims"])
    return work / rec["window_s"]
