"""setup.plan_s: seconds of `repro_torch.experiments.plan` on the cell's
grid (topologies, routing tables, specs, schedules, rate grids), by the
harness's clock around the call."""


def read(rec):
    return rec["plan_s"]
