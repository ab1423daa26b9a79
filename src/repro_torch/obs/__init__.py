"""repro_torch.obs — the port's span tracer (`obs.trace`) and metrics
registry (`obs.metrics`)."""
