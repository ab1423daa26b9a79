"""repro_torch.core — the port's topologies, routing, link and cost
models (numpy/scipy copies of `repro.core`) and the torch cycle
simulator."""
