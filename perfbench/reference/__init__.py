"""The benchmark's plain reference of the cycle simulator.

Frozen copies of the port's plain pieces, taken from `src/repro_torch/`
at commit 1dee169 (the tests of that commit hold them bit for bit
against the JAX package): the topology generators, up*/down* routing,
the link and cost models, traffic patterns, the collective flows and
workload schedules, spec and schedule padding, and the cycle runner
with the plain allocator `netstep_ref`.  Only imports between these
files were changed, the caches, tracing, profiling and the CUDA
allocator were cut, and `SimConfig.inject_dtype` was added for the
control.  `scenario.py` builds and simulates one scenario from its
definition.  Nothing here imports the program.
"""
