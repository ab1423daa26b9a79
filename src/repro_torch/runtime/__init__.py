"""Fault-tolerance runtime helpers: retries, watchdogs, elastic batching."""
from .fault import retry, StepWatchdog, Heartbeat, elastic_batch  # noqa
