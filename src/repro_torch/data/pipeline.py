"""Deterministic synthetic LM data pipeline.

Produces a reproducible, loosely Zipf-distributed token stream with
enough sequential structure (a noisy mod-vocab random walk) that a model
can actually reduce loss on it — which the end-to-end example and the
loss-descent test rely on.  Sharding: each host materializes only its own
per-host slice (`host_batch_slice`), the standard per-host input pipeline
pattern for multi-host data parallelism.  numpy only: the port's own copy
of the JAX package's pipeline, whose batches it equals bit for bit for
the same (seed, step, n_hosts, host_index).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        self.host_batch = self.global_batch // self.n_hosts

    def _walk(self, rng, n):
        """Noisy multiplicative random walk over the vocab."""
        steps = rng.integers(1, 17, size=n)
        noise = rng.integers(0, self.vocab, size=n)
        use_noise = rng.uniform(size=n) < 0.15
        toks = np.empty(n, dtype=np.int64)
        t = int(rng.integers(0, self.vocab))
        for i in range(n):
            t = int(noise[i]) if use_noise[i] else \
                (t * 31 + int(steps[i])) % self.vocab
            toks[i] = t
        return toks

    def batch(self, step: int) -> dict:
        """Batch for a given step (deterministic in (seed, step, host))."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.host_index)
        n = self.host_batch * (self.seq_len + 1)
        toks = self._walk(rng, n).reshape(self.host_batch,
                                          self.seq_len + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
