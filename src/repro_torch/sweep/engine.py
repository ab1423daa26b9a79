"""Batched multi-topology sweep engine (DESIGN.md §6).

The port of `repro.sweep.engine`'s primitive layer.  `SweepEngine` runs
"K topologies x R injection rates" as a handful of batched simulations:
specs are grouped by *bucketed* padded shape (dims rounded up to
configurable multiples, batch size rounded up by replicating the last
spec, rate rows rounded up by repeating the last rate) — the same
S/R/N/C/D bucketing as the reference, so a group here simulates the
same rows as a compiled program there — and padding invariance (see
`repro_torch.sweep.padding`) keeps results bitwise-equal to the
single-spec path.

The reference counts compiled executables per group; the port compiles
nothing per shape, so that accounting is gone.  Case-level evaluation
(`SweepCase` -> routing + traffic) is here; the experiment API and its
shims come with the experiments slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np

from ..core import simulator as sim
from ..core import topology as T
from ..core import traffic as TR
from ..core.routing import cached_routing
from ..core.simulator import SimConfig, SimSpec
from ..obs.trace import trace
from .padding import PadShape


class SweepCase(NamedTuple):
    """One (topology, size, substrate, traffic) evaluation cell."""
    name: str
    n: int
    substrate: str = "organic"
    pattern: str = "uniform"
    area: float = 74.0
    roles: str = "homogeneous"

    def build(self) -> tuple:
        """(routing, traffic matrix) for this cell, via the shared cache."""
        topo, routing = cached_routing(self.name, self.n, self.substrate,
                                       self.area, self.roles)
        return routing, TR.PATTERNS[self.pattern](topo)

    @property
    def valid(self) -> bool:
        return T.valid_n(self.name, self.n)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m if m > 1 else x


@dataclasses.dataclass
class SweepEngine:
    """Padded-batch sweep runner.

    bucket=False disables shape rounding (every distinct max-shape gets
    its own group).  `device` is passed to `simulator.run_batch`: None
    is the CUDA card, "cpu" the CPU.
    """
    cfg: SimConfig = SimConfig()
    bucket: bool = True
    s_round: int = 4         # batch axis rounded up to a multiple of this
    r_round: int = 4         # rate axis rounded up to a multiple of this
    n_mult: int = 8          # node-dim bucket
    c_mult: int = 32         # channel-dim bucket
    d_mult: int = 4          # link-ring bucket
    device: object = None

    def __post_init__(self):
        self.stats = dict(runs=0, groups=0, specs=0)

    def bucket_shape(self, shape: PadShape) -> PadShape:
        if not self.bucket:
            return shape
        return PadShape(n=_round_up(shape.n, self.n_mult),
                        p=shape.p,
                        c=_round_up(shape.c, self.c_mult),
                        d=_round_up(shape.d, self.d_mult))

    def run_specs(self, specs: Sequence[SimSpec], rates,
                  single_program: bool = False,
                  cfg: SimConfig | None = None) -> list[dict]:
        """Run heterogeneous specs through few batched simulations.

        rates: [R] shared or [S, R] per-spec.  Returns one result dict
        per spec (same keys as `simulator.run_batch`), in input order.
        single_program=True pads every spec to one global shape, so the
        whole sweep is one group.  `cfg` overrides the engine's
        SimConfig for this call only.
        """
        cfg = cfg or self.cfg
        s = len(specs)
        rates = np.asarray(rates, np.float32)
        if rates.ndim == 1:
            rates = np.broadcast_to(rates, (s, rates.shape[0])).copy()
        n_rates = rates.shape[1]
        r_pad = _round_up(n_rates, self.r_round) if self.bucket else n_rates

        groups: dict[PadShape, list[int]] = {}
        if single_program:
            groups[self.bucket_shape(PadShape.of(specs))] = list(range(s))
        else:
            for i, spec in enumerate(specs):
                key = self.bucket_shape(
                    PadShape(n=spec.n, p=spec.p, c=spec.c, d=spec.d))
                groups.setdefault(key, []).append(i)

        results: list = [None] * s
        for shape, idxs in groups.items():
            g_specs = [specs[i] for i in idxs]
            g_rates = rates[idxs]
            if r_pad > n_rates:
                g_rates = np.concatenate(
                    [g_rates,
                     np.repeat(g_rates[:, -1:], r_pad - n_rates, axis=1)],
                    axis=1)
            s_live = len(g_specs)
            s_pad = _round_up(s_live, self.s_round) \
                if self.bucket else s_live
            while len(g_specs) < s_pad:           # replicate an inert tail
                g_specs.append(g_specs[-1])
                g_rates = np.concatenate([g_rates, g_rates[-1:]], axis=0)
            with trace("sweep.group", cat="sweep", specs=len(g_specs),
                       shape=str(shape), s_live=s_live, s_pad=s_pad,
                       r_live=n_rates, r_pad=g_rates.shape[1]):
                out = sim.run_batch(g_specs, g_rates, cfg, pad_shape=shape,
                                    device=self.device)
            for j, i in enumerate(idxs):
                results[i] = {k: v[:n_rates] for k, v in out[j].items()}
        self.stats["runs"] += 1
        self.stats["groups"] += len(groups)
        self.stats["specs"] += s
        return results
