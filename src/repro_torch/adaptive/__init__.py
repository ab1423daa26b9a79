"""Minimal-adaptive routing subsystem (DESIGN.md §15).

One front door for the adaptive-routing pieces that live across the
layers they extend:

  * the **productive-ports mask** (`core.routing.productive_ports`)
    — `[N_dst, N, P]` bool, every escape-safe minimal next hop per
    (destination, node);
  * the **VC partition** in the batched simulator
    (`SimConfig(routing="adaptive")`): VC 0 is the escape class driven
    by the certified-acyclic static up*/down* table, VCs 1..V-1 are the
    adaptive class whose output port is chosen by downstream credit
    count among productive ports;
  * the **escape certification** (`analysis.routing_verify
    .check_escape`, diagnostic RT005): every adaptive choice retains a
    deliverable escape path and the escape-class channel-dependency
    graph stays acyclic.

The port's copy of `repro.adaptive`: the same front door, with the
simulator's `device` (None: the CUDA card; "cpu" for the CPU).

    import repro_torch.adaptive as A
    from repro_torch.core import topology as T, traffic as TR
    from repro_torch.core.routing import build_routing

    r = build_routing(T.build("folded_hexa_torus", 36))
    out = A.compare_saturation(r, TR.uniform(r.topo), A.adaptive_config(),
                               device="cpu")
    print(out["static"], out["adaptive"], out["gain"])
"""
from __future__ import annotations

import numpy as np

from ..analysis.routing_verify import check_escape
from ..core.routing import Routing, productive_ports
from ..core.simulator import (ADAPTIVE_HEADROOM, STATIC_HEADROOM,
                              SimConfig, routing_headroom,
                              saturation_throughput)

__all__ = [
    "ADAPTIVE_HEADROOM", "STATIC_HEADROOM", "adaptive_config",
    "check_escape", "compare_saturation", "productive_ports",
    "routing_headroom",
]


def adaptive_config(cfg: SimConfig | None = None,
                    n_vcs: int | None = None) -> SimConfig:
    """A SimConfig running the minimal-adaptive mode.

    Starts from `cfg` (default: the stock SimConfig), switches
    `routing="adaptive"` and — because the mode needs VC 0 escape plus
    at least one adaptive VC — raises `n_vcs` to 2 if the base config
    has fewer.  Pass `n_vcs` to pick the VC count explicitly.
    """
    cfg = cfg or SimConfig()
    if n_vcs is None:
        n_vcs = max(cfg.n_vcs, 2)
    return cfg._replace(routing="adaptive", n_vcs=n_vcs)


def compare_saturation(routing: Routing, traffic: np.ndarray,
                       cfg: SimConfig | None = None,
                       n_rates: int = 6, *, device=None) -> dict:
    """Static-vs-adaptive saturation for one (routing, traffic) cell.

    Runs `simulator.saturation_throughput` once per mode (each with its
    own routing-aware rate-grid headroom) on `device` and reports the
    relative gain.  `cfg` may be either mode; both variants are derived
    from it.
    """
    cfg = cfg or SimConfig()
    st = saturation_throughput(routing, traffic,
                               cfg._replace(routing="static"), n_rates,
                               device=device)
    ad = saturation_throughput(routing, traffic, adaptive_config(cfg),
                               n_rates, device=device)
    s, a = st["sim_saturation"], ad["sim_saturation"]
    return dict(static=s, adaptive=a,
                gain=a / s - 1.0 if s > 0 else float("nan"),
                analytic=st["analytic_saturation"],
                static_sweep=st, adaptive_sweep=ad)
