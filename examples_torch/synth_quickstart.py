"""Quickstart: synthesize custom topologies and search the design
space (DESIGN.md §11).

    PYTHONPATH=src python examples_torch/synth_quickstart.py \
        [--device cpu] [--out build/examples]

The port's `examples/synth_quickstart.py`, on the CUDA card unless
`--device cpu` is given.  Shows the three layers of `repro_torch.synth`:
(1) custom topologies as first-class citizens — build one from raw
edges, register a generator, evaluate both through the ordinary
experiment API; (2) the design space and feasibility filter; (3) a
small seeded search producing a Pareto front with save/resume, its
state written to `OUT/synth_state_demo.json`.  The registered
"double_ring" generator stays registered in the process, as a
registration does.
"""
import argparse
import os

import repro_torch.experiments as X
from repro_torch.core import topology as T
from repro_torch.core.simulator import SimConfig
from repro_torch.device import resolve_device
from repro_torch.synth import (FeasibilityCriteria, SearchConfig,
                               SearchState, check, fold_mask_variants,
                               random_geometric, run_search)

OUT = os.path.join("build", "examples")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT,
                    help="directory of the search state")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    print("=== custom topologies are first-class ===")
    # a Topology built from raw arrays (validated: no self-loops,
    # duplicates or disconnection), evaluated like any registry name
    base = T.build("mesh", 16)
    ring = T.make_topology("ring16", base.pos,
                           [(i, (i + 1) % 16) for i in range(16)])
    # ... or a registered generator, resolvable by name everywhere
    T.register_topology(
        "double_ring", lambda n: ("double_ring", base.pos,
                                  [(i, (i + 1) % n) for i in range(n)]
                                  + [(i, (i + 2) % n) for i in range(n)]),
        overwrite=True)
    exp = X.Experiment([X.Scenario(ring, 16), X.Scenario("double_ring", 16),
                        X.Scenario("folded_hexa_torus", 16)],
                       backend="analytic", name="custom_demo")
    for row in X.run(exp, device=device).ok():
        print(f"  {row['topology']:18s} analytic T_r="
              f"{row['analytic_saturation']:.3f} "
              f"radix={row['radix']}")

    print("\n=== the design space + feasibility filter ===")
    crit = FeasibilityCriteria()          # the paper's three principles
    variants = fold_mask_variants(16, families=("grid", "brick"))
    feasible = [t for t in variants if not check(t, crit)]
    print(f"  {len(variants)} fold-mask variants, "
          f"{len(feasible)} substrate-feasible")
    rg = random_geometric(16, seed=7, max_degree=6, max_range=1)
    print(f"  random geometric: {rg.name} radix={rg.radix} "
          f"links={len(rg.edges)} feasible={not check(rg, crit)}")

    print("\n=== a small seeded search (save + resume) ===")
    cfg = SearchConfig(n=16, n_random=8, generations=1, offspring=8,
                       sim_top=4, n_rates=3,
                       cfg=SimConfig(cycles=360, warmup=120))
    res = run_search(cfg, device=device)
    path = os.path.join(args.out, "synth_state_demo.json")
    res.state.to_json(path)                     # serializable SearchState
    SearchState.from_json(path)                 # ... and back
    print(f"  {res.stats['n_feasible']} feasible candidates, "
          f"{res.stats['n_simulated']} cycle-simulated "
          f"(prefilter {res.prefilter_ratio:.1f}x)")
    for c in res.front():
        m = c.metrics
        print(f"  front: {c.topo.name:24s} "
              f"{m['abs_throughput_gbps']:7.1f} Gb/s  "
              f"{m['zero_load_latency_ns']:5.1f} ns  "
              f"{m['wire_cost_mm']:8.0f} wire-mm")
    print("  folded_hexa_torus within 5% of front:",
          res.on_front("folded_hexa_torus", eps=0.05))


if __name__ == "__main__":
    main()
