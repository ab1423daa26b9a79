"""Paper -> framework bridge: what a training step's collectives cost
under different chiplet-ICI topologies.

    PYTHONPATH=src python examples_torch/topology_collectives.py \
        [--device cpu] [build/dryrun/qwen3_1_7b__train_4k__pod1.json ...]

The port's `examples/topology_collectives.py`.  Reads dry-run records
(all-reduce/all-gather bytes per chip of the sharded train step, as
`python -m repro_torch.launch.dryrun` writes them under `build/dryrun/`)
and prices each under each ICI topology with the paper's
saturation-throughput results (the analytic channel-load model, on the
host); `main` returns {tag: {topology: seconds}}.  Without paths it
reads `build/dryrun/*train_4k__pod1.json`; with none there it says how
to make one and exits.  Writes no file; `--out` is accepted so that
every example takes the same flags.
"""
import argparse
import glob
import json
import os

from repro_torch.core.collectives import build_ici_model
from repro_torch.device import resolve_device

OUT = os.path.join("build", "examples")
DRYRUN = os.path.join("build", "dryrun")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*", help="dry-run records (JSON)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT, help="unused: writes no file")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    paths = args.paths or sorted(
        glob.glob(os.path.join(DRYRUN, "*train_4k__pod1.json")))
    if not paths:
        print("no dry-run artifacts found — run python -m "
              "repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k "
              "first")
        return {}
    prices = {}
    for path in paths[:4]:
        with open(path) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            continue
        print(f"\n=== {rec['tag']} ===")
        print(f"collective bytes/chip/step: "
              f"{rec['collective_bytes_per_chip']/2**30:.2f} GiB")
        prices[rec["tag"]] = row = {}
        for topo in ("mesh", "hexamesh", "folded_torus",
                     "folded_hexa_torus"):
            m = build_ici_model(topo, 64, "organic", device=device)
            t = sum(m.collective_time_s(kind.replace("-", "_"),
                                        v["bytes"])
                    for kind, v in rec["collectives"].items())
            row[topo] = t
            print(f"  {topo:20s} B_eff={m.b_eff_gbps/1e3:6.2f} Tb/s  "
                  f"step collective time ~ {t*1e3:8.2f} ms")
    return prices


if __name__ == "__main__":
    main()
