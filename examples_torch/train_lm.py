"""End-to-end driver: train a qwen3-family model on the synthetic
pipeline.

    PYTHONPATH=src python examples_torch/train_lm.py [--device cpu]
    PYTHONPATH=src python examples_torch/train_lm.py --steps 300 \
        --d-model 512 --layers 12 --batch 8 --seq 512     # ~100M params

The port's `examples/train_lm.py`: a thin wrapper over
`repro_torch.launch.train.main`.  Without driver flags it runs the
reference example's demo (qwen3-1.7b's reduced config, 60 steps of
batch 8 x 128, a log line every 10).  `--device` passes through to the
driver, which runs on the CUDA card unless `--device cpu` is given; any
other flag is the driver's (`--arch`, `--smoke`, `--steps`, `--batch`,
`--seq`, `--d-model`, `--layers`, `--ckpt-dir`, ...; without `--smoke`
the full config).  Returns the loss of every step.  Writes no file
unless the driver is given `--ckpt-dir`; `--out` is accepted so that
every example takes the same flags.
"""
import argparse
import os
import sys

from repro_torch.launch.train import main as train_main

OUT = os.path.join("build", "examples")
DEFAULT_ARGV = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "60",
                "--batch", "8", "--seq", "128", "--log-every", "10"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 allow_abbrev=False)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT, help="unused: writes no file")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    rest = rest or list(DEFAULT_ARGV)
    if args.device is not None:
        rest += ["--device", args.device]
    return train_main(rest)


if __name__ == "__main__":
    main()
