"""Batched serving example: prefill + decode with KV/SSM caches.

    PYTHONPATH=src python examples_torch/serve_lm.py [--device cpu] \
        [--arch mamba2-1.3b ...]

The port's `examples/serve_lm.py`: a thin wrapper over
`repro_torch.launch.serve.main`.  Without driver flags it serves the
reference example's smoke run (qwen3-1.7b's reduced config, batch 4,
32-token prompts, 16 new tokens).  `--device` passes through to the
driver, which runs on the CUDA card unless `--device cpu` is given; any
other flag is the driver's (`--arch`, `--batch`, `--prompt-len`,
`--gen`, `--seed`, `--smoke`).  Returns the generated tokens [batch,
gen + 1].  Writes no file; `--out` is accepted so that every example
takes the same flags.
"""
import argparse
import os
import sys

from repro_torch.launch.serve import main as serve_main

OUT = os.path.join("build", "examples")
DEFAULT_ARGV = ["--arch", "qwen3-1.7b", "--smoke", "--batch", "4",
                "--prompt-len", "32", "--gen", "16"]


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
    return serve_main(rest)


if __name__ == "__main__":
    main()
