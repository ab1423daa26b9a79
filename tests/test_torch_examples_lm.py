"""The port's serve_lm and train_lm examples (`examples_torch/`) on the
CPU, in this process, at the reference examples' smoke sizes.

* serve_lm with no driver flags serves the reference example's default
  (qwen3-1.7b's smoke config, batch 4, 32-token prompts, 16 new tokens):
  tokens [4, 17] (`launch.serve.generate` returns the prefill's token
  and the 16 decoded ones) within the vocabulary, the same in two runs;
* train_lm at `--smoke --steps 20 --log-every 5`: every loss finite, and
  the last logged loss below the first.

The weights come from `torch.Generator`, the reference's from JAX's
PRNG, so tokens and losses are not compared across the packages: the
serving and training paths themselves are held to the reference by
tests/test_torch_serve.py and tests/test_torch_train.py.
"""
import importlib.util
import math
import os
import re

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(ROOT, "examples_torch",
                                               f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_lm_default_run(capsys):
    from repro_torch.configs import get_config
    serve_lm = _example("serve_lm")
    toks = serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    again = serve_lm.main(["--device", "cpu"])
    assert tuple(toks.shape) == (4, 17) and toks.dtype == torch.int32
    vocab = get_config("qwen3-1.7b", smoke=True).vocab
    assert bool(((toks >= 0) & (toks < vocab)).all())
    assert torch.equal(toks, again)
    assert re.search(r"^\[serve\] \S+ on cpu: prefill 4x32: ", out, re.M), out
    assert "[serve] decoded 16 tokens/seq x 4 seqs" in out


def test_serve_lm_passes_driver_flags():
    serve_lm = _example("serve_lm")
    toks = serve_lm.main(["--arch", "mamba2-1.3b", "--smoke", "--batch",
                          "2", "--prompt-len", "8", "--gen", "3",
                          "--device", "cpu"])
    assert tuple(toks.shape) == (2, 4)


def test_train_lm_loss_falls(capsys):
    train_lm = _example("train_lm")
    losses = train_lm.main(["--smoke", "--steps", "20", "--log-every", "5",
                            "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 20 and all(math.isfinite(x) for x in losses)
    logged = [float(x) for x in re.findall(r"^\[train\] step=\s*\d+ "
                                           r"loss=([\d.]+)", out, re.M)]
    assert len(logged) == 5                 # steps 0, 5, 10, 15 and 19
    assert logged[-1] < logged[0], logged
    assert "device=cpu" in out
