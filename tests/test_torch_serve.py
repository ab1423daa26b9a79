"""The port's serving driver, `repro_torch.launch.serve`, end to end on
the CPU at the smoke configs: the checks of tests/test_serve_smoke.py,
plus the rule that without `--device` it runs on the card or raises."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b",
                                  "mamba2-1.3b"])
def test_serve_decodes_on_cpu(arch):
    b, gen = 2, 4
    toks = serve.main(["--smoke", "--arch", arch, "--batch", str(b),
                       "--prompt-len", "8", "--gen", str(gen),
                       "--device", "cpu"])
    assert isinstance(toks, torch.Tensor) and toks.device.type == "cpu"
    out = toks.numpy()
    # one token from the prefill argmax + gen decode steps
    assert out.shape == (b, gen + 1)
    assert out.dtype == np.int32
    cfg = get_config(arch, smoke=True)
    assert (out >= 0).all() and (out < cfg.vocab).all()


def test_serve_deterministic_in_seed():
    argv = ["--smoke", "--arch", "qwen3-1.7b", "--batch", "2",
            "--prompt-len", "8", "--gen", "3", "--seed", "11",
            "--device", "cpu"]
    np.testing.assert_array_equal(serve.main(argv).numpy(),
                                  serve.main(argv).numpy())


def test_serve_kernel_path_on_cpu_uses_plain_versions():
    """With both kernels switched on, a prompt the kernels take (T = 128
    for flash, T % ssm_chunk == 0 for SSD) runs their plain versions on
    the CPU and launches nothing."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    before = (fops.flash_attention.launches, sops.ssd_scan.launches)
    for arch in ("qwen3-1.7b", "mamba2-1.3b"):
        model = serve.load_model(arch, smoke=True, device="cpu")
        assert model.cfg.use_flash_kernel and model.cfg.use_ssd_kernel
        tokens = torch.from_numpy(serve.prompts(model.cfg, 1, 128, 0))
        toks, stats = serve.generate(model, tokens, 2)
        assert toks.shape == (1, 3) and stats["prefill_s"] > 0
    assert (fops.flash_attention.launches, sops.ssd_scan.launches) == before


def test_serve_without_device_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--arch", "qwen3-1.7b", "--batch", "1",
                    "--prompt-len", "8", "--gen", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.load_model("mamba2-1.3b", smoke=True)
