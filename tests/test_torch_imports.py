"""The port stands alone: `repro_torch`, `chip_smoke.py` and the examples
of `examples_torch/` import no jax and nothing of `repro`, and its entry
points never fall back to the CPU on their own."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve_device  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
EXAMPLES = sorted(str(p.relative_to(ROOT))
                  for p in (ROOT / "examples_torch").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _module_names():
    for f in sorted(PKG.rglob("*.py")):
        parts = f.relative_to(ROOT / "src").with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_every_module_imports_with_jax_absent():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {list(_module_names())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_every_example_imports_with_jax_absent():
    """Each script of examples_torch/ loads as a module (its `main` not
    run) with jax unimportable, and loads no module of `repro`."""
    assert len(EXAMPLES) == 9
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        f"for path in {[str(ROOT / p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    assert callable(mod.main), path\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", EXAMPLES)
def test_example_without_device_raises_when_no_gpu(path):
    """With no --device an example runs on the card: without one it
    raises before it does any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{pathlib.Path(path).stem}", ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--out", str(ROOT / "build" / "never")])
    assert not (ROOT / "build" / "never").exists()


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"] + EXAMPLES))
def test_no_jax_or_reference_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path}:{node.lineno} imports {name}"


def test_run_batch_without_device_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core import simulator as sim
    from repro_torch.core import topology as T, traffic as TR
    from repro_torch.core.routing import build_routing
    r = build_routing(T.build("mesh", 4))
    spec = sim.make_spec(r, TR.uniform(r.topo))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.run_batch([spec], np.array([0.1], np.float32),
                      sim.SimConfig(cycles=4, warmup=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")


def test_resolve_device_names():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_ablation_cuts_match_the_kernel_sources():
    """`kernels.ablate` cuts parts out of the kernel sources (the bf16
    routes and netstep) by pattern; every cut must still find its part,
    or the tool raises on the card."""
    import re
    from repro_torch.kernels.ablate import CUTS, base_lib
    assert set(CUTS) == {"flash_attention", "ssd_scan", "netstep"}
    for name, cuts in CUTS.items():
        src = base_lib(name).source.read_text()
        for cut, subs in cuts.items():
            for pattern, _ in subs:
                assert re.search(pattern, src), (name, cut, pattern)
