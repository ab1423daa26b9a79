"""The port's obs, adaptive and synth examples (`examples_torch/`)
against the reference's (`examples/`, unedited) on the CPU.

Both packages' scripts run at the reference examples' own sizes, each in
its own process, all six at once (`tools/smoke_reference.example_runs`,
as in tests/test_torch_examples_sim.py).  Checks:

* the files each writes are equal byte for byte: obs's link-load and
  window CSVs and synth's search state.  obs's span trace is not: it
  holds wall-clock times;
* the printed result lines are equal (`chip_smoke.example_lines`).  The
  `[io] wrote` / `[obs] wrote` lines are dropped (they name the files);
  the port's `--out` directory reads `results/` in its trace pointer;
  the reference's pointer to `results/adaptive_gain.csv` is cut (only
  its unported benchmarks write that file, and the port's line names
  none); obs's compile and runner-cache counts are cut from its sweep
  line, since the port compiles nothing and has no compiled-runner cache
  (the sweep runs stay and are compared);
* the reference's digests and lines are chip_smoke's
  `REFERENCE_EXAMPLES`;
* what `examples/README.md` promises, where the reference keeps it:
  FoldedHexaTorus's link-load Gini lies below Mesh's, and synth prints
  `within 5% of front: True`.
"""
import hashlib
import os
import re
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("obs_quickstart", "adaptive_quickstart", "synth_quickstart")
WRITERS = ("obs_quickstart", "synth_quickstart")


def _modules():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    try:
        import chip_smoke
        import smoke_reference
    finally:
        del sys.path[:2]
    return chip_smoke, smoke_reference


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    _, smoke_reference = _modules()
    return smoke_reference.example_runs(tmp_path_factory.mktemp("examples"),
                                        SCRIPTS, ["--device", "cpu"])


@pytest.mark.parametrize("script", WRITERS)
def test_files_equal_the_reference_s(pairs, script):
    ref, port = pairs[script]["reference"], pairs[script]["port"]
    assert set(port["files"]) == set(ref["files"]) != set()
    for name, data in ref["files"].items():
        assert port["files"][name] == data, name


@pytest.mark.parametrize("script", SCRIPTS)
def test_printed_lines_equal_the_reference_s(pairs, script):
    ref, port = pairs[script]["reference"], pairs[script]["port"]
    assert len(ref["lines"]) > 5
    assert port["lines"] == ref["lines"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_reference_is_chip_smoke_s_table(pairs, script):
    chip_smoke, _ = _modules()
    want = chip_smoke.REFERENCE_EXAMPLES
    ref = pairs[script]["reference"]
    assert ref["lines"] == want["lines"][script]
    for name, data in ref["files"].items():
        assert hashlib.sha256(data).hexdigest() == want["files"][name], name


@pytest.mark.parametrize("script", WRITERS)
def test_port_writes_only_under_out(pairs, script):
    """Every file the port's script reports writing, the span trace
    included, lies in its --out directory."""
    port = pairs[script]["port"]
    wrote = re.findall(r"^\[(?:io|obs)\] wrote (\S+) ", port["raw"], re.M)
    assert len(wrote) >= len(port["files"])
    for path in wrote:
        assert os.path.dirname(path) == port["out"], path


def test_obs_folding_flattens_the_load(pairs):
    lines = pairs["obs_quickstart"]["port"]["lines"]
    line = next(x for x in lines if "folding flattens the load" in x)
    m = re.search(r"FHT gini ([\d.]+) vs mesh ([\d.]+)", line)
    assert m and float(m[1]) < float(m[2]), line


def test_obs_counts_its_own_sweep_runs(pairs):
    """The port prints the sweep runs of its own experiment (2, as the
    reference's fresh process counts) and no compile or cache count."""
    raw = pairs["obs_quickstart"]["port"]["raw"]
    assert re.search(r"^  sweep runs=2$", raw, re.M), raw
    assert "compiles=" not in raw and "runner cache" not in raw
    assert re.search(r"^  sweep runs=2 compiles=",
                     pairs["obs_quickstart"]["reference"]["raw"], re.M)


def test_adaptive_certificate_and_no_results_pointer(pairs):
    port = pairs["adaptive_quickstart"]["port"]
    assert any(x.startswith("  certificate: ok=True escape_safe=True")
               for x in port["lines"])
    assert "results/" not in port["raw"]


def test_synth_fht_within_five_percent_of_the_front(pairs):
    lines = pairs["synth_quickstart"]["port"]["lines"]
    assert lines[-1] == "  folded_hexa_torus within 5% of front: True"
