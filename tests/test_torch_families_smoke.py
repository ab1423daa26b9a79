"""chip_smoke.py's parity table of the model families
(`REFERENCE_FAMILIES`, from `tools/smoke_reference.py families`): the
JAX package recomputes it on the CPU, and the port's `families_parity`
run equals it on the CPU within the phase's float32 tolerance."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke_modules():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    try:
        import chip_smoke
        import smoke_reference
    finally:
        del sys.path[:2]
    return chip_smoke, smoke_reference


def test_smoke_reference_families_table_is_the_committed_one():
    chip_smoke, smoke_reference = _smoke_modules()
    got = smoke_reference.families()
    want = chip_smoke.REFERENCE_FAMILIES
    assert list(got) == list(want) == list(chip_smoke.FAMILY_ARCHS)
    for arch in want:
        assert chip_smoke.numbers(got[arch]) == pytest.approx(
            chip_smoke.numbers(want[arch]), rel=1e-6, abs=1e-6), arch


def test_families_parity_run_on_the_cpu():
    """`families_parity_rows` on the CPU (the path the other CPU tests hold
    against the JAX package) equals REFERENCE_FAMILIES within
    FAMILIES_TOL, as the card's run must."""
    chip_smoke, _ = _smoke_modules()
    rows = chip_smoke.families_parity_rows(torch, torch.device("cpu"))
    for arch, want in chip_smoke.REFERENCE_FAMILIES.items():
        assert chip_smoke.numbers(rows[arch]) == pytest.approx(
            chip_smoke.numbers(want), rel=chip_smoke.FAMILIES_TOL,
            abs=chip_smoke.FAMILIES_TOL), arch
