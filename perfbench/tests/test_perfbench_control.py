"""The check that decides `correct` must fail: its control (the
reference one precision step down) and a run with the timed path broken
underneath, at a tiny size on the CPU."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench_tiny import bench, cells, run_cell, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _cell_files(root, cell):
    from perfbench import grid as G
    w = {c["name"]: c for c in bench()["workloads"]}[cell]
    return (G.load_json(G.find(root, "configs", w["config"])),
            G.load_json(G.find(root, "traffic", w["traffic"])))


@pytest.mark.parametrize("cell", cells())
def test_control_fails_the_check(root, cell):
    """bfloat16 injection tests move counters on every seed tried."""
    from perfbench import control
    config, mix = _cell_files(root, cell)
    for seed in (11, 12, 13):
        r = control.readings(config, mix, seed, "cpu")
        assert r["counters_differing"] > 0, (seed, r)


def test_control_as_stated_passes(root):
    """The same reference at the stated precision reads 0."""
    from perfbench import control
    config, mix = _cell_files(root, cells()[0])
    r = control.readings(config, mix, 11, "cpu", inject_dtype="float32")
    assert r["counters_differing"] == 0 and r["values_differing"] == 0


def _stuck_alloc(op_slot, eligible, rr_vc, rr_port):
    """An allocator that grants nothing: no flit ever moves."""
    import torch
    B, N, PI, V = op_slot.shape
    return (torch.zeros_like(eligible),
            torch.zeros((B, N, PI), dtype=torch.int32),
            torch.full((B, N, PI), -1, dtype=torch.int32))


def _half_batch(orig):
    """Simulate only the first half of each spec's rate rows and hand
    their answers out for the other half too."""
    def run_batch(specs, rates, cfg, **kw):
        rates = np.array(rates, np.float32)
        half = rates.shape[1] // 2
        rates[:, half:2 * half] = rates[:, :half]
        return orig(specs, rates, cfg, **kw)
    return run_batch


def _altered(orig):
    """Every spec's answer altered by one delivered flit."""
    def run_batch(*a, **kw):
        out = orig(*a, **kw)
        for res in out:
            res["delivered"] = res["delivered"].copy()
            res["delivered"][0] += 1
        return out
    return run_batch


def _never_comes(orig):
    """Every batch raises: no answer comes (the executor skips the
    chunk and marks its scenarios failed)."""
    def run_batch(*a, **kw):
        raise RuntimeError("planted fault")
    return run_batch


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "never_comes"])
@pytest.mark.parametrize("cell", cells())
def test_broken_timed_path_is_not_correct(capsys, monkeypatch, root, cell,
                                          fault):
    """The harness's whole run with the program broken underneath (the
    look for a card skipped): `correct` comes out false.  One card, so
    no exchange between chips to leave out."""
    import repro_torch.core.simulator as sim
    if fault == "state_unchanged":
        monkeypatch.setattr(sim, "netstep_ref", _stuck_alloc)
    elif fault == "half_batch":
        monkeypatch.setattr(sim, "run_batch", _half_batch(sim.run_batch))
    elif fault == "answer_altered":
        monkeypatch.setattr(sim, "run_batch", _altered(sim.run_batch))
    else:
        monkeypatch.setattr(sim, "run_batch", _never_comes(sim.run_batch))
    rc, line, err = run_cell(capsys, root, cell, seed=23)
    assert rc == 0, err
    assert line["correct"] is False
    assert line["checks"]["counters_differing"]["value"] > 0
    if fault == "never_comes":
        assert line["failed"] == line["attempted"] > 0
        assert line["checks"]["scenarios_failed"]["value"] > 0
