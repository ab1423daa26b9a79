"""The program's DeepSeek-V3 training step against the plain reference
derivation (`reference/derivations/deepseek_v3.py`), on the CPU.

Through `repro_torch.workloads.collective_workload` the configuration
`deepseek-v3-n256-organic` derives the same schedule as the reference,
phase for phase and bit for bit, at N = 16 on its `tiny_mesh` and at
N = 256 on its own mesh (schedules only, no simulation).  The
reference's tensor-by-tensor count is the published size, and the TP x
FSDP step the port had before still gives the frozen reference's
schedule byte for byte.  The file's top level is the published
config, the same as the `model` the cell runs.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from perfbench_tiny import REPO

from perfbench import grid as G
from perfbench.reference import derivations
from perfbench.reference.collective import collective_workload as ref_workload
from perfbench.reference.topology import build as ref_build

CONFIG = json.loads((REPO / "perfbench" / "configs"
                     / "deepseek-v3-n256-organic.json").read_text())
QWEN = json.loads((REPO / "perfbench" / "configs"
                   / "collectives-n64-organic.json").read_text())


def _model():
    return G.model_sizes(CONFIG["model"])


def _assert_same(got, want):
    assert [p.label for p in got.phases] == [p.label for p in want.phases]
    for p, q in zip(got.phases, want.phases):
        assert p.duration == q.duration
        assert np.float64(p.intensity).tobytes() == \
            np.float64(q.intensity).tobytes()
        assert p.traffic.dtype == q.traffic.dtype
        assert np.array_equal(p.traffic, q.traffic)


@pytest.mark.parametrize("topology", CONFIG["topologies"])
@pytest.mark.parametrize("n,mesh", [(16, "tiny_mesh"), (256, "mesh")])
def test_schedule_equals_the_reference_derivation(n, mesh, topology):
    """Labels, durations, intensities and flow matrices of the program's
    schedule equal the reference derivation's, bit for bit."""
    import repro_torch.workloads as W
    from repro_torch.core import topology as T

    kw = G.step_kwargs(dict(CONFIG["step"], mesh=CONFIG["step"][mesh]))
    topo = T.build(topology, n, substrate="organic", chiplet_area_mm2=74.0)
    got = W.collective_workload(_model(), topo, **kw)
    want = ref_workload(_model(), ref_build(topology, n, substrate="organic",
                                            chiplet_area_mm2=74.0),
                        derivation=derivations.load("deepseek_v3"), **kw)
    _assert_same(got, want)
    assert [p.label for p in got.phases] == [
        "pp_fwd", "ep_dispatch", "ep_combine", "grad_dispatch",
        "grad_combine", "pp_bwd", "grad_reduce", "param_gather"]
    assert all(p.duration >= CONFIG["step"]["min_phase"]
               for p in got.phases)


def test_top_level_keys_are_the_model_the_cell_runs():
    """The file holds the published `config.json` at its top level, as
    the source gives it, and `model`, which the harness hands the
    program, is the same keys and values with only a name added."""
    model = dict(CONFIG["model"])
    assert model.pop("name") == "deepseek-v3"
    assert {k: CONFIG[k] for k in model} == model
    assert CONFIG["reduced"] == []


def test_reference_parameter_count_is_the_published_one():
    """DeepSeek-V3 is published as 671 B parameters with 37 B activated
    a token (arXiv:2412.19437, the MTP module left out): the reference's
    tensor-by-tensor count from the configuration's keys is 671.026 B
    and 37.552 B."""
    total, active = derivations.load("deepseek_v3").parameters(_model())
    assert total == pytest.approx(671.026e9, rel=1e-4)
    assert active == pytest.approx(37.552e9, rel=1e-4)


@pytest.mark.parametrize("n", [16, 64])
def test_tp_fsdp_step_is_the_frozen_workload(n):
    """The TP x FSDP step (the collectives cell's) gives the frozen
    reference's schedule byte for byte."""
    import repro_torch.workloads as W
    from repro_torch.core import topology as T

    model = G.model_sizes(QWEN["model"])
    kw = G.step_kwargs(QWEN["step"])
    if n == 16:
        kw["mesh_shape"] = {"data": 2, "model": 8}
    for name in ("mesh", "folded_octa_torus"):
        got = W.collective_workload(model, T.build(name, n), **kw)
        want = ref_workload(model, ref_build(name, n), **kw)
        _assert_same(got, want)
