"""The port's `netstep` allocator on the CPU: its plain version equals the
JAX package's Pallas kernel (interpret mode) and `_alloc_jnp` exactly,
one router grid at a time and batched with per-row rotating priorities,
and it keeps the allocation invariants.  The CUDA kernel itself is held
against this plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.simulator import _alloc_jnp  # noqa: E402
from repro.kernels.netstep.netstep import netstep_pallas  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.netstep.ops import LIB, netstep  # noqa: E402
from repro_torch.kernels.netstep.ref import netstep_ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on one CPU; torch's
    per-process thread pool oversubscribes it (spinning OpenMP threads
    slow every worker several-fold), and these tests' ops are small, so
    they run on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _alloc_inputs(rng, shape):
    pi = shape[-2]
    op_slot = rng.integers(-1, pi, shape).astype(np.int32)
    eligible = (rng.uniform(size=shape) < 0.5) & (op_slot >= 0)
    return op_slot, eligible


def _port(op_slot, eligible, rr_vc, rr_port):
    """Port plain version on a numpy batch; numpy outputs."""
    out = netstep_ref(torch.from_numpy(op_slot), torch.from_numpy(eligible),
                      torch.as_tensor(rr_vc, dtype=torch.int32),
                      torch.as_tensor(rr_port, dtype=torch.int32))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("rr", [0, 3, 11, -37, 2 ** 31 - 1])
@pytest.mark.parametrize("n,pi,v", [(16, 5, 4), (100, 7, 4), (64, 31, 2),
                                    (9, 1, 1), (13, 17, 3), (16, 8, 8),
                                    (5, 32, 8)])
def test_netstep_ref_matches_pallas_and_jnp(n, pi, v, rr):
    """On the simulator's inputs (slots in [-1, PI), eligible only where a
    slot is named) and on the kernel tests' wider ones (slots -2 and PI,
    eligible regardless), at the V the CUDA kernel specialises and the
    generic V = 3, with negative and large rotating counters."""
    rng = np.random.default_rng(4)
    simulator = _alloc_inputs(rng, (n, pi, v))
    wide = (rng.integers(-2, pi + 1, (n, pi, v)).astype(np.int32),
            rng.uniform(size=(n, pi, v)) < 0.6)
    for op_slot, eligible in (simulator, wide):
        got = _port(op_slot[None], eligible[None], [rr], [rr])
        pallas = netstep_pallas(jnp.asarray(op_slot), jnp.asarray(eligible),
                                rr, interpret=True)
        jnp_out = _alloc_jnp(jnp.asarray(op_slot), jnp.asarray(eligible),
                             jnp.int32(rr), jnp.int32(rr))
        for g, p, j in zip(got, pallas, jnp_out):
            np.testing.assert_array_equal(g[0], np.asarray(p))
            np.testing.assert_array_equal(g[0], np.asarray(j))
            assert g.dtype == np.asarray(j).dtype


@pytest.mark.parametrize("v", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("pi", [1, 2, 5, 7, 8, 15, 16, 17, 31, 32])
def test_netstep_ref_matches_jnp_on_the_kernel_grid(pi, v):
    """The inputs of tests/test_torch_netstep_lanes.py and of the card's
    warp-layout test (same seed and draws): every router width, rows of
    N = 13 with their own rr pairs (negative ones too), slots outside
    [0, PI).  Row by row, `netstep_ref` equals `_alloc_jnp`, so the CUDA
    kernel held to `netstep_ref` there is held to the JAX package."""
    rng = np.random.default_rng(100 * pi + v)
    shape = (3, 13, pi, v)
    op_slot = rng.integers(-2, pi + 1, shape).astype(np.int32)
    eligible = rng.uniform(size=shape) < 0.6
    rr_vc = rng.integers(-40, 1000, 3).astype(np.int32)
    rr_port = rng.integers(-40, 1000, 3).astype(np.int32)
    got = _port(op_slot, eligible, rr_vc, rr_port)
    for i in range(shape[0]):
        want = _alloc_jnp(jnp.asarray(op_slot[i]), jnp.asarray(eligible[i]),
                          jnp.int32(rr_vc[i]), jnp.int32(rr_port[i]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i], np.asarray(w))


@pytest.mark.parametrize("pi", [2, 7, 31, 32])
def test_netstep_ref_batched_per_row_priorities(pi):
    """Rows with their own (rr_vc, rr_port) — the simulator's split
    counters (rr % V, rr % pi_spec) — each equal the reference run on
    that row alone."""
    rng = np.random.default_rng(pi)
    b, n, v = 6, 24, 4
    op_slot, eligible = _alloc_inputs(rng, (b, n, pi, v))
    rr_vc = rng.integers(0, 64, b)
    rr_port = rng.integers(0, 64, b)
    got = _port(op_slot, eligible, rr_vc, rr_port)
    for i in range(b):
        want = _alloc_jnp(jnp.asarray(op_slot[i]), jnp.asarray(eligible[i]),
                          jnp.int32(rr_vc[i]), jnp.int32(rr_port[i]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i], np.asarray(w))


@given(seed=st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_netstep_ref_allocation_invariants(seed):
    rng = np.random.default_rng(seed)
    b, n = int(rng.integers(1, 4)), int(rng.integers(4, 40))
    pi, v = int(rng.integers(2, 33)), int(rng.integers(1, 6))
    op_slot, eligible = _alloc_inputs(rng, (b, n, pi, v))
    win, vc, req = _port(op_slot, eligible, rng.integers(0, 99, b),
                         rng.integers(0, 99, b))
    # at most one winning VC per input port, and it was eligible
    assert (win.sum(axis=3) <= 1).all()
    assert (win <= eligible).all()
    # the winner is the chosen VC, and its request is the out slot
    won = win.any(axis=3)
    assert (np.take_along_axis(win, vc[..., None], 3)[..., 0] == won).all()
    assert (req[won] >= 0).all()
    # at most one winner per (row, router, output slot)
    for o in range(pi):
        assert (((op_slot == o) & win).sum(axis=(2, 3)) <= 1).all()
    # every requested slot is granted to someone (work conservation)
    for o in range(pi):
        asked = (req == o).any(axis=2)
        granted = (won & (req == o)).any(axis=2)
        assert (asked == granted).all()


def test_wrapper_on_cpu_is_the_plain_version_and_not_counted():
    rng = np.random.default_rng(1)
    op_slot, eligible = _alloc_inputs(rng, (3, 10, 5, 4))
    args = (torch.from_numpy(op_slot), torch.from_numpy(eligible),
            torch.tensor([0, 1, 2], dtype=torch.int32),
            torch.tensor([5, 4, 3], dtype=torch.int32))
    before = netstep.launches
    for g, w in zip(netstep(*args), netstep_ref(*args)):
        assert torch.equal(g, w)
    assert netstep.launches == before


def test_wrapper_checks_its_inputs():
    op = torch.zeros((2, 3, 4, 4), dtype=torch.int32)
    el = torch.zeros((2, 3, 4, 4), dtype=torch.bool)
    rr = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(TypeError, match="op_slot must be int32"):
        netstep(op.long(), el, rr, rr)
    with pytest.raises(TypeError, match="eligible must be bool"):
        netstep(op, el.int(), rr, rr)
    with pytest.raises(ValueError, match="eligible"):
        netstep(op, el[:, :2], rr, rr)
    with pytest.raises(ValueError, match="rr_port"):
        netstep(op, el, rr, rr[:1])
    with pytest.raises(ValueError, match=r"\[B, N, PI, V\]"):
        netstep(op[0], el[0], rr, rr)


def test_kernel_library_is_keyed_by_source(monkeypatch, tmp_path):
    path = LIB.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "kernels")
    assert path.name.startswith("netstep_") and path.suffix == ".so"
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.nvcc() == str(fake)
