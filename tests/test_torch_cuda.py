"""The CUDA `netstep` kernel and the simulator on the card.  Every test
here needs an NVIDIA GPU and nvcc (marker `requires_cuda`) and skips
without one; on such a machine run

    python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

This file imports only torch, numpy and the port, so it runs where the
JAX package is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core import topology as T, traffic as TR  # noqa: E402
from repro_torch.core.routing import build_routing  # noqa: E402
from repro_torch.kernels.netstep.ops import netstep  # noqa: E402
from repro_torch.kernels.netstep.ref import netstep_ref  # noqa: E402

pytestmark = pytest.mark.requires_cuda

HETERO = [("mesh", 16), ("folded_hexa_torus", 36), ("honeycomb_mesh", 16),
          ("octamesh", 25)]
RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _inputs(rng, shape, device):
    pi = shape[-2]
    op_slot = rng.integers(-1, pi, shape).astype(np.int32)
    eligible = (rng.uniform(size=shape) < 0.5) & (op_slot >= 0)
    return (torch.from_numpy(op_slot).to(device),
            torch.from_numpy(eligible).to(device))


def _assert_kernel_equals_plain(op_slot, eligible, rr_vc, rr_port):
    got = netstep(op_slot, eligible, rr_vc, rr_port)
    want = netstep_ref(op_slot, eligible, rr_vc, rr_port)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("rr", [0, 3, 11])
@pytest.mark.parametrize("n,pi,v", [(16, 5, 4), (100, 7, 4), (64, 31, 2)])
def test_kernel_equals_plain(cuda, n, pi, v, rr):
    op_slot, eligible = _inputs(np.random.default_rng(4), (1, n, pi, v), cuda)
    rr_t = torch.tensor([rr], dtype=torch.int32, device=cuda)
    _assert_kernel_equals_plain(op_slot, eligible, rr_t, rr_t)


@pytest.mark.parametrize("seed", range(8))
def test_kernel_equals_plain_random_batches(cuda, seed):
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(1, 9)), int(rng.integers(1, 300)),
             int(rng.integers(1, 33)), int(rng.integers(1, 9)))
    op_slot, eligible = _inputs(rng, shape, cuda)
    rr_vc = torch.from_numpy(rng.integers(0, 999, shape[0]).astype(
        np.int32)).to(cuda)
    rr_port = torch.from_numpy(rng.integers(0, 999, shape[0]).astype(
        np.int32)).to(cuda)
    _assert_kernel_equals_plain(op_slot, eligible, rr_vc, rr_port)


def test_kernel_counts_launches_and_rejects_wide_routers(cuda):
    op_slot, eligible = _inputs(np.random.default_rng(0), (2, 8, 5, 4), cuda)
    rr = torch.zeros((2,), dtype=torch.int32, device=cuda)
    before = netstep.launches
    netstep(op_slot, eligible, rr, rr)
    assert netstep.launches == before + 1
    wide, wide_el = _inputs(np.random.default_rng(0), (2, 8, 33, 4), cuda)
    with pytest.raises(ValueError, match="PI <= 32"):
        netstep(wide, wide_el, rr, rr)


def test_hash_bits_on_card_equal_cpu(cuda):
    t = torch.arange(0, 70_000, 997, dtype=torch.int64).view(-1, 1)
    nodes = torch.arange(300, dtype=torch.int64)
    for stream in (0, 1, 2):
        cpu = sim._node_bits(7, t, nodes, stream)
        gpu = sim._node_bits(7, t.to(cuda), nodes.to(cuda), stream)
        assert torch.equal(gpu.cpu(), cpu)


def test_simulator_kernel_equals_plain_and_cpu(cuda):
    specs = []
    for name, n in HETERO:
        r = build_routing(T.build(name, n))
        specs.append(sim.make_spec(r, TR.uniform(r.topo)))
    rates = np.array([0.05, 0.15, 0.3, 0.6], np.float32)
    cfg = sim.SimConfig(cycles=300, warmup=100)
    before = netstep.launches
    kernel = sim.run_batch(specs, rates, cfg, device=cuda)
    assert netstep.launches - before == cfg.cycles
    plain = sim.run_batch(specs, rates, cfg._replace(alloc="torch"),
                          device=cuda)
    cpu = sim.run_batch(specs, rates, cfg, device="cpu")
    for k, p, c in zip(kernel, plain, cpu):
        for key in RAW:
            np.testing.assert_array_equal(k[key], p[key], err_msg=key)
            np.testing.assert_array_equal(k[key], c[key], err_msg=key)
