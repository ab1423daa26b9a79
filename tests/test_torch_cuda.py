"""The port's CUDA kernels (`netstep`, `flash_attention`, `ssd_scan`), the
simulator and the LM serving path on the card.  Every test
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.netstep.ops import netstep  # noqa: E402
from repro_torch.kernels.netstep.ref import netstep_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.models import Model  # noqa: E402

pytestmark = pytest.mark.requires_cuda

HETERO = [("mesh", 16), ("folded_hexa_torus", 36), ("honeycomb_mesh", 16),
          ("octamesh", 25)]
RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.parametrize("v", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("pi", [1, 2, 5, 7, 8, 15, 16, 17, 31, 32])
def test_kernel_equals_plain_warp_layouts(cuda, pi, v):
    """Every router width (R = 32 // PI routers per warp), the vector-load
    widths V in {1, 2, 4, 8} and the generic V = 3, on rows of N = 13
    (no multiple of R > 1, so warps straddle rows with different rr
    pairs), with slots outside [0, PI): the cases of
    tests/test_torch_netstep_lanes.py through the kernel."""
    rng = np.random.default_rng(100 * pi + v)
    shape = (3, 13, pi, v)
    op_slot = torch.from_numpy(
        rng.integers(-2, pi + 1, shape).astype(np.int32)).to(cuda)
    eligible = torch.from_numpy(rng.uniform(size=shape) < 0.6).to(cuda)
    rr_vc, rr_port = (torch.from_numpy(rng.integers(-40, 1000, 3).astype(
        np.int32)).to(cuda) for _ in range(2))
    _assert_kernel_equals_plain(op_slot, eligible, rr_vc, rr_port)


@pytest.mark.parametrize("shape", [(40, 1, 7, 4), (9, 1, 2, 3),
                                   (7, 1000, 5, 4), (3, 4099, 31, 2)])
def test_kernel_finds_each_routers_row(cuda, shape):
    """The kernel finds a router's row by a multiply-high (N > 1) or
    takes the router itself (N = 1); rows with their own rr pairs."""
    rng = np.random.default_rng(sum(shape))
    op_slot, eligible = _inputs(rng, shape, cuda)
    rr_vc, rr_port = (torch.from_numpy(rng.integers(0, 999, shape[0]).astype(
        np.int32)).to(cuda) for _ in range(2))
    _assert_kernel_equals_plain(op_slot, eligible, rr_vc, rr_port)


def test_kernel_rejects_misaligned_inputs_and_takes_empty_ones(cuda):
    """The vector loads need aligned bases: a view at a storage offset
    raises, except at a V the kernel reads element by element.  An empty
    input returns empty outputs and launches nothing."""
    rng = np.random.default_rng(3)
    op_slot, eligible = _inputs(rng, (2, 9, 7, 4), cuda)
    rr = torch.tensor([1, 5], dtype=torch.int32, device=cuda)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    with pytest.raises(ValueError, match="aligned"):
        netstep(shifted(op_slot), eligible, rr, rr)
    with pytest.raises(ValueError, match="aligned"):
        netstep(op_slot, shifted(eligible), rr, rr)
    op3, el3 = _inputs(rng, (2, 9, 7, 3), cuda)
    _assert_kernel_equals_plain(shifted(op3), shifted(el3), rr, rr)
    for shape in ((0, 9, 7, 4), (2, 0, 7, 4), (2, 9, 0, 4), (2, 9, 7, 0)):
        before = netstep.launches
        rr_b = torch.zeros((shape[0],), dtype=torch.int32, device=cuda)
        win, vc, req = netstep(
            torch.zeros(shape, dtype=torch.int32, device=cuda),
            torch.zeros(shape, dtype=torch.bool, device=cuda), rr_b, rr_b)
        assert netstep.launches == before
        assert win.shape == shape and win.dtype == torch.bool
        assert vc.shape == req.shape == shape[:3]
        assert vc.dtype == req.dtype == torch.int32


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


# ---------------------------------------------------------------------
# flash attention and SSD scan against their plain versions
# ---------------------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("tq,tk,causal,window", [
    (128, 128, True, None), (256, 256, True, None), (128, 256, False, None),
    (256, 256, True, 128), (128, 128, True, 64)])
def test_flash_kernel_matches_plain(cuda, tq, tk, causal, window, hd, dtype):
    rng = np.random.default_rng(0)
    q = _randn(rng, (2, tq, 4, hd), dtype, cuda)
    k = _randn(rng, (2, tk, 2, hd), dtype, cuda)
    v = _randn(rng, (2, tk, 2, hd), dtype, cuda)
    before = fops.flash_attention.launches
    got = fops.flash_attention(q, k, v, causal=causal, window=window)
    assert fops.flash_attention.launches == before + 1
    want = fops.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_matches_plain_at_serving_shape(cuda):
    """qwen3-1.7b's prefill: batch 4, prompt 1024, 16 q heads over 8 kv
    heads of 128, bf16, causal: the tensor-core route."""
    rng = np.random.default_rng(1)
    q = _randn(rng, (4, 1024, 16, 128), torch.bfloat16, cuda)
    k = _randn(rng, (4, 1024, 8, 128), torch.bfloat16, cuda)
    v = _randn(rng, (4, 1024, 8, 128), torch.bfloat16, cuda)
    got = fops.flash_attention(q, k, v, causal=True)
    want = fops.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_f32_kernel_matches_plain_at_serving_shape(cuda):
    """The same shape in float32: the CUDA-core route, exact f32 products."""
    rng = np.random.default_rng(9)
    q = _randn(rng, (4, 1024, 16, 128), torch.float32, cuda)
    k = _randn(rng, (4, 1024, 8, 128), torch.float32, cuda)
    v = _randn(rng, (4, 1024, 8, 128), torch.float32, cuda)
    got = fops.flash_attention(q, k, v, causal=True)
    want = fops.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_at_gemma3_shape(cuda, dtype):
    """gemma3-1b's prefill at batch 1: 4 q heads over 1 kv head of 256,
    prompt 2048, causal, global (no window) and local (window 1024)."""
    rng = np.random.default_rng(10)
    q = _randn(rng, (1, 2048, 4, 256), dtype, cuda)
    k = _randn(rng, (1, 2048, 1, 256), dtype, cuda)
    v = _randn(rng, (1, 2048, 1, 256), dtype, cuda)
    tol = FLASH_TOL[dtype]
    for window in (None, 1024):
        got = fops.flash_attention(q, k, v, causal=True, window=window)
        want = fops.flash_attention_plain(q, k, v, causal=True, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("h,kv,tq", [(3, 1, 192), (6, 2, 64), (4, 4, 320)])
def test_flash_bf16_kernel_pairs_heads_and_tiles(cuda, h, kv, tq):
    """The bf16 kernel's two warpgroups share a block: two q heads of one
    kv head when H / KV is even, else two q tiles of one head (an odd tile
    count leaves the last block one tile)."""
    rng = np.random.default_rng(8)
    q = _randn(rng, (2, tq, h, 64), torch.bfloat16, cuda)
    k = _randn(rng, (2, tq, kv, 64), torch.bfloat16, cuda)
    v = _randn(rng, (2, tq, kv, 64), torch.bfloat16, cuda)
    for window in (None, 96):
        got = fops.flash_attention(q, k, v, causal=True, window=window)
        want = fops.flash_attention_plain(q, k, v, causal=True, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    rng = np.random.default_rng(2)
    q = _randn(rng, (1, 128, 2, 64), torch.float32, cuda)
    # hd 48 is still refused: the kernels take 16, 32, 64, 128 and 256
    with pytest.raises(ValueError, match=r"hd in \(16, 32, 64, 128, 256\), "
                                         r"not 48"):
        fops.flash_attention(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiples of 64"):
        fops.flash_attention(q[:, :96], q[:, :96], q[:, :96])
    wide = _randn(rng, (1, 128, 2, 128), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_attention(wide[..., ::2], wide[..., ::2], wide[..., ::2])
    odd = _randn(rng, (1, 128, 2, 64), torch.bfloat16, cuda).flatten()
    shifted = odd[1:1 + 128 * 2 * 32].view(1, 128, 2, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fops.flash_attention(shifted, shifted, shifted)


def _ssd_inputs(rng, b, t, h, p, n, dtype, device):
    x = _randn(rng, (b, t, h, p), dtype, device)
    dt = torch.from_numpy(rng.uniform(0.05, 0.9, (b, t, h)).astype(
        np.float32)).to(device)
    a = -torch.from_numpy(rng.uniform(0.3, 2.0, (h,)).astype(
        np.float32)).to(device)
    return (x, dt, a, _randn(rng, (b, t, n), dtype, device),
            _randn(rng, (b, t, n), dtype, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 8, 32), (3, 32, 8, 4, 4, 8),
    (1, 512, 4, 64, 128, 256)])
def test_ssd_kernel_matches_plain(cuda, b, t, h, p, n, chunk, dtype):
    args = _ssd_inputs(np.random.default_rng(3), b, t, h, p, n, dtype, cuda)
    before = sops.ssd_scan.launches
    y, s = sops.ssd_scan(*args, chunk=chunk)
    assert sops.ssd_scan.launches == before + 1
    yr, sr = sops.ssd_ref(*args, chunk)
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype]
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(s, sr, atol=tol, rtol=tol)


def test_ssd_kernel_stays_finite_under_strong_decay(cuda):
    """exp(cum_q - cum_k) above the diagonal would overflow here; the
    kernel never takes it."""
    x, dt, a, bm, cm = _ssd_inputs(np.random.default_rng(5), 1, 64, 2, 4, 4,
                                   torch.float32, cuda)
    a = torch.tensor([-60.0, -0.5], device=cuda)
    y, s = sops.ssd_scan(x, dt, a, bm, cm, chunk=32)
    yr, sr = sops.ssd_ref(x, dt, a, bm, cm, 32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)


def test_ssd_bf16_kernel_stays_finite_under_strong_decay(cuda):
    """The same through the tensor-core route."""
    x, dt, a, bm, cm = _ssd_inputs(np.random.default_rng(5), 1, 64, 2, 4, 4,
                                   torch.bfloat16, cuda)
    a = torch.tensor([-60.0, -0.5], device=cuda)
    y, s = sops.ssd_scan(x, dt, a, bm, cm, chunk=32)
    yr, sr = sops.ssd_ref(x, dt, a, bm, cm, 32)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y.float(), yr.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(s, sr, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (1, 96, 2, 8, 8, 48), (2, 16, 4, 16, 16, 8), (2, 40, 3, 12, 20, 20),
    (1, 320, 2, 72, 136, 160), (4, 1024, 64, 64, 128, 256)])
def test_ssd_bf16_kernel_takes_any_chunk(cuda, b, t, h, p, n, chunk):
    """The tensor-core route tiles Q, P and N itself (zero-filled ragged
    tiles): chunks that are no multiple of 32, the smoke config (P 16,
    chunk 8), P and N past one tile, and mamba2-1.3b's prefill shape."""
    args = _ssd_inputs(np.random.default_rng(13), b, t, h, p, n,
                       torch.bfloat16, cuda)
    before = sops.ssd_scan.launches
    y, s = sops.ssd_scan(*args, chunk=chunk)
    assert sops.ssd_scan.launches == before + 1
    yr, sr = sops.ssd_ref(*args, chunk)
    torch.testing.assert_close(y.float(), yr.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(s, sr, atol=3e-2, rtol=3e-2)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    """The f32 route keeps its tiles (chunk <= 32 or a multiple of 32) and
    its shared memory; the bf16 route takes both shapes."""
    x, dt, a, bm, cm = _ssd_inputs(np.random.default_rng(6), 1, 96, 2, 8, 8,
                                   torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sops.ssd_scan(x.half(), dt, a, bm.half(), cm.half(), chunk=32)
    with pytest.raises(ValueError, match="multiple of 32"):
        sops.ssd_scan(x, dt, a, bm, cm, chunk=48)
    with pytest.raises(ValueError, match="contiguous"):
        sops.ssd_scan(x, dt, a, bm.transpose(1, 2).contiguous()
                      .transpose(1, 2), cm, chunk=32)
    big = _ssd_inputs(np.random.default_rng(7), 1, 256, 1, 256, 256,
                      torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sops.ssd_scan(*big, chunk=256)
    bf = torch.bfloat16
    sops.ssd_scan(x.to(bf), dt, a, bm.to(bf), cm.to(bf), chunk=48)
    sops.ssd_scan(big[0].to(bf), big[1], big[2], big[3].to(bf),
                  big[4].to(bf), chunk=256)
    with pytest.raises(ValueError, match="contiguous"):
        sops.ssd_scan(x.to(bf), dt, a, bm.to(bf).transpose(1, 2)
                      .contiguous().transpose(1, 2), cm.to(bf), chunk=32)


@pytest.mark.parametrize("arch,t,flash,ssd", [
    ("qwen3-1.7b", 128, 2, 0), ("mamba2-1.3b", 16, 0, 2)])
def test_prefill_launches_each_layers_kernel(cuda, arch, t, flash, ssd):
    """With the kernel flags on, every layer's prefill goes through its
    kernel once, and the logits agree with the plain path's."""
    import dataclasses
    cfg = get_config(arch, smoke=True)
    model = Model(dataclasses.replace(
        cfg, use_flash_kernel=True, use_ssd_kernel=True)).init(
        torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, t))).to(cuda)
    before = (fops.flash_attention.launches, sops.ssd_scan.launches)
    logits, _ = model.prefill(tokens)
    after = (fops.flash_attention.launches, sops.ssd_scan.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (flash, ssd)
    model.cfg = dataclasses.replace(model.cfg, use_flash_kernel=False,
                                    use_ssd_kernel=False)
    plain, _ = model.prefill(tokens)
    torch.testing.assert_close(logits.float(), plain.float(), atol=0.08,
                               rtol=0.08)
