"""The port's flash-attention plain versions on the CPU, held against the
JAX package's oracle (`repro.kernels.flash_attention.ref.attention_ref`)
on the cases and tolerances of tests/test_kernels.py.  The Pallas kernel
itself is not the oracle: it does not run under the installed jax.  The
CUDA kernel is held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, attention_tiles_ref)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(x32, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x32, jdt), torch.from_numpy(x32).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tq,tk,causal,window", [
    (128, 128, True, None),
    (256, 256, True, None),
    (128, 256, False, None),
    (256, 256, True, 128),
    (128, 128, True, 64),
])
def test_attention_ref_matches_reference(tq, tk, causal, window, dtype):
    rng = np.random.default_rng(0)
    bh, hd = 3, 128
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((bh, tq, hd), (bh, tk, hd), (bh, tk, hd)))
    (jq, tq_), (jk, tk_), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = attention_ref(tq_, tk_, tv, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1]
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("hd", [16, 128, 256])
@pytest.mark.parametrize("tq,tk,causal,window", [
    (128, 128, True, None),
    (256, 256, True, None),
    (128, 256, False, None),
    (256, 256, True, 128),
    (128, 128, True, 64),
])
def test_bf16_kernel_numerics_match_reference(tq, tk, causal, window, hd):
    """A CPU rehearsal of the bf16 tensor-core kernel: its tile-by-tile
    online softmax with P rounded to bf16 before P V stays within the bf16
    tolerance of the exact references, the port's and the JAX package's."""
    rng = np.random.default_rng(3)
    bh = 3
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((bh, tq, hd), (bh, tk, hd), (bh, tk, hd)))
    (jq, tq_), (jk, tk_), (jv, tv) = (_both(a, "bfloat16") for a in (q, k, v))
    got = attention_tiles_ref(tq_, tk_, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    ours = attention_ref(tq_, tk_, tv, causal=causal, window=window)
    jax_ = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    for want in (ours.float().numpy(), np.asarray(jax_, np.float32)):
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("window", [None, 64])
def test_gqa_wrapper_on_cpu_matches_reference(window):
    """ops.flash_attention on CPU tensors is the plain version: kv head
    h // g for q head h, as `jnp.repeat` broadcasts in the JAX wrapper."""
    rng = np.random.default_rng(1)
    b, t, h, kv, hd = 2, 128, 4, 2, 128
    q = rng.normal(0, 1, (b, t, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32)
    before = ops.flash_attention.launches
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window)
    assert ops.flash_attention.launches == before     # no kernel on the CPU
    kr = jnp.repeat(jnp.asarray(k), h // kv, 2)
    vr = jnp.repeat(jnp.asarray(v), h // kv, 2)
    qb = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b * h, t, hd)
    kb = kr.transpose(0, 2, 1, 3).reshape(b * h, t, hd)
    vb = vr.transpose(0, 2, 1, 3).reshape(b * h, t, hd)
    want = jax_attention_ref(qb, kb, vb, causal=True, window=window) \
        .reshape(b, h, t, hd).transpose(0, 2, 1, 3)
    assert tuple(got.shape) == (b, t, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [None, 96, 200])
def test_plain_at_hd256_matches_reference(window, dtype):
    """gemma3-1b's head dim: the plain version, GQA 4:1, against the JAX
    package's oracle per (batch, head), with and without a window."""
    rng = np.random.default_rng(5)
    b, t, h, kv, hd = 1, 320, 4, 1, 256
    q = rng.normal(0, 1, (b, t, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32)
    (jq, tq_), (jk, tk_), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    got = ops.flash_attention_plain(tq_, tk_, tv, causal=True, window=window)
    kr, vr = jnp.repeat(jk, h // kv, 2), jnp.repeat(jv, h // kv, 2)
    want = jax_attention_ref(
        *(x.transpose(0, 2, 1, 3).reshape(b * h, t, hd)
          for x in (jq, kr, vr)), causal=True, window=window) \
        .reshape(b, h, t, hd).transpose(0, 2, 1, 3)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == q.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_wrapper_checks_its_inputs():
    q = torch.zeros((1, 128, 4, 16))
    k = torch.zeros((1, 128, 2, 16))
    with pytest.raises(ValueError, match=r"\[B, T, H, hd\]"):
        ops.flash_attention(q[0], k, k)
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(q, k, k[..., :8])
    with pytest.raises(ValueError, match="do not group"):
        ops.flash_attention(q, torch.zeros((1, 128, 3, 16)),
                            torch.zeros((1, 128, 3, 16)))
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.flash_attention(q, k, k.to(torch.bfloat16))
