"""A CPU rehearsal of the bf16 SSD kernel's decomposition and roundings.

`ssd_decomposed` follows `csrc/ssd_scan_bf16.cu` pass for pass (chunk
cumsum, C Bᵀ once per chunk, chunk states, state passing, chunk output)
with the kernel's operands: bf16 C and B, and float32 for the products
of f32 intermediates, which the kernel splits into two TF32 values each
(about 21 bits).  It is held against the port's plain versions, the JAX
package's oracles and its Pallas kernel in interpret mode, from the same
numpy inputs, at the tolerances the card tests use (1e-4 for f32, 3e-2
for bf16).  The kernel
itself is held against `ssd_ref` on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ref import ssd_naive as jax_ssd_naive  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_decomposed, ssd_naive, ssd_ref)

# (JAX dtype, torch dtype, tolerance)
ROUTES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# the ragged shapes of tests/test_kernels.py, a chunk that is no multiple
# of 32, the smoke config's head dim and chunk, three q tiles with a
# ragged last one and P, N past one tile, and the serving shape's chunk
# (P 64, N 128, chunk 256)
SHAPES = [(2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 8, 32), (3, 32, 8, 4, 4, 8),
          (1, 96, 2, 8, 8, 48), (2, 16, 4, 16, 16, 8),
          (1, 320, 2, 72, 136, 160), (1, 512, 2, 64, 128, 256)]


def _inputs(rng, b, t, h, p, n, dtype):
    """The same inputs as (jax, torch) lists; x, B and C in `dtype`, dt
    and a in float32 (the draws of tests/test_kernels.py)."""
    jdt, tdt = ROUTES[dtype][:2]
    arrs = (rng.normal(0, 1, (b, t, h, p)).astype(np.float32),
            rng.uniform(0.05, 0.9, (b, t, h)).astype(np.float32),
            -rng.uniform(0.3, 2.0, (h,)).astype(np.float32),
            rng.normal(0, 1, (b, t, n)).astype(np.float32),
            rng.normal(0, 1, (b, t, n)).astype(np.float32))
    typed = (True, False, False, True, True)
    jax_in = [jnp.asarray(a, jdt if c else jnp.float32)
              for a, c in zip(arrs, typed)]
    torch_in = [torch.from_numpy(a).to(tdt if c else torch.float32)
                for a, c in zip(arrs, typed)]
    return jax_in, torch_in


def _close(got, want, tol):
    want = want.float().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(ROUTES))
@pytest.mark.parametrize("b,t,h,p,n,chunk", SHAPES)
def test_decomposition_matches_references(b, t, h, p, n, chunk, dtype):
    jax_in, torch_in = _inputs(np.random.default_rng(11), b, t, h, p, n,
                               dtype)
    _, tdt, tol = ROUTES[dtype]
    y, s = ssd_decomposed(*torch_in, chunk)
    assert y.dtype == tdt and s.dtype == torch.float32
    wants = [ssd_ref(*torch_in, chunk)]
    # At chunk 256 in f32 the port's plain version and the JAX oracle
    # already differ by up to 4.5e-4 (sums of 256 terms in another order),
    # so the JAX references join at the sizes of tests/test_kernels.py and
    # in bf16; the interpreter walks every grid step, so it joins at the
    # small sizes only.
    if t <= 128 or dtype == "bfloat16":
        wants.append(jax_ssd_ref(*jax_in, chunk))
    if t <= 128:
        wants.append(ssd_scan_pallas(*jax_in, chunk=chunk, interpret=True))
    for want_y, want_s in wants:
        _close(y, want_y, tol)
        _close(s, want_s, tol)


@pytest.mark.parametrize("dtype", list(ROUTES))
def test_decomposition_matches_recurrence(dtype):
    """Against the per-token recurrence, the definition, at several chunk
    sizes (the recurrence keeps y in f32 until its last cast)."""
    jax_in, torch_in = _inputs(np.random.default_rng(12), 2, 48, 3, 4, 5,
                               dtype)
    tol = ROUTES[dtype][2]
    yn, sn = ssd_naive(*torch_in)
    jyn, jsn = jax_ssd_naive(*jax_in)
    for chunk in (4, 12, 16, 48):
        y, s = ssd_decomposed(*torch_in, chunk)
        for want_y, want_s in ((yn, sn), (jyn, jsn)):
            _close(y, want_y, tol)
            _close(s, want_s, tol)


@pytest.mark.parametrize("dtype", list(ROUTES))
def test_decomposition_strong_decay_stays_finite(dtype):
    """a = -60: exp(cum_q - cum_k) above the diagonal overflows to inf; the
    decomposition selects it away, as the kernel never takes it."""
    _, (x, dt, a, bm, cm) = _inputs(np.random.default_rng(5), 1, 64, 2, 4,
                                    4, dtype)
    a = torch.tensor([-60.0, -0.5])
    tol = ROUTES[dtype][2]
    y, s = ssd_decomposed(x, dt, a, bm, cm, 32)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    yn, sn = ssd_naive(x, dt, a, bm, cm)
    _close(y, yn, tol)
    _close(s, sn, tol)


def test_decomposition_keeps_outputs_near_zero():
    """bf16 inputs at the serving shape's chunk: an output near 0 sums
    terms that cancel, and the decomposition (the kernel's passes, its
    products near float32) keeps it within 5e-3 of the f64 evaluation, as
    the plain version does."""
    _, args = _inputs(np.random.default_rng(23), 1, 512, 4, 64, 128,
                      "bfloat16")
    y, _ = ssd_decomposed(*args, 256)
    y64, _ = ssd_ref(*(v.double() for v in args), 256)
    small = y64.abs() < 1
    assert int(small.sum()) > 1000
    assert float((y.double() - y64).abs()[small].max()) <= 5e-3
