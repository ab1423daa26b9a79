"""The port's SSD scan plain versions on the CPU, held against the JAX
package's Pallas kernel in interpret mode and its oracles, on the shapes
and tolerances of tests/test_kernels.py.  The CUDA kernel is held against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ref import ssd_naive as jax_ssd_naive  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_core, ssd_naive)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(rng, b, t, h, p, n, dtype="float32"):
    """The same inputs as numpy float32, then as (jax, torch) pairs; x, B
    and C in `dtype`, dt and a in float32."""
    jdt, tdt, _ = DTYPES[dtype]
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
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (2, 64, 4, 8, 16, 16),
    (1, 128, 2, 16, 8, 32),
    (3, 32, 8, 4, 4, 8),
])
def test_ssd_matches_pallas_and_ref(b, t, h, p, n, chunk, dtype):
    """The port's chunked core and its wrapper (CPU: the plain version)
    against the Pallas kernel (interpret mode) and the jnp oracle."""
    jax_in, torch_in = _inputs(np.random.default_rng(3), b, t, h, p, n, dtype)
    yk, sk = ssd_scan_pallas(*jax_in, chunk=chunk, interpret=True)
    yr, sr = jax_ssd_ref(*jax_in, chunk)
    tol = DTYPES[dtype][2]
    before = ops.ssd_scan.launches
    for y, s in (ssd_chunked_core(*torch_in, chunk),
                 ops.ssd_scan(*torch_in, chunk=chunk)):
        assert y.dtype == DTYPES[dtype][1] and s.dtype == torch.float32
        for want_y, want_s in ((yk, sk), (yr, sr)):
            _close(y, want_y, tol)
            _close(s, want_s, tol)
    assert ops.ssd_scan.launches == before           # no kernel on the CPU


def test_chunked_core_matches_naive():
    jax_in, torch_in = _inputs(np.random.default_rng(2), 2, 32, 3, 4, 5)
    yn, sn = ssd_naive(*torch_in)
    jyn, jsn = jax_ssd_naive(*jax_in)
    _close(yn, jyn, 2e-5)
    _close(sn, jsn, 2e-5)
    for chunk in (4, 8, 16, 32):
        y, s = ssd_chunked_core(*torch_in, chunk)
        np.testing.assert_allclose(y.numpy(), yn.numpy(), atol=2e-5,
                                   rtol=2e-4)
        np.testing.assert_allclose(s.numpy(), sn.numpy(), atol=2e-5,
                                   rtol=2e-4)


def test_chunked_core_in_float64():
    """Float64 inputs run the plain version in float64 (the precision
    reference of the f32 kernel at the serving shape): it then equals the
    recurrence to float64 rounding."""
    _, torch_in = _inputs(np.random.default_rng(4), 2, 32, 3, 4, 5)
    in64 = [v.double() for v in torch_in]
    y, s = ssd_chunked_core(*in64, 8)
    yn, sn = ssd_naive(*in64)
    assert y.dtype == s.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), yn.double().numpy(), atol=1e-5,
                               rtol=1e-5)
    y32, _ = ssd_chunked_core(*torch_in, 8)
    np.testing.assert_allclose(y32.double().numpy(), y.numpy(), atol=2e-5,
                               rtol=2e-4)


def test_strong_decay_stays_finite():
    """With dt * a large, exp(cum_q - cum_k) above the chunk's diagonal
    overflows to inf; the plain version masks it out before the exp
    (never multiplies it by a 0 mask), so y stays finite and equals the
    recurrence."""
    _, (x, dt, a, bm, cm) = _inputs(np.random.default_rng(5), 1, 64, 2, 4, 4)
    a = torch.tensor([-60.0, -0.5])
    y, s = ssd_chunked_core(x, dt, a, bm, cm, 32)
    yn, sn = ssd_naive(x, dt, a, bm, cm)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(y.numpy(), yn.numpy(), atol=2e-5, rtol=2e-4)


def test_wrapper_checks_its_inputs():
    _, (x, dt, a, bm, cm) = _inputs(np.random.default_rng(0), 1, 16, 2, 4, 4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(x, dt, a, bm, cm, chunk=5)
    with pytest.raises(ValueError, match="dt must be"):
        ops.ssd_scan(x, dt[:, :8], a, bm, cm, chunk=8)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x, dt.double(), a, bm, cm, chunk=8)
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.ssd_scan(x, dt, a, bm.to(torch.bfloat16), cm, chunk=8)
    assert ops.smem_bytes(64, 128, 256) <= ops.MAX_SMEM


@pytest.mark.parametrize("grad_input", range(5))
def test_wrapper_refuses_autograd(grad_input):
    """The kernel has no backward (neither has the JAX package's): with
    grad enabled an input that requires grad raises, on the CPU too,
    where the plain version would otherwise differentiate; without grad,
    or under no_grad, the wrapper runs."""
    _, args = _inputs(np.random.default_rng(0), 1, 16, 2, 4, 4)
    args[grad_input].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_scan(*args, chunk=8)
    with torch.no_grad():
        y, s = ops.ssd_scan(*args, chunk=8)
    assert y.grad_fn is None and torch.isfinite(s).all()
