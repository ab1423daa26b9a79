"""The CUDA `netstep` kernel's warp layout, rehearsed on the CPU.

`netstep_lanes` computes the allocation lane by lane as
`csrc/netstep.cu` does: R = 32 // PI routers per warp, padding lanes that
request nothing, match keys, and the winner found in the group's lane
mask (shifted to the router's first lane: the first rival at or after
rr_port mod PI, else the first).  It must equal the plain version
`netstep_ref` bit for bit for every router width the kernel takes (PI up
to 32), for the vector-load widths V in {1, 2, 4, 8} and the generic
V = 3, on batches whose N is no multiple of R, so that warps straddle
rows with different rr pairs.  The kernel itself is held against
`netstep_ref` on the card (tests/test_torch_cuda.py, chip_smoke.py), and
`netstep_ref` against the JAX package on these same inputs
(tests/test_torch_netstep.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.netstep.ref import netstep_lanes, netstep_ref  # noqa: E402

PIS = (1, 2, 5, 7, 8, 15, 16, 17, 31, 32)
VS = (1, 2, 3, 4, 8)


@pytest.mark.parametrize("v", VS)
@pytest.mark.parametrize("pi", PIS)
def test_lanes_equal_plain_version(pi, v):
    rng = np.random.default_rng(100 * pi + v)
    # N = 13 is no multiple of R = 32 // PI > 1 (PI <= 16), so warps
    # straddle rows; slots run one past [0, PI) on both sides and some
    # ineligible VCs carry a slot, so every branch of phase a and b is hit
    shape = (3, 13, pi, v)
    op_slot = rng.integers(-2, pi + 1, shape).astype(np.int32)
    eligible = rng.uniform(size=shape) < 0.6
    rr_vc = rng.integers(-40, 1000, 3).astype(np.int32)
    rr_port = rng.integers(-40, 1000, 3).astype(np.int32)
    args = [torch.from_numpy(a) for a in (op_slot, eligible, rr_vc, rr_port)]
    got = netstep_lanes(*args)
    want = netstep_ref(*args)
    for g, w, name in zip(got, want, ("win_mask", "vc_choice", "out_req")):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    # the batch has winners to arbitrate, not only empty ports
    assert want[0].any()
