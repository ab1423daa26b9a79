"""The yardstick's peaks, and the bytes and operations the simulator's
work needs at a given shape.

`netstep_bound` is a frozen copy of `chip_smoke.netstep_bound` (commit
1dee169), with its peaks: one NVIDIA H100 SXM, 3.35 TB/s of HBM and 67
TFLOP/s of float32 outside the tensor cores (NVIDIA's data sheet).
`netstep_bytes` counts what `chip_smoke`'s `timing` phase counted for
it: every input read once and every output written once.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

#: bytes per element of the least state a cycle must move: a flit's
#: destination or timestamp, a credit count, a pointer, in 32 bits
STATE_WORD_BYTES = 4


def netstep_bound(shape, n_bytes):
    """(bound ms, bound_by, ops): every input read once and every output
    written once, over the memory rate; per input port V compare-selects
    of phase a, one compare per out slot in phase b and V stores (a lower
    bound on the operations), over the float32 rate."""
    b, n, pi, v = shape
    n_ops = b * n * pi * (3 * v + 3 * pi)
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n_ops / PEAK_OPS_PER_S
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_ops)


def netstep_bytes(shape) -> int:
    """Bytes of one allocation at [B, N, PI, V]: op_slot (int32) and
    eligible (bool) in, rr_vc and rr_port (int32 [B]) in; win_mask
    (bool) out, vc_choice and out_req (int32 [B, N, PI]) out."""
    b, n, pi, v = shape
    cells = b * n * pi * v
    return cells * 4 + cells + 2 * 4 * b + cells + 2 * 4 * b * n * pi


def cycle_state_words(n: int, p: int, c: int, d: int, n_vcs: int,
                      buf_depth: int) -> int:
    """32-bit words of the router state one row carries across a cycle
    at a spec's own shape (n nodes, p ports, c channels, ring depth d):
    the input buffers' flits (destination and timestamp) in n x (p+1)
    ports (the +1 is injection) x V VCs x B slots, each VC's head and
    count, the credits of n x p output ports x V, the link pipelines'
    flits (destination, timestamp, VC) in c x d slots, the credit
    pipelines' c x d x V counts, and the round-robin pointer."""
    ports_in = n * (p + 1) * n_vcs
    return (ports_in * buf_depth * 2 + ports_in * 2 + n * p * n_vcs
            + c * d * 3 + c * d * n_vcs + 1)


def cycle_state_bytes(n: int, p: int, c: int, d: int, n_vcs: int,
                      buf_depth: int) -> int:
    """The least bytes one cycle of one row must move: its state read
    once and written once."""
    return 2 * STATE_WORD_BYTES * cycle_state_words(n, p, c, d, n_vcs,
                                                    buf_depth)
