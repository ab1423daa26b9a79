"""Public wrapper of the SSD scan kernels.

`ssd_scan` checks its inputs, then on a CUDA tensor launches the
hand-written kernel of x's dtype on PyTorch's current stream, and on a
CPU tensor computes the plain version (`ref.ssd_ref`).  The route is
chosen by dtype, never by failure:

  bfloat16  `csrc/ssd_scan_bf16.cu`: four kernels (cumsum, C Bᵀ once per
            chunk, the chunk states passed along the chunks, the
            chunk-parallel output) with bf16 tensor-core products, and
            TF32 ones on f32 operands split into hi + lo (about 21
            bits); any chunk size; float32 scratch allocated here
  float32   `csrc/ssd_scan.cu`: one block per (head, batch) walking the
            chunks, exact float32 FMAs (the 1e-4 tolerance float32 is held
            to); chunk <= 32 or a multiple of 32, and its shared memory
            must fit

A CUDA input never falls back: an input the kernel does not take, a
build failure or a launch failure raises.  `ssd_scan.launches` counts
wrapper calls that launch (one per layer), not CUDA kernels: a bf16 call
launches four.  The kernels are forward-only, as the JAX package's is:
with grad enabled, an input that requires grad raises on every device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary
from .ref import ssd_ref

TILE = 32                    # f32 kernel: q and k rows per tile (`kTile`)
MAX_SMEM = 232448            # bytes of shared memory one block may use
_CSRC = Path(__file__).resolve().parent / "csrc"
# the kernel of each input dtype
LIBS = {
    torch.bfloat16: CudaLibrary(
        _CSRC / "ssd_scan_bf16.cu", "ssd_scan_bf16", "ssd_scan_bf16_launch",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
    torch.float32: CudaLibrary(
        _CSRC / "ssd_scan.cu", "ssd_scan", "ssd_scan_launch",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
}


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Shared memory of one block of the f32 kernel, as `ssd_scan.cu` lays
    it out: the carried state, the chunk's dt and cumulative decay, the C
    and B tiles (rows padded to n + 1), the weighted x tile, the scores
    tile and the y tile, all float32."""
    t = min(TILE, chunk)
    return 4 * (n * p + 2 * chunk + 2 * t * (n + 1) + 2 * t * p
                + t * (t + 1))


def _check(x, dt, a, b_mat, c_mat, chunk):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, T, H, P], got {tuple(x.shape)}")
    bsz, t, h, _ = x.shape
    if tuple(dt.shape) != (bsz, t, h):
        raise ValueError(f"dt must be [{bsz}, {t}, {h}], got "
                         f"{tuple(dt.shape)}")
    if tuple(a.shape) != (h,):
        raise ValueError(f"a must be [{h}], got {tuple(a.shape)}")
    if b_mat.dim() != 3 or b_mat.shape[:2] != (bsz, t) or \
            b_mat.shape != c_mat.shape:
        raise ValueError(f"b_mat {tuple(b_mat.shape)} and c_mat "
                         f"{tuple(c_mat.shape)} must both be [{bsz}, {t}, N]")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32, got {dt.dtype}, {a.dtype}")
    if not x.dtype == b_mat.dtype == c_mat.dtype:
        raise TypeError(f"x, b_mat, c_mat dtypes differ: {x.dtype}, "
                        f"{b_mat.dtype}, {c_mat.dtype}")
    if chunk <= 0 or t % chunk:
        raise ValueError(f"T={t} must be a multiple of chunk={chunk}")
    devs = {v.device for v in (x, dt, a, b_mat, c_mat)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")


def ssd_scan(x, dt, a, b_mat, c_mat, *, chunk: int = 128):
    """x [B,T,H,P], dt [B,T,H] f32, a [H] f32, b_mat/c_mat [B,T,N] in x's
    dtype -> (y [B,T,H,P] in x's dtype, final_state [B,H,N,P] float32)."""
    _check(x, dt, a, b_mat, c_mat, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, dt, a, b_mat, c_mat)):
        raise RuntimeError(
            "ssd_scan has no backward (nor has the JAX package's "
            "kernel): call it under torch.no_grad(), or train with "
            "use_ssd_kernel=False")
    dev = x.device
    if dev.type == "cpu":
        return ssd_ref(x, dt, a, b_mat, c_mat, chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {dev}")
    if x.dtype not in LIBS:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    if x.dtype == torch.float32:
        if chunk > TILE and chunk % TILE:
            raise ValueError(f"ssd_scan f32 kernel needs chunk <= {TILE} or "
                             f"a multiple of {TILE}, got {chunk}")
        if smem_bytes(p, n, chunk) > MAX_SMEM:
            raise ValueError(f"ssd_scan f32 kernel: P={p}, N={n}, "
                             f"chunk={chunk} need {smem_bytes(p, n, chunk)} "
                             f"bytes of shared memory, more than {MAX_SMEM}")
    if not all(v.is_contiguous() for v in (x, dt, a, b_mat, c_mat)):
        raise ValueError("ssd_scan kernel needs contiguous inputs")
    launch = LIBS[x.dtype].launcher()
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    if x.numel() == 0:
        return y, state.zero_()
    ptrs = [v.data_ptr() for v in (x, dt, a, b_mat, c_mat, y, state)]
    shape = [bsz, t, h, p, n, chunk]
    if x.dtype == torch.bfloat16:
        # float32 scratch of the passes: the running decay, C Bᵀ of every
        # chunk (rows padded to 16 bytes) and each chunk's incoming state
        nc, ldcb = t // chunk, -(-chunk // 4) * 4
        f32 = dict(dtype=torch.float32, device=dev)
        scratch = (torch.empty((bsz, nc, h, chunk), **f32),
                   torch.empty((bsz, nc, chunk, ldcb), **f32),
                   torch.empty((bsz, nc, h, n, p), **f32))
        ptrs += [v.data_ptr() for v in scratch]
        shape.append(ldcb)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(*ptrs, *shape, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
