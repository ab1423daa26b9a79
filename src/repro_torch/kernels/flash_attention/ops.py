"""Public wrapper of the flash-attention kernels: [B, T, H, hd] attention
with grouped KV heads.

`flash_attention` checks its inputs, then on a CUDA tensor launches the
hand-written kernel of the input's dtype on PyTorch's current stream, and
on a CPU tensor computes the plain version (`flash_attention_plain`).
The route is chosen by dtype, never by failure:

  bfloat16  `csrc/flash_attention_bf16.cu`: wgmma on the tensor cores,
            K/V tiles through a TMA ring; P is rounded to bf16 as the
            operand of P V (as the model's plain bf16 path does)
  float32   `csrc/flash_attention.cu`: exact float32 FMAs on the CUDA
            cores, to meet the 2e-5 / 1e-3 tolerances float32 is held to

Both take hd in {16, 32, 64, 128, 256} (any other hd raises) and Tq,
Tk multiples of 64 (the bf16 kernel's q tile per warpgroup and key tile;
its TMA also needs 16-byte aligned inputs).  A CUDA input never falls back: an input the
kernel does not take, a build failure or a launch failure raises.
`flash_attention.launches` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary
from .ref import attention_ref

TILE = 64                        # q and k rows per tile of both kernels
HEAD_DIMS = (16, 32, 64, 128, 256)
_CSRC = Path(__file__).resolve().parent / "csrc"
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# the kernel of each input dtype
LIBS = {
    torch.bfloat16: CudaLibrary(_CSRC / "flash_attention_bf16.cu",
                                "flash_attention_bf16",
                                "flash_attention_bf16_launch", _ARGS),
    torch.float32: CudaLibrary(_CSRC / "flash_attention.cu",
                               "flash_attention", "flash_attention_launch",
                               _ARGS),
}


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, T, H, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} q heads do not group over {k.shape[2]} kv "
                         f"heads")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """The plain version on any device: KV heads repeated to the q heads
    (head h reads kv head h // g, as `jnp.repeat` does), then
    `attention_ref` per (batch, head)."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    qb = q.transpose(1, 2).reshape(b * h, tq, hd)
    kb = k.transpose(1, 2).reshape(b * h, tk, hd)
    vb = v.transpose(1, 2).reshape(b * h, tk, hd)
    ob = attention_ref(qb, kb, vb, causal=causal, window=window)
    return ob.reshape(b, h, tq, hd).transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: [B, Tq, H, hd]; k, v: [B, Tk, KV, hd] with H a multiple of KV
    -> [B, Tq, H, hd] in q's dtype.  `window` (None or > 0) keeps the
    keys with q_pos - k_pos < window."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if q.dtype not in LIBS:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes hd in {HEAD_DIMS}, "
                         f"not {hd}")
    if tq % TILE or tk % TILE:
        raise ValueError(f"flash_attention kernel needs Tq and Tk multiples "
                         f"of {TILE}, got {tq} and {tk}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs contiguous inputs")
    if window is not None and window <= 0:
        raise ValueError(f"window must be None or positive, got {window}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention bf16 kernel (TMA) needs 16-byte "
                         "aligned inputs")
    launch = LIBS[q.dtype].launcher()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, tq, tk, h, kvh, hd, int(causal), int(window or 0),
                    stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

