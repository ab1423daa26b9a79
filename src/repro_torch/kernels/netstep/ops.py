"""Public wrapper of the `netstep` allocator.

`netstep` checks its inputs, then on a CUDA tensor launches the
hand-written kernel (`csrc/netstep.cu`) on PyTorch's current stream, and
on a CPU tensor computes the plain version (`ref.netstep_ref`).  A CUDA
input never falls back: an input the kernel does not take (PI or V above
32, a non-contiguous or misaligned tensor), a build failure or a launch
failure raises.  `netstep.launches` counts kernel launches (CPU calls are
not counted), so a run can show that its cycles went through the kernel.
A call on a stream that is capturing a CUDA graph launches nothing then:
it counts in `netstep.captured`, and whoever replays the graph adds its
launches to `netstep.launches`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary
from .ref import netstep_ref

MAX_LANES = 32   # a router's ports share a warp: PI and V each fit in one
LIB = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "netstep.cu", "netstep",
    "netstep_launch", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    + [ctypes.c_void_p])
# byte alignment the kernel's vector loads need of op_slot and eligible,
# by V (one port's V slots and V flags per load); any other V loads
# element by element
ALIGN = {1: (4, 1), 2: (8, 2), 4: (16, 4), 8: (16, 8)}


def _check(op_slot, eligible, rr_vc, rr_port):
    if op_slot.dim() != 4:
        raise ValueError(f"op_slot must be [B, N, PI, V], got "
                         f"{tuple(op_slot.shape)}")
    B = op_slot.shape[0]
    if op_slot.dtype != torch.int32:
        raise TypeError(f"op_slot must be int32, got {op_slot.dtype}")
    if eligible.dtype != torch.bool:
        raise TypeError(f"eligible must be bool, got {eligible.dtype}")
    if eligible.shape != op_slot.shape:
        raise ValueError(f"eligible {tuple(eligible.shape)} != op_slot "
                         f"{tuple(op_slot.shape)}")
    for name, rr in (("rr_vc", rr_vc), ("rr_port", rr_port)):
        if rr.dtype != torch.int32 or tuple(rr.shape) != (B,):
            raise ValueError(f"{name} must be int32 [{B}], got {rr.dtype} "
                             f"{tuple(rr.shape)}")
    devs = {t.device for t in (op_slot, eligible, rr_vc, rr_port)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")


def netstep(op_slot: torch.Tensor, eligible: torch.Tensor,
            rr_vc: torch.Tensor, rr_port: torch.Tensor):
    """op_slot [B, N, PI, V] int32, eligible [B, N, PI, V] bool,
    rr_vc / rr_port [B] int32 -> (win_mask [B, N, PI, V] bool,
    vc_choice [B, N, PI] int32, out_req [B, N, PI] int32)."""
    _check(op_slot, eligible, rr_vc, rr_port)
    dev = op_slot.device
    if dev.type == "cpu":
        return netstep_ref(op_slot, eligible, rr_vc, rr_port)
    if dev.type != "cuda":
        raise ValueError(f"netstep runs on cuda or cpu, not {dev}")
    B, N, PI, V = op_slot.shape
    if PI > MAX_LANES or V > MAX_LANES:
        raise ValueError(f"netstep kernel takes PI <= {MAX_LANES} and "
                         f"V <= {MAX_LANES}, got PI={PI}, V={V}")
    tensors = (op_slot, eligible, rr_vc, rr_port)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("netstep kernel needs contiguous inputs")
    op_ptr, el_ptr = op_slot.data_ptr(), eligible.data_ptr()
    op_align, el_align = ALIGN.get(V, (4, 1))
    if op_ptr % op_align or el_ptr % el_align:
        raise ValueError(f"netstep kernel needs op_slot {op_align}-byte and "
                         f"eligible {el_align}-byte aligned at V={V}")
    launch = LIB.launcher()
    win = torch.empty((B, N, PI, V), dtype=torch.bool, device=dev)
    vc = torch.empty((B, N, PI), dtype=torch.int32, device=dev)
    req = torch.empty((B, N, PI), dtype=torch.int32, device=dev)
    if win.numel() == 0:
        return win, vc, req
    args = (op_ptr, el_ptr, rr_vc.data_ptr(), rr_port.data_ptr(),
            win.data_ptr(), vc.data_ptr(), req.data_ptr(), B, N, PI, V)
    with torch.cuda.device(dev):
        rc = launch(*args, torch.cuda.current_stream().cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"netstep kernel launch failed: CUDA error {rc}")
    if capturing:
        netstep.captured += 1
    else:
        netstep.launches += 1
    return win, vc, req


netstep.launches = 0
netstep.captured = 0
