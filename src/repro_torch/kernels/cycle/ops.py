"""Public wrappers of the fused cycle kernels.

`cycle_route` (§1-§4) and `cycle_move` (§5) take the state and arguments
of one simulator run as a dict of tensors (`ARGS`, as `csrc/cycle.cu`'s
`CycleParams` lays them out) and the recorder's window ints (`RUN_INTS`).
Three groups are given whole or not at all, and pick the run's mode:
`WORKLOAD` (phase tables), `ADAPTIVE` (adaptive routing) and `RECORDER`
(the flight recorder).  The wrappers check them, then on CUDA tensors launch
the hand-written kernels on PyTorch's current stream, and on CPU tensors
compute the plain versions (`ref.py`).  A CUDA input never falls back: a
tensor of another device, type, shape or layout, a build failure or a
launch failure raises.  `cycle_draw` is the kernels' destination draw
alone, for tests.  The kernels read the cycle from `t` on the device
and `cycle_move` advances it, so a CUDA graph can replay both.

`cycle_route.launches` and `cycle_move.launches` count kernel launches
(CPU calls are not counted), as `netstep.launches` does; a call on a
stream that is capturing a CUDA graph counts in `.captured`, and
whoever replays the graph adds its launches to `.launches`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary
from .ref import LAT_HIST_BINS, cycle_move_ref, cycle_route_ref, draw_ref

#: the tensor arguments, in `CycleParams` order; `None` for an absent
#: optional one (the groups `WORKLOAD`, `ADAPTIVE` and `RECORDER` below)
ARGS = ("up_ch", "up_delay", "out_ch", "out_delay", "table", "srow", "pi",
        "rate", "inj_w", "cum", "rate_t", "kidx_row", "bk", "u_inj",
        "u_dst", "vcs", "buf_dst", "buf_t", "head", "cnt", "credits",
        "link_dst", "link_t", "link_vc", "credit_pipe", "rr", "op_slot",
        "eligible", "rr_vc", "rr_port", "win", "vc", "req", "delivered",
        "offered", "accepted", "lat_node", "delivered_ph", "offered_ph",
        "accepted_ph", "lat_ph", "prod", "dvc", "tel_busy", "tel_stall",
        "tel_occ", "tel_inj", "tel_eject", "tel_hist", "t", "ticket")
#: the integer arguments, in `CycleParams` order
INTS = ("rows", "n", "p", "v", "bd", "c", "d", "measuring", "windows",
        "warmup", "meas")
#: the integer arguments `a` gives (the rest follow from the shapes)
RUN_INTS = ("windows", "warmup", "meas")
#: the arguments only workload runs give
WORKLOAD = ("rate_t", "kidx_row", "bk", "delivered_ph", "offered_ph",
            "accepted_ph", "lat_ph")
#: the arguments only adaptive runs give: the productive ports, packed P
#: bits a (spec, dst, node), and each VC's downstream VC
ADAPTIVE = ("prod", "dvc")
#: the flight recorder's counters, given exactly with the recorder on
RECORDER = ("tel_busy", "tel_stall", "tel_occ", "tel_inj", "tel_eject",
            "tel_hist")


class _Params(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in ARGS] + \
        [(k, ctypes.c_int) for k in INTS]


_SOURCE = Path(__file__).resolve().parent / "csrc" / "cycle.cu"
_PARAMS = [ctypes.POINTER(_Params), ctypes.c_void_p]
LIB = CudaLibrary(_SOURCE, "cycle", "cycle_route_launch", _PARAMS)
_MOVE = ("cycle_move_launch", _PARAMS)
_DRAW = ("cycle_draw_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
         + [ctypes.c_void_p])


def _shapes(a: dict) -> dict:
    """Each argument's dtype and shape ([None] where any size goes), from
    the buffers' shape [B, N, PI, V, Bd] and the links' [B, C, D]."""
    B, N, PI, V, Bd = a["buf_dst"].shape
    _, C, D = a["link_dst"].shape
    P = PI - 1
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    x, bk = a["inj_w"].shape[0], a["delivered_ph"]
    k = bk.shape[0] if bk is not None else 0
    nw = max(a["windows"], 1)
    return dict(
        up_ch=(i32, (B, N, P)), up_delay=(i32, (B, N, P)),
        out_ch=(i32, (B, N, P)), out_delay=(i32, (B, N, P)),
        table=(torch.int16, (None, N, N, PI)), srow=(i32, (B,)),
        pi=(i32, (B,)), rate=(f32, (B,)), inj_w=(f32, (x, N)),
        cum=(f32, (x, N, N)), rate_t=(f32, (None, B)),
        kidx_row=(i64, (None, B)), bk=(i64, (None, B)),
        u_inj=(f32, (None, N)), u_dst=(f32, (None, N)),
        vcs=(i64, (None, N)), buf_dst=(i32, (B, N, PI, V, Bd)),
        buf_t=(i32, (B, N, PI, V, Bd)), head=(i32, (B, N, PI, V)),
        cnt=(i32, (B, N, PI, V)), credits=(i32, (B, N, P, V)),
        link_dst=(i32, (B, C, D)), link_t=(i32, (B, C, D)),
        link_vc=(i32, (B, C, D)), credit_pipe=(i32, (B, C, D, V)),
        rr=(i32, (B,)), op_slot=(i32, (B, N, PI, V)),
        eligible=(torch.bool, (B, N, PI, V)), rr_vc=(i32, (B,)),
        rr_port=(i32, (B,)), win=(torch.bool, (B, N, PI, V)),
        vc=(i32, (B, N, PI)), req=(i32, (B, N, PI)),
        delivered=(i32, (B,)), offered=(i32, (B,)), accepted=(i32, (B,)),
        lat_node=(i32, (B, N)), delivered_ph=(i32, (k,)),
        offered_ph=(i32, (k,)), accepted_ph=(i32, (k,)),
        lat_ph=(i32, (k, N)), prod=(i32, (None, N, N)),
        dvc=(i32, (B, N, PI, V)), tel_busy=(i32, (nw, B, C + 1)),
        tel_stall=(i32, (nw, B, C + 1)), tel_occ=(i32, (nw, B, C + 1, V)),
        tel_inj=(i32, (nw, B, N)), tel_eject=(i32, (nw, B, N)),
        tel_hist=(i32, (B, LAT_HIST_BINS)), t=(i64, (1,)),
        ticket=(i32, (1,)))


def _check(a: dict) -> torch.device:
    """Raise on an argument the kernels do not take; returns the device."""
    missing = [k for k in ARGS + RUN_INTS if k not in a]
    if missing:
        raise ValueError(f"cycle kernels: missing arguments {missing}")
    for group, what in ((WORKLOAD, "workload runs (with rate_t)"),
                        (ADAPTIVE, "adaptive runs (with prod)"),
                        (RECORDER, "recorder runs (with tel_busy)")):
        given = a[group[0]] is not None
        for k in group:
            if (a[k] is not None) != given:
                raise ValueError(f"cycle kernels: {k} must be given exactly "
                                 f"in {what}")
    _, _, PI, V, _ = a["buf_dst"].shape
    if not (2 <= PI <= 32 and 1 <= V <= 32):
        raise ValueError(f"cycle kernels take 1 <= P <= 31 ports and 1 <= "
                         f"V <= 32 VCs, got P={PI - 1}, V={V}")
    if a["prod"] is not None and V < 2:
        raise ValueError(f"cycle kernels: adaptive routing needs V >= 2 "
                         f"(the escape VC and an adaptive one), got V={V}")
    w, meas = a["windows"], a["meas"]
    if w < 0 or (w and (meas < 1 or a["tel_busy"] is None)):
        raise ValueError(f"cycle kernels: {w} recorder windows need the "
                         f"recorder and a measured span of at least one "
                         f"cycle, got {meas}")
    devs = set()
    for k, (dtype, shape) in _shapes(a).items():
        x = a[k]
        if x is None:
            continue
        if x.dtype != dtype:
            raise TypeError(f"cycle kernels: {k} must be {dtype}, got "
                            f"{x.dtype}")
        if x.dim() != len(shape) or any(
                s is not None and s != g for s, g in zip(shape, x.shape)):
            raise ValueError(f"cycle kernels: {k} must be shaped "
                             f"{shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"cycle kernels: {k} must be contiguous")
        devs.add(x.device)
    if len(devs) != 1:
        raise ValueError(f"cycle kernels: arguments on several devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"cycle kernels run on cuda or cpu, not {dev}")
    return dev


def _launch(fn, a: dict, measuring: bool, counted) -> None:
    B, N, PI, V, Bd = a["buf_dst"].shape
    _, C, D = a["link_dst"].shape
    p = _Params(**{k: (a[k].data_ptr() if a[k] is not None else None)
                   for k in ARGS},
                rows=B, n=N, p=PI - 1, v=V, bd=Bd, c=C, d=D,
                measuring=int(measuring),
                **{k: int(a[k]) for k in RUN_INTS})
    with torch.cuda.device(a["t"].device):
        rc = fn(ctypes.byref(p), torch.cuda.current_stream().cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"cycle kernel launch failed: CUDA error {rc}")
    if capturing:
        counted.captured += 1
    else:
        counted.launches += 1


def cycle_route(a: dict, measuring: bool) -> None:
    """§1-§4 of cycle `a["t"]` on the state in `a`, in place, ending in
    the allocator's arguments `op_slot`, `eligible`, `rr_vc`, `rr_port`
    (and, adaptive, `dvc`); `measuring` adds the offered and accepted
    counters and the recorder's occupancy, injections and stalls.  `a`
    holds every name of `ARGS` but the allocation's `win`, `vc` and
    `req`, and `RUN_INTS`."""
    a = dict(a, win=None, vc=None, req=None)
    if _check(a).type == "cpu":
        return cycle_route_ref(a, measuring)
    _launch(LIB.launcher(), a, measuring, cycle_route)


def cycle_move(a: dict, win: torch.Tensor, vc: torch.Tensor,
               req: torch.Tensor, measuring: bool) -> None:
    """§5 of cycle `a["t"]` given the allocation (`netstep`'s win [B, N,
    PI, V] bool, vc / req [B, N, PI] int32), in place, then `t` + 1;
    `measuring` adds the delivered and latency counters and the
    recorder's traversals, ejections and latency bins."""
    a = dict(a, win=win, vc=vc, req=req)
    if _check(a).type == "cpu":
        return cycle_move_ref(a, win, vc, req, measuring)
    _launch(LIB.symbol(*_MOVE), a, measuring, cycle_move)


cycle_route.launches = cycle_route.captured = 0
cycle_move.launches = cycle_move.captured = 0


def cycle_draw(cum: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """cum [R, N] float32 nondecreasing rows, u [R] float32 -> int32 [R]:
    the kernels' destination draw (a binary search), the count of each
    row's entries below u, at most N - 1."""
    if cum.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("cycle_draw takes float32 cum and u")
    if cum.dim() != 2 or u.shape != cum.shape[:1]:
        raise ValueError(f"cycle_draw takes cum [R, N] and u [R], got "
                         f"{tuple(cum.shape)} and {tuple(u.shape)}")
    if cum.device != u.device or not (cum.is_contiguous()
                                      and u.is_contiguous()):
        raise ValueError("cycle_draw takes contiguous inputs on one device")
    if cum.device.type == "cpu":
        return draw_ref(cum, u)
    out = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    with torch.cuda.device(u.device):
        rc = LIB.symbol(*_DRAW)(
            cum.data_ptr(), u.data_ptr(), out.data_ptr(), cum.shape[0],
            cum.shape[1], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cycle_draw launch failed: CUDA error {rc}")
    return out
