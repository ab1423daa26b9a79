"""Runner hazard analysis of the batched simulator (DESIGN.md §14).

The port's counterpart of `repro.analysis.jaxpr_hazards`, with the same
public functions and diagnostic codes.  It has a new name because
nothing here walks a jaxpr: the program the hazards live in is the
stream of aten ops the cycle loop issues (on the card, the ops its CUDA
graphs hold), recorded by `core.simulator.trace_batch` over a few real
cycles run eagerly.

  * **JX001 int32-overflow** — closed-form worst-case bounds for every
    int32 accumulator of the runner given `SimConfig`; flagged when a
    bound reaches 2^31.  The dominant term is the summed-latency
    counter: each ejection contributes up to ``cycles`` and a node can
    eject from all P+1 ports each measured cycle, so
    ``lat_node <= measured * (P+1) * cycles``.  As the reference's.
  * **JX002 pad-slot-write** — the padding contract of
    `sweep.padding.pad_spec`, checked on the stacked `BatchSpec` leaves
    the runner uploads: padded table/out_ch/in_ch entries -1, padded
    channel endpoints 0, depths >= 1, pad traffic rows 1.0, pad
    injection weights 0, pad productive-ports False.  As the reference's.
  * **JX003 recompile-hazard** — distinct padded shapes in one spec
    collection.  The port compiles nothing per shape, but each distinct
    shape is a separate engine group: a separate run of the whole cycle
    loop, so a heterogeneous sweep without bucketing runs the loop once
    per topology.  The message keeps the reference's words, byte for
    byte, so reports of the two packages compare line for line.
  * **JX004 host-sync** — *changed meaning.*  The reference looks for
    host-callback primitives in the traced scan.  Here: ops inside the
    cycle loop that make the host wait for the device.  One of them
    stalls the host's issue of every following op, each cycle.  Two
    sources, both read from the log:
      - on the card, every op whose call made the host wait (`OpRecord.
        synced`: `log_ops` runs the cycles under
        `torch.cuda.set_sync_debug_mode("warn")`), at whatever level the
        wait happens.  This is the complete rule;
      - on any device, by name: `aten._local_scalar_dense` (`.item()`,
        `bool()` of a tensor), `aten.nonzero`, `aten.equal`, copies from
        the device to the CPU, and the ops that size their output from
        the data inside their kernel — `aten.masked_select`, the
        `aten.unique` family, `aten.repeat_interleave` (named whether or
        not it was given `output_size`: the log keeps no arguments), and
        `aten.index` / `aten.index_put_` with a boolean index.  On the
        CPU these names are all JX004 sees.  What waits outside them
        shows only on the card: a Python number written through an
        advanced index (`x[i] = t`), which PyTorch makes a CPU tensor and
        copies to the card, blocking (on the CPU it is a 0-dim tensor
        like any other), or an op that waits inside its kernel.
  * **JX005 dtype-promotion** — *changed meaning.*  The reference flags
    widening `convert_element_type` ops and any 64-bit aval (x64 mode
    leaking in).  In torch, int64 is the index dtype (`gather`,
    `index_add_`, `scatter` and advanced indexing take int64 indices),
    so an explicit conversion (`.long()`, `.to(...)`: `aten._to_copy`)
    and ops whose inputs are already 64-bit do not count.  What counts,
    inside the cycle loop: float64 tensors, and an op whose result is
    64-bit while every non-scalar tensor input is narrower — a silent
    promotion by a reduction's default dtype or by a Python number.
    Index outputs (`min(dim)`'s indices) are int64 by definition and
    are not the op's result.

The port's own loop gives the findings in `INTENDED`, each with its
reason; any other JX004 / JX005 finding on the runner is a fault.  Not
a finding: the injection hash is carried in int64 on purpose (equal to
the reference's uint32 hash up to t = 2^31 - 1), but its inputs are
int64 from the start (`arange`), so no op promotes into it.  The netstep
kernel's launch is not an aten op and does not appear in the log.
"""
from __future__ import annotations

import numpy as np
import torch

from .diagnostics import Diagnostic, Report, diag

INT32_MAX = 2 ** 31

#: the JX004 / JX005 findings of the port's own cycle loop (static
#: routing, the default SimConfig), as `findings` gives them: (code, op,
#: dtype src, dtype dst) -> the reason the loop keeps it
INTENDED = {
    ("JX005", "aten.sum.dim_IntList", "torch.bool", "torch.int64"):
        "injection draws each flit's destination as the count of "
        "cumulative traffic entries below a uniform draw "
        "(`(cum < u).sum(2)`); the count is a node index that addresses "
        "the int64 buffer state, so it stays in the reduction's int64 "
        "default",
}

#: aten ops (overload stripped) that read a device value on the host,
#: directly or to size their output
_HOST_SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.equal",
                  "aten.masked_select", "aten.repeat_interleave",
                  "aten._unique", "aten._unique2", "aten.unique_dim",
                  "aten.unique_consecutive")
#: indexing ops that read the device when an index is boolean (its
#: `nonzero`), and how many trailing tensor inputs are not indices
_MASK_INDEX_OPS = {"aten.index": 0, "aten.index_put": 1,
                   "aten.index_put_": 1, "aten._index_put_impl_": 1}
#: explicit conversions and copies, which JX005 does not count (JX004
#: counts those that land on the CPU from the device)
_CONVERSIONS = ("aten._to_copy", "aten.copy_")
#: the op that makes the 0-dim CPU tensors Python numbers become: the
#: only host-side op of the loop when it runs on the card
HOST_SIDE_OPS = ("aten.lift_fresh",)


def _packet(op: str) -> str:
    """'aten.sum.dim_IntList' -> 'aten.sum'."""
    return ".".join(op.split(".")[:2])


# =====================================================================
# JX001 — int32 counter overflow bounds
# =====================================================================

def counter_bounds(n: int, p: int, cfg, telemetry: bool | None = None
                   ) -> dict[str, int]:
    """Worst-case value of each int32 runner accumulator.

    n, p are the (padded) node count and max real port count; the
    injection port makes the per-node port axis p+1 wide.  Bounds are
    deliberately loose upper bounds — a flagged config *may* survive in
    practice, an unflagged one provably cannot overflow.
    """
    meas = max(cfg.cycles - cfg.warmup, 0)
    pi = p + 1
    bounds = {
        # one event per node per cycle
        "delivered": meas * n,
        "offered": meas * n,
        "accepted": meas * n,
        # each ejection's latency <= cycles; up to pi ejections per
        # node per cycle
        "lat_node": meas * pi * cfg.cycles,
    }
    if telemetry if telemetry is not None else getattr(
            cfg, "telemetry", False):
        v, b = cfg.n_vcs, cfg.buf_depth
        bounds.update(
            tel_busy=meas,                   # one traversal per channel
            tel_stall=meas * pi * v,         # all lanes starve same ch
            tel_occ=meas * b,                # occupancy <= buf depth
            tel_inj=meas,
            tel_eject=meas * pi,
            tel_hist=meas * n * pi,          # all ejections in one bin
        )
    return bounds


def check_overflow(n: int, p: int, cfg, target: str = "",
                   report: Report | None = None) -> list[Diagnostic]:
    """JX001 for every counter whose worst-case bound reaches 2^31."""
    out = []
    for name, bound in counter_bounds(n, p, cfg).items():
        if bound >= INT32_MAX:
            out.append(diag(
                "JX001",
                f"int32 counter '{name}' worst-case bound {bound:,} >= "
                f"2^31 at cycles={cfg.cycles} (warmup={cfg.warmup}, "
                f"N={n}, P={p}); simulated metrics could silently wrap",
                target=target, counter=name, bound=int(bound),
                cycles=int(cfg.cycles), warmup=int(cfg.warmup),
                n=int(n), p=int(p)))
    if report is not None:
        report.record("overflow", target or f"n{n}/p{p}")
        report.extend(out)
    return out


# =====================================================================
# JX002 — sacrificial-slot padding contract
# =====================================================================

def check_padding_contract(batch, specs, target: str = "",
                           report: Report | None = None
                           ) -> list[Diagnostic]:
    """JX002: inspect stacked `BatchSpec` leaves against `pad_spec`'s
    contract, per spec.  `specs` supplies each row's real (n, p, c)."""
    out: list[Diagnostic] = []
    S = batch.table.shape[0]
    P = batch.out_ch.shape[2]
    C = batch.ch_src.shape[1]

    def bad(i, leaf, mask, expect):
        arr = getattr(batch, leaf)[i]
        viol = np.asarray(mask & ~expect)
        if not viol.any():
            return
        idx = tuple(int(x) for x in np.argwhere(viol)[0])
        out.append(diag(
            "JX002",
            f"spec {i} leaf '{leaf}' violates the sacrificial-slot "
            f"padding contract at index {idx} (value "
            f"{arr[idx].item()!r}, {int(viol.sum())} violation(s)); a "
            f"scatter fed by this lane can touch a live slot",
            target=target, spec=i, leaf=leaf, index=idx,
            value=arr[idx].item(), n_bad=int(viol.sum())))

    for i in range(min(S, len(specs))):
        s = specs[i]
        n, p, c = s.n, s.p, s.c
        tbl = batch.table[i]
        m = np.zeros(tbl.shape, bool)
        m[n:] = True
        m[:, n:] = True
        m[:n, :n, p:P] = True           # injection col lives at slot P
        bad(i, "table", m, tbl == -1)
        for leaf in ("out_ch", "in_ch"):
            a = getattr(batch, leaf)[i]
            m = np.zeros(a.shape, bool)
            m[n:] = True
            m[:, p:] = True
            bad(i, leaf, m, a == -1)
            # live entries must index a real channel of THIS spec: a
            # declared out_ch >= c would scatter into another spec's
            # channel rows after padding
            live = ~m & (a >= 0)
            bad(i, leaf, live, a < c)
        mc = np.zeros((C,), bool)
        mc[c:] = True
        for leaf, fill in (("ch_src", 0), ("ch_dst", 0),
                           ("ch_in_port", 0), ("ch_out_port", 0)):
            a = getattr(batch, leaf)[i]
            bad(i, leaf, mc, a == fill)
        bad(i, "ch_dst", ~mc, batch.ch_dst[i] < n)
        bad(i, "ch_in_port", ~mc, batch.ch_in_port[i] < p)
        bad(i, "ch_depth", mc, batch.ch_depth[i] == 1)
        bad(i, "ch_depth", np.ones((C,), bool), batch.ch_depth[i] >= 1)
        cum = batch.traffic_cum[i]
        m = np.zeros(cum.shape, bool)
        m[n:] = True
        m[:, n:] = True
        bad(i, "traffic_cum", m, cum == 1.0)
        inj = batch.inj_weight[i]
        m = np.zeros(inj.shape, bool)
        m[n:] = True
        bad(i, "inj_weight", m, inj == 0.0)
        # productive-ports mask (DESIGN.md §15): the pad region must be
        # all-False so an adaptive selection can never name a padded
        # destination, node or port
        pr = batch.prod[i]
        m = np.zeros(pr.shape, bool)
        m[n:] = True
        m[:, n:] = True
        m[:, :, p:] = True
        bad(i, "prod", m, ~pr)
    if report is not None:
        report.record("padding", target or f"batch[{S}]")
        report.extend(out)
    return out


# =====================================================================
# JX003 — recompile hazards (distinct shapes per engine group)
# =====================================================================

def check_recompiles(shapes, target: str = "", bucketed=None,
                     report: Report | None = None) -> list[Diagnostic]:
    """JX003 when a spec collection spans several padded shapes.

    `shapes`: one `PadShape` per spec.  Each distinct shape is a
    separate run of the cycle loop; pass `bucketed` (the shapes the
    sweep engine's `group_key` gives) to show how many runs bucketing
    saves.
    """
    shapes = list(shapes)
    distinct = sorted(set(shapes))
    out: list[Diagnostic] = []
    if len(distinct) > 1:
        n_b = len(set(bucketed)) if bucketed is not None else None
        msg = (f"{len(shapes)} spec(s) span {len(distinct)} "
               f"distinct padded shapes -> {len(distinct)} compiled "
               f"executables")
        if n_b is not None and n_b < len(distinct):
            msg += f"; shape bucketing would reduce this to {n_b}"
        out.append(diag(
            "JX003", msg, target=target,
            n_shapes=len(distinct),
            shapes=[(s.n, s.p, s.c, s.d) for s in distinct],
            n_bucketed=n_b))
    if report is not None:
        report.record("recompile", target or f"{len(shapes)} specs")
        report.extend(out)
    return out


# =====================================================================
# JX004 / JX005 — the op log of the cycle loop
# =====================================================================

def loop_ops(op_log) -> list:
    """The records of `op_log` issued inside the cycle loop."""
    return [r for r in op_log if r.cycle is not None]


def host_side_ops(op_log, device_type: str) -> list[str]:
    """Names of the cycle loop's ops with no tensor on `device_type`
    (sorted, with repeats removed): on the card, `HOST_SIDE_OPS` only."""
    return sorted({_packet(r.op) for r in loop_ops(op_log)
                   if device_type not in r.in_devices + r.out_devices})


def _syncs(r) -> bool:
    """Whether the logged op `r` makes the host wait for the device."""
    name = _packet(r.op)
    if r.synced or name in _HOST_SYNC_OPS:
        return True
    if name in _CONVERSIONS:
        return "cpu" in r.out_devices and any(d != "cpu"
                                              for d in r.in_devices)
    if name in _MASK_INDEX_OPS:
        stop = len(r.in_dtypes) - _MASK_INDEX_OPS[name]
        return "torch.bool" in r.in_dtypes[1:stop]
    return False


def check_host_sync(op_log, target: str = "",
                    report: Report | None = None) -> list[Diagnostic]:
    """JX004: ops in the cycle loop that make the host wait for the
    device (see the module docstring)."""
    hits: dict[str, int] = {}
    at: dict[str, set] = {}
    for r in loop_ops(op_log):
        if _syncs(r):
            name = _packet(r.op)
            hits[name] = hits.get(name, 0) + 1
            if r.synced:
                at.setdefault(name, set()).add(r.synced)
    out = [diag(
        "JX004",
        f"cycle loop runs '{name}' (x{count}) — a device-to-host sync "
        f"point inside the loop",
        target=target, op=name, count=count,
        **({"at": tuple(sorted(at[name]))} if name in at else {}))
        for name, count in sorted(hits.items())]
    if report is not None:
        report.record("host-sync", target or "op-log")
        report.extend(out)
    return out


def _width(dtype: str) -> int:
    """Bytes per element of a logged dtype ('torch.int64' -> 8)."""
    return getattr(torch, dtype.removeprefix("torch.")).itemsize


def check_dtype_promotions(op_log, target: str = "",
                           report: Report | None = None
                           ) -> list[Diagnostic]:
    """JX005: silent promotions to 64 bits and float64 tensors in the
    cycle loop (see the module docstring for what counts)."""
    widenings: dict[tuple, int] = {}
    f64 = 0
    for r in loop_ops(op_log):
        f64 += (r.in_dtypes + r.out_dtypes).count("torch.float64")
        name = _packet(r.op)
        if name in _CONVERSIONS or not r.out_dtypes:
            continue
        arrays = [d for d, dim0 in zip(r.in_dtypes, r.in_dim0) if not dim0]
        dst = r.out_dtypes[0]
        if arrays and _width(dst) >= 8 and \
                all(_width(d) < 8 for d in arrays):
            key = (r.op, max(arrays, key=_width), dst)
            widenings[key] = widenings.get(key, 0) + 1
    out = [diag(
        "JX005",
        f"cycle loop widens {src} -> {dst} in '{op}' (x{count}) — silent "
        f"dtype promotion",
        target=target, op=op, src=src, dst=dst, count=count)
        for (op, src, dst), count in sorted(widenings.items())]
    if f64:
        out.append(diag(
            "JX005",
            f"cycle loop carries {f64} torch.float64 tensor(s) — 64-bit "
            f"floats leaked into the batched path",
            target=target, dtype="torch.float64", count=f64))
    if report is not None:
        report.record("dtype", target or "op-log")
        report.extend(out)
    return out


def findings(diagnostics) -> list[tuple]:
    """(code, op, src, dst) of JX004 / JX005 diagnostics — the form of
    `INTENDED` (None where a field does not apply)."""
    out = []
    for d in diagnostics:
        if d.code in ("JX004", "JX005"):
            w = d.witness_dict()
            out.append((d.code, w.get("op"), w.get("src"),
                        w.get("dst", w.get("dtype"))))
    return out


# =====================================================================
# front door
# =====================================================================

def analyze_batch(specs, rates, cfg=None, *, schedules=None,
                  target: str = "", report: Report | None = None,
                  trace: bool = True, device=None) -> Report:
    """Run all JX checks on one batch of SimSpecs.

    Runs the real runner for a few cycles on `device` under the op
    logger (`simulator.trace_batch`; skippable with trace=False) for the
    op-level checks, and inspects the padded arrays and counter bounds
    directly.  device: None is the CUDA card; "cpu" the CPU.
    """
    from ..core import simulator as sim
    from ..sweep.padding import PadShape, stack_specs

    cfg = cfg or sim.SimConfig()
    report = report if report is not None else Report()
    shapes = [PadShape(n=s.n, p=s.p, c=s.c, d=s.d) for s in specs]
    batch, shape = stack_specs(specs)
    # run one at a time these specs would run the loop once per distinct
    # shape; stacking pads them to `shape`
    check_recompiles(shapes, target=target,
                     bucketed=[shape] * len(shapes), report=report)
    check_overflow(shape.n, shape.p, cfg, target=target, report=report)
    check_padding_contract(batch, specs, target=target, report=report)
    if trace:
        op_log, _, _ = sim.trace_batch(specs, rates, cfg, device=device,
                                       schedules=schedules)
        check_host_sync(op_log, target=target, report=report)
        check_dtype_promotions(op_log, target=target, report=report)
    return report
