"""Time the port's kernels with one part cut out, on the card.

    python -m repro_torch.kernels.ablate [KERNEL ...] [--against SRC]

For the bf16 routes of `flash_attention` and `ssd_scan`, and for
`netstep`, this builds copies of the kernel source with one part removed
(the tensor-core products, the tile loads, the exponentials, the masks;
netstep's whole body, which leaves the launch floor of its grid, its
arbitration, its loads or its stores), plus netstep's `redux` copy, whose
arbitration takes `__reduce_min_sync` as an earlier design did.  It puts
each copy in the wrapper's library table in turn and times the wrapper:
flash attention and the SSD scan at the serving shape, netstep at the
simulator's shapes.  It reports the profiler's device time
of every CUDA kernel per call, CUDA events around back-to-back calls, and
CUDA events around the replay of a CUDA graph of back-to-back calls
(`graph_ms`: device time with no host work between the launches).
A cut copy computes nothing meaningful; only its time is read.  What a
cut saves is what that part costs on the card, so the cuts show what
bounds each kernel.  KERNEL names which kernels to time (all three when
none is given).  `--against SRC` also times SRC, an earlier source of the
one KERNEL named (netstep when none or several are: e.g. the parent
commit's `netstep.cu` or `flash_attention_bf16.cu`) with the same C entry
point, through the same wrapper, as cut "against".
Prints the card's name and power limit, then one JSON line per (kernel,
cut, shape).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

import torch

from .build import BUILD_DIR, CudaLibrary, build_all
from .flash_attention import ops as fops
from .netstep import ops as nops
from .ssd_scan import ops as sops

# (pattern, replacement) pairs, regular expressions over the source
CUTS = {
    "flash_attention": {
        "none": [],
        # the softmax's exponentials become subtractions
        "exp": [(r"exp2f\(", "(")],
        # no tile takes the causal mask
        "mask": [(r"if \(edge\) \{", "if (false) {")],
        # the wgmma products become one add
        "products": [
            (r'(?s)asm volatile\(\s*"\{\\n\.reg \.pred p;\\nsetp\.ne\.b32 p, '
             r'%\d+, 0;\\n"\s*"wgmma\.mma_async.*?\);',
             "d[0] += (float)scale_d;")],
    },
    "ssd_scan": {
        "none": [],
        # the mma.sync products become one integer op on the same operands
        "products": [
            (r'(?s)asm volatile\(\s*"mma\.sync\.aligned\.m16n8k.*?\);',
             "d[0] += __uint_as_float(a0 ^ a1 ^ a2 ^ a3 ^ b0 ^ b1);")],
        # no tile is copied to shared memory
        "tile_loads": [(r"(const T\* safe\) \{)", r"\1\n  return;")],
        # every exponential becomes its argument
        "exp": [(r"\bexpf\(", "(")],
    },
    "netstep": {
        "none": [],
        # the kernel returns at once: the launch floor of the same grid
        "empty": [(r"(__global__ void __launch_bounds__\(kThreads\)\s*"
                   r"netstep_kernel\([^)]*\) \{)", r"\1\n  return;")],
        # phase b cut: every request wins (no match)
        "arbitration": [(r"(?s)(bool arbitrate\([^)]*\) \{).*?\n\}",
                         r"\1\n  return requests;\n}")],
        # the same winners through __reduce_min_sync over each match group
        # of (score << 5) | lane, the score shifted by 32 where it wraps
        # (same order as mod PI): one REDUX per group of the warp in turn
        "redux": [(r"(?s)(bool arbitrate\([^)]*\) \{).*?\n\}",
                   r"\1\n"
                   r"  const unsigned key = requests ? (unsigned)(slot * 32 + "
                   r"req) : 1024u + (unsigned)lane;\n"
                   r"  const unsigned group = __match_any_sync(0xffffffffu, "
                   r"key);\n"
                   r"  const int score = port >= rpm ? port - rpm : "
                   r"port - rpm + 32;\n"
                   r"  const unsigned least = __reduce_min_sync(group, "
                   r"((unsigned)score << 5) | (unsigned)lane);\n"
                   r"  return requests && (least & 31u) == (unsigned)lane;\n}")],
        # at V = 4 nothing is read: the rr pair, the slots and the flags
        # become values of the indices (what the loads cost)
        "loads": [
            (r"const int rv = rr_vc\[row\];", "const int rv = row;"),
            (r"const int rp = rr_port\[row\];", "const int rp = row;"),
            (r"reinterpret_cast<const int4\*>\(op_slot\)\[p\];",
             "make_int4((int)p % 9 - 1, (int)p % 7 - 1, (int)p % 5 - 1, "
             "(int)p % 3 - 1);"),
            (r"reinterpret_cast<const uint32_t\*>\(eligible\)\[p\];",
             "((unsigned)p * 0x9E3779B1u) & 0x01010101u;")],
        # nothing is written, under a condition the compiler cannot drop
        # (what the stores cost)
        "stores": [(r"if \(active\) \{(\s*if constexpr \(kV == 1\))",
                    r"if (active && req == -7777) {\1")],
    },
}
SERVING = dict(flash=dict(b=4, t=1024, h=16, kv=8, hd=128),
               ssd=dict(b=4, t=1024, h=64, p=64, n=128, chunk=256))
# the simulator's allocator shapes [B, N, PI, V] at N = 256, 32 rows of a
# sweep group, 4 VCs: hexamesh and folded_hexa_torus (PI 7, the main
# path's widest group), mesh (PI 5), the widest radix (PI 31)
NETSTEP_SHAPES = ((32, 256, 7, 4), (32, 256, 5, 4), (32, 256, 31, 4))
# the wrappers whose bf16 route the cuts replace
BF16_OPS = {"flash_attention": fops, "ssd_scan": sops}


def base_lib(name: str) -> CudaLibrary:
    """The library kernel `name`'s wrapper launches (the bf16 route of
    flash attention and the SSD scan)."""
    if name == "netstep":
        return nops.LIB
    return BF16_OPS[name].LIBS[torch.bfloat16]


def use_lib(name: str, lib: CudaLibrary) -> None:
    """Make kernel `name`'s wrapper launch `lib`."""
    if name == "netstep":
        nops.LIB = lib
    else:
        BF16_OPS[name].LIBS[torch.bfloat16] = lib


def variant_libs(name: str) -> dict:
    """{cut: CudaLibrary} of kernel `name`: its library, then one copy of
    its source per cut (written under build/, not built)."""
    base = base_lib(name)
    src = base.source.read_text()
    libs = {}
    for cut, subs in CUTS[name].items():
        if not subs:
            libs[cut] = base
            continue
        text = src
        for pattern, repl in subs:
            text, k = re.subn(pattern, repl, text)
            if k == 0:
                raise RuntimeError(f"{name} cut {cut!r}: no match for "
                                   f"{pattern!r}")
        path = BUILD_DIR / "ablate" / f"{base.stem}_{cut}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        libs[cut] = CudaLibrary(path, f"{base.stem}_{cut}", base.entry,
                                base.argtypes)
    return libs


def graph_ms(fn, launches: int = 20, samples: int = 10) -> float:
    """Device ms per call of `fn` with no host work between the calls:
    `launches` calls captured in one CUDA graph, whose replay CUDA events
    time; the median over `samples` replays, after a warm-up call (which
    builds the kernel and sets its attributes) and a warm-up replay.  The
    wrapper's launch count rises by `launches` at the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    times.sort()
    return times[len(times) // 2]


def measure(fn, calls: int = 20, profiled: int = 5) -> dict:
    """Device ms per call (each CUDA kernel's mean per launch, summed; the
    kernels of one wrapper call launch once each) over `profiled` calls,
    CUDA-event ms per call over `calls` back-to-back calls, and
    `graph_ms` over `calls` calls in one graph."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if str(e.device_type).endswith("CUDA") and us > 0:
            per_kernel[e.key[:60]] = us / e.count / 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return dict(device_ms=sum(per_kernel.values()) or None,
                per_kernel_ms=per_kernel,
                events_ms=start.elapsed_time(end) / calls,
                graph_ms=graph_ms(fn, launches=calls))


def netstep_inputs(shape, gen, dev):
    """Random allocator inputs: requested slots in [-1, PI), half of the
    requesting VCs eligible, each row its own rr pair."""
    b, _, pi, v = shape
    op_slot = torch.randint(-1, pi, shape, generator=gen, dtype=torch.int32)
    eligible = (torch.rand(shape, generator=gen) < 0.5) & (op_slot >= 0)
    rows = torch.arange(b, dtype=torch.int32)
    return (op_slot.to(dev), eligible.to(dev), (rows % v).to(dev),
            (rows % pi).to(dev))


def main() -> None:
    names = tuple(CUTS)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="*", choices=names)
    ap.add_argument("--against", type=Path, default=None,
                    help="an earlier source of the one KERNEL named "
                         "(default netstep) to time beside it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(0)
    variants = {name: variant_libs(name) for name in args.kernels or names}
    if args.against is not None:
        name = args.kernels[0] if len(args.kernels) == 1 else "netstep"
        base = base_lib(name)
        variants.setdefault(name, variant_libs(name))["against"] = \
            CudaLibrary(args.against, f"{base.stem}_against", base.entry,
                        base.argtypes)
    build_all([lib for libs in variants.values() for lib in libs.values()])

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)

    runs = []
    if "flash_attention" in variants:
        f = SERVING["flash"]
        q = randn(f["b"], f["t"], f["h"], f["hd"])
        k = randn(f["b"], f["t"], f["kv"], f["hd"])
        v = randn(f["b"], f["t"], f["kv"], f["hd"])
        runs.append(("flash_attention", lambda: fops.flash_attention(
            q, k, v, causal=True), dict(f), {}))
    if "ssd_scan" in variants:
        s = SERVING["ssd"]
        x = randn(s["b"], s["t"], s["h"], s["p"])
        dt = (torch.rand((s["b"], s["t"], s["h"]), generator=gen) * 0.85
              + 0.05).to(dev)
        a = (-(torch.rand((s["h"],), generator=gen) * 1.7 + 0.3)).to(dev)
        bm, cm = randn(s["b"], s["t"], s["n"]), randn(s["b"], s["t"], s["n"])
        runs.append(("ssd_scan", lambda: sops.ssd_scan(
            x, dt, a, bm, cm, chunk=s["chunk"]), dict(s), {}))
    if "netstep" in variants:
        for shape in NETSTEP_SHAPES:
            ins = netstep_inputs(shape, gen, dev)
            runs.append(("netstep", lambda ins=ins: nops.netstep(*ins),
                         list(shape), dict(calls=200, profiled=50)))
    for name, fn, shape, opts in runs:
        original = base_lib(name)
        cuts = list(variants[name].items())
        # each cut twice, the second pass in reverse order
        for rep, order in enumerate((cuts, cuts[::-1])):
            for cut, lib in order:
                use_lib(name, lib)
                row = measure(fn, **opts)
                if name == "netstep" and row["device_ms"] is not None:
                    row["wrapper_host_us"] = 1e3 * (row["events_ms"]
                                                    - row["device_ms"])
                print(json.dumps(dict(kernel=name, cut=cut, rep=rep,
                                      shape=shape, **row)), flush=True)
        use_lib(name, original)


if __name__ == "__main__":
    main()
