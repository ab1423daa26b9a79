"""Time the bf16 serving kernels with one part cut out, on the card.

    python -m repro_torch.kernels.ablate

For the bf16 routes of `flash_attention` and `ssd_scan` this builds copies
of the kernel source with one part removed (the tensor-core products, the
tile loads, the exponentials, the masks), puts each copy in the wrapper's
library table in turn, and times the wrapper at the serving shape: the
profiler's device time of every CUDA kernel per call, and CUDA events
around back-to-back calls.  A cut copy computes nothing meaningful; only
its time is read.  What a cut saves is what that part costs on the card,
so the cuts show what bounds each kernel.  Prints the card's name and
power limit, then one JSON line per (kernel, cut).
"""
from __future__ import annotations

import json
import re
import subprocess

import torch

from .build import BUILD_DIR, CudaLibrary, build_all
from .flash_attention import ops as fops
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
}
SERVING = dict(flash=dict(b=4, t=1024, h=16, kv=8, hd=128),
               ssd=dict(b=4, t=1024, h=64, p=64, n=128, chunk=256))


def variant_libs(name: str, ops) -> dict:
    """{cut: CudaLibrary} for the bf16 route of kernel `name`, built."""
    base = ops.LIBS[torch.bfloat16]
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
    build_all(list(libs.values()))
    return libs


def measure(fn, calls: int = 20) -> dict:
    """Device ms per call (each CUDA kernel's mean per launch, summed; the
    kernels of one wrapper call launch once each) and CUDA-event ms."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
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
                events_ms=start.elapsed_time(end) / calls)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)

    f = SERVING["flash"]
    q = randn(f["b"], f["t"], f["h"], f["hd"])
    k = randn(f["b"], f["t"], f["kv"], f["hd"])
    v = randn(f["b"], f["t"], f["kv"], f["hd"])
    s = SERVING["ssd"]
    x = randn(s["b"], s["t"], s["h"], s["p"])
    dt = (torch.rand((s["b"], s["t"], s["h"]), generator=gen) * 0.85
          + 0.05).to(dev)
    a = (-(torch.rand((s["h"],), generator=gen) * 1.7 + 0.3)).to(dev)
    bm, cm = randn(s["b"], s["t"], s["n"]), randn(s["b"], s["t"], s["n"])
    runs = {
        "flash_attention": (fops, lambda: fops.flash_attention(
            q, k, v, causal=True), dict(f)),
        "ssd_scan": (sops, lambda: sops.ssd_scan(
            x, dt, a, bm, cm, chunk=s["chunk"]), dict(s)),
    }
    for name, (ops, fn, shape) in runs.items():
        libs = variant_libs(name, ops)
        original = ops.LIBS[torch.bfloat16]
        for cut, lib in libs.items():
            ops.LIBS[torch.bfloat16] = lib
            print(json.dumps(dict(kernel=name, cut=cut, shape=shape,
                                  **measure(fn))), flush=True)
        ops.LIBS[torch.bfloat16] = original


if __name__ == "__main__":
    main()
