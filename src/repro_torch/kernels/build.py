"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `.cu` source with a plain C entry point.  `nvcc`
compiles it for sm_90a into a shared library, which `ctypes` loads.
Libraries go to `build/kernels/` at the root of the checkout, named by
the kernel's stem and a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is built once.  The compiler's
resource report (-Xptxas=-v) is kept beside each library as
`<library>.log`.  Nothing here runs at import: the first CUDA launch
builds.  A missing compiler or a failed build raises.

`build_all` starts one `nvcc` per source, all together, and waits for
them; `CudaLibrary.launcher` builds its own source the same way.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else `nvcc` on PATH, else
    the toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels cannot be built")


class CudaLibrary:
    """One kernel source, its library and its C entry point.

    `entry` is the name of the `extern "C"` launcher and `argtypes` its
    ctypes signature (`symbol` loads any other entry point of the same
    library); every launcher returns `cudaGetLastError()` as an int."""

    def __init__(self, source: Path, stem: str, entry: str, argtypes):
        self.source = Path(source)
        self.stem = stem
        self.entry = entry
        self.argtypes = list(argtypes)
        self._symbols = {}

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.stem}_{h.hexdigest()[:16]}.so"

    def launcher(self):
        """The loaded C entry point, with its signature declared; the
        kernel is compiled first unless its library exists."""
        return self.symbol(self.entry, self.argtypes)

    def symbol(self, entry: str, argtypes):
        """The library's C entry point `entry` (the launcher's or another),
        loaded once with an int return and `argtypes` declared."""
        if entry not in self._symbols:
            fn = getattr(ctypes.CDLL(str(build_all([self])[0])), entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            self._symbols[entry] = fn
        return self._symbols[entry]


def build_all(libs) -> list:
    """Build every library of `libs` that is missing, one `nvcc` process
    per source, all started together; returns their paths in order."""
    outs = [lib.library_path() for lib in libs]
    jobs = []
    for lib, out in zip(libs, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(lib.source)]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs.append((proc, cmd, tmp, out, log))
    failed = []
    for proc, cmd, tmp, out, log in jobs:
        if proc.wait() != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log.read_text()}")
            continue
        os.replace(tmp, out)       # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs
