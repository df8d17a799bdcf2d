"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
keyed by a hash of the sources and the flags, under
``build/repro_torch_kernels/`` at the repository root.  All sources compile
in parallel, one ``nvcc`` each, at first use; later calls in the process
reuse the loaded libraries.  A missing ``nvcc`` or a failed build raises —
there is no other path for a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("packed_attention", "swiglu")

_c = ctypes
_void_p, _int, _ll, _float = _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_float
# argtypes of each library's one C entry point
SIGNATURES = {
    "packed_attention": ("repro_packed_attention",
                         [_void_p] * 6 + [_int] * 7 + [_ll] * 4
                         + [_float, _void_p]),
    "swiglu": ("repro_swiglu", [_void_p] * 4 + [_int] * 4 + [_void_p]),
}


class KernelLibs:
    """The loaded kernel libraries: ``fn(name)`` is the ctypes function of
    source ``name``; ``build_seconds`` and ``ptxas_log`` record the build."""

    def __init__(self, fns: dict, build_seconds: float, ptxas_log: str):
        self._fns = fns
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log

    def fn(self, name: str):
        return self._fns[name]


_LIBS: KernelLibs | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/kernels/csrc at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return h.hexdigest()[:16]


def build() -> KernelLibs:
    """Compile (if needed) and load every kernel library; idempotent."""
    global _LIBS
    if _LIBS is not None:
        return _LIBS
    t0 = time.perf_counter()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    targets = {n: BUILD_ROOT / f"lib{n}-{_digest(n)}.so" for n in SOURCES}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs = []
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"--- {name}.cu\n{out}")
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    fns = {}
    for name, so in targets.items():
        lib = ctypes.CDLL(str(so))
        sym, argtypes = SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    _LIBS = KernelLibs(fns, time.perf_counter() - t0, "\n".join(logs))
    return _LIBS
