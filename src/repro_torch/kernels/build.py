"""Build and load the port's CUDA kernels.

Each target compiles one ``csrc/*.cu`` source with ``nvcc`` (plus the
target's ``-D`` switches) into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), keyed by a hash
of the source, the ``csrc/*.cuh`` headers and the flags, under
``build/repro_torch_kernels/`` at the repository root.  All targets
compile in parallel, one ``nvcc`` each, at first use; later calls in the
process reuse the loaded libraries.  A missing ``nvcc`` or a failed build
raises — there is no other path for a CUDA tensor.
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


# target -> (source, its compile-time switches).  The four packed-attention
# variants are one source built with two switches (csrc/packed_attention.cu);
# decode attention, paged decode attention (a second C entry of
# csrc/decode_attention.cu, in its library) and the fused op share the unit
# of csrc/attn_decode.cuh, SwiGLU and the fused op the GEMM mainloop of
# csrc/gemm_sm90.cuh, as does MLA's latent attention.
def _pa(quant: int, block_table: int) -> tuple[str, tuple[str, ...]]:
    return ("packed_attention", (f"-DREPRO_PA_QUANT={quant}",
                                 f"-DREPRO_PA_BLOCK_TABLE={block_table}"))


TARGETS = {
    "packed_attention": _pa(0, 0),
    "packed_attention_quant": _pa(1, 0),
    "packed_attention_block": _pa(0, 1),
    "packed_attention_block_quant": _pa(1, 1),
    "decode_attention": ("decode_attention", ()),
    "fused_overlap": ("fused_overlap", ()),
    "flash_attention": ("flash_attention", ()),
    "swiglu": ("swiglu", ()),
    "ssm_scan": ("ssm_scan", ()),
    "mla_attention": ("mla_attention", ()),
}

_c = ctypes
_void_p, _int, _ll, _float = _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_float
# argtypes of each source's first C entry point
SIGNATURES = {
    "packed_attention": ("repro_packed_attention",
                         [_void_p] * 12 + [_int] * 13 + [_ll] * 6
                         + [_float, _void_p]),
    "flash_attention": ("repro_flash_attention",
                        [_void_p] * 7 + [_int] * 10 + [_ll] * 4
                        + [_float, _void_p]),
    "swiglu": ("repro_swiglu", [_void_p] * 4 + [_int] * 7 + [_void_p]),
    "ssm_scan": ("repro_ssm_scan",
                 [_void_p] * 9 + [_int] * 5 + [_ll] * 4 + [_void_p]),
    "decode_attention": ("repro_decode_attention",
                         [_void_p] * 8 + [_int] * 7 + [_ll] * 4
                         + [_float, _void_p, _void_p]),
    "mla_attention": ("repro_mla_attention",
                      [_void_p] * 9 + [_int] * 7 + [_ll] * 4
                      + [_float, _void_p]),
    "fused_overlap": ("repro_fused_overlap",
                      [_void_p] * 11 + [_int] * 10 + [_ll] * 4
                      + [_float, _float, _void_p, _void_p]),
}
# name -> (target whose library holds it, C entry, argtypes): the further C
# entry points of a library
ENTRIES = {
    "paged_decode_attention": ("decode_attention",
                               "repro_paged_decode_attention",
                               [_void_p] * 9 + [_int] * 8 + [_ll] * 2
                               + [_float, _void_p, _void_p]),
}


class KernelLibs:
    """The loaded kernel libraries: ``fn(name)`` is the ctypes function of
    target ``name``'s first C entry, or of the further entry ``name`` of
    ``ENTRIES``; ``build_seconds`` and ``ptxas_log`` record the build."""

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


def _digest(source: str, defines: tuple[str, ...]) -> str:
    """Key of one target's library: the flags, the source and every header
    of ``csrc`` (a source may include any of them)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for path in [CSRC / f"{source}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> KernelLibs:
    """Compile (if needed) and load every kernel library; idempotent."""
    global _LIBS
    if _LIBS is not None:
        return _LIBS
    t0 = time.perf_counter()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    targets = {n: BUILD_ROOT / f"lib{n}-{_digest(*TARGETS[n])}.so"
               for n in TARGETS}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        source, defines = TARGETS[name]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs = []
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"--- {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    fns = {}
    bound = [(name, name, *SIGNATURES[TARGETS[name][0]]) for name in TARGETS]
    bound += [(name, *entry) for name, entry in ENTRIES.items()]
    libs = {name: ctypes.CDLL(str(so)) for name, so in targets.items()}
    for name, target, sym, argtypes in bound:
        fn = getattr(libs[target], sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    _LIBS = KernelLibs(fns, time.perf_counter() - t0, "\n".join(logs))
    return _LIBS
