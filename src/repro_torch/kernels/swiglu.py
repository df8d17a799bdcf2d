"""Fused SwiGLU, ``silu(x @ w_gate) * (x @ w_up)``: the CUDA kernel's
wrapper and its plain PyTorch version.

The kernel (``csrc/swiglu.cu``) replaces the TPU kernel
``src/repro/kernels/swiglu.py:swiglu``; in the port it carries the dense
FFN's gate and up products.  ``swiglu_ref`` ports
``src/repro/kernels/swiglu.py:swiglu_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def swiglu_ref(x: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor) -> torch.Tensor:
    """Plain version: both products accumulated in f32, the epilogue in
    f32, the result in x's dtype.  x: (M, K); w_gate/w_up: (K, N)."""
    g = torch.matmul(x.float(), w_gate.float())
    u = torch.matmul(x.float(), w_up.float())
    return (g * torch.sigmoid(g) * u).to(x.dtype)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"swiglu kernel: {what}")


def swiglu_cuda(x: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (same contract as ``swiglu_ref``).  Raises on
    any input the kernel does not take and on a failed launch."""
    dev = x.device
    _check(dev.type == "cuda", "x is not a CUDA tensor")
    _check(w_gate.device == dev and w_up.device == dev,
           "x, w_gate and w_up must share a device")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} (float32 or bfloat16)")
    _check(w_gate.dtype == x.dtype and w_up.dtype == x.dtype,
           "x, w_gate and w_up must share a dtype")
    _check(x.dim() == 2 and w_gate.dim() == 2, "x (M, K), weights (K, N)")
    m, k = x.shape
    n = w_gate.shape[1]
    _check(tuple(w_gate.shape) == (k, n) and tuple(w_up.shape) == (k, n),
           f"shapes x {tuple(x.shape)} w_gate {tuple(w_gate.shape)} "
           f"w_up {tuple(w_up.shape)}")
    _check(x.is_contiguous() and w_gate.is_contiguous()
           and w_up.is_contiguous(), "inputs must be contiguous")
    if x.dtype == torch.bfloat16:
        _check(k % 8 == 0 and n % 8 == 0, "bf16 needs K and N % 8 == 0")
        for name, a in (("x", x), ("w_gate", w_gate), ("w_up", w_up)):
            _check(a.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    _check(-(-m // 64) < 65536, "M too large for one launch")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    fn = build.build().fn("swiglu")
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                out.data_ptr(), _DTYPES[x.dtype], m, n, k,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"swiglu kernel launch failed: {rc}")
    swiglu_cuda.launches += 1
    return out


swiglu_cuda.launches = 0
