"""Fused SwiGLU, ``silu(x @ w_gate) * (x @ w_up)``: the CUDA kernel's
wrapper, its schedule and its plain PyTorch version.

The kernel (``csrc/swiglu.cu`` on ``csrc/gemm_sm90.cuh``) replaces the TPU
kernel ``src/repro/kernels/swiglu.py:swiglu``; in the port it carries the
dense FFN's gate and up products.  ``swiglu_ref`` ports
``src/repro/kernels/swiglu.py:swiglu_ref``.  ``plan`` chooses the bf16
kernel's tile and CTA groups.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel's tiles (csrc/swiglu.cu on csrc/gemm_sm90.cuh), rows of x
# by weight columns: up to 64 rows swap-AB tiles (x's rows on wgmma's N
# side), above 128 x 128 tiles of x rows
SWAP_ROWS = (8, 16, 32, 64)
TILES = {(r, 128) for r in SWAP_ROWS + (128,)}
F32_TILE = 64      # rows of the f32 kernel's tiles, its grid's y


def swiglu_ref(x: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor) -> torch.Tensor:
    """Plain version: both products accumulated in f32, the epilogue in
    f32, the result in x's dtype.  x: (M, K); w_gate/w_up: (K, N)."""
    g = torch.matmul(x.float(), w_gate.float())
    u = torch.matmul(x.float(), w_up.float())
    return (g * torch.sigmoid(g) * u).to(x.dtype)


def plan(m: int, n: int, sms: int) -> tuple[int, int, int]:
    """(bm, bn, groups) of the bf16 kernel for x (m, K) @ (K, n) on a card
    of ``sms`` SMs: a tile of bm rows of x by bn = 128 weight columns (up
    to 64 rows the swap-AB tile of the fewest rows that hold m, else 128
    rows) and a grid of groups x mt CTAs (mt = ceil(m / bm)), one CTA per
    SM, each group taking whole column strips over all of K.  The longest
    group takes r = ceil(strips / the groups that fit one wave) strips,
    and the fewest groups that reach r run, so that no more CTAs than the
    makespan needs compete for device memory (PERF.md §6)."""
    bm = next((r for r in SWAP_ROWS if r >= m), 128)
    ns = -(-n // 128)
    per_group = -(-ns // max(1, sms // -(-m // bm)))
    return bm, 128, max(1, -(-ns // per_group))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"swiglu kernel: {what}")


def check_operands(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor) -> None:
    """Everything the kernel asks of its operands but their device: one
    dtype (f32 or bf16), x (M, K) and weights (K, N), contiguous; bf16
    also K > 0, K and N multiples of 8 and 16-byte aligned bases (TMA's
    strides and addresses).  Raises ValueError."""
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
        _check(k > 0 and k % 8 == 0 and n % 8 == 0,
               "bf16 needs K > 0 and K and N % 8 == 0")
        for name, a in (("x", x), ("w_gate", w_gate), ("w_up", w_up)):
            _check(a.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    else:
        _check(-(-m // F32_TILE) <= 65535,
               "f32 M over 65535 tiles of 64 rows (its grid's y)")


def swiglu_cuda(x: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (same contract as ``swiglu_ref``).  Raises on
    any input the kernel does not take and on a failed launch."""
    dev = x.device
    _check(dev.type == "cuda", "x is not a CUDA tensor")
    _check(w_gate.device == dev and w_up.device == dev,
           "x, w_gate and w_up must share a device")
    check_operands(x, w_gate, w_up)
    m, k = x.shape
    n = w_gate.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    fn = build.build().fn("swiglu")
    bm, bn, groups = (plan(m, n, _sms(dev.index))
                      if x.dtype == torch.bfloat16 else (0, 0, 0))
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                out.data_ptr(), _DTYPES[x.dtype], m, n, k, bm, bn, groups,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"swiglu kernel launch failed: {rc}")
    swiglu_cuda.launches += 1
    return out


swiglu_cuda.launches = 0
