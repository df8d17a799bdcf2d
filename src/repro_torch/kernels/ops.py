"""Kernel entry points, chosen by the device of their tensors.

A CUDA tensor always goes to the hand-written kernel (which raises on what
it does not take); a CPU tensor goes to the kernel's plain PyTorch version.
There is no environment override and no fallback.  ``impl="plain"`` asks
for the plain version on any device; it exists for one caller, the
whole-forward comparison in ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.packed_attention import (packed_attention_cuda,
                                                  packed_attention_ref)
from repro_torch.kernels.swiglu import swiglu_cuda, swiglu_ref

IMPLS = (None, "plain")


def _use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "plain" or x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {x.device}")


def packed_attention(q, k_cache, v_cache, token_slot, lengths, *,
                     kv_bucket: Optional[int] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Segment-masked attention over a token-packed stream (DESIGN.md §8):
    token t attends rows [0, lengths[t]) of slot ``token_slot[t]``'s cache;
    ``kv_bucket`` bounds the swept rows (DESIGN.md §9)."""
    fn = packed_attention_cuda if _use_kernel(q, impl) else packed_attention_ref
    return fn(q, k_cache, v_cache, token_slot, lengths, kv_bucket=kv_bucket)


def swiglu(x, w_gate, w_up, *, impl: Optional[str] = None) -> torch.Tensor:
    """``silu(x @ w_gate) * (x @ w_up)``; x (M, K), weights (K, N)."""
    fn = swiglu_cuda if _use_kernel(x, impl) else swiglu_ref
    return fn(x, w_gate, w_up)
