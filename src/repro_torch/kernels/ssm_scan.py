"""Mamba-1 selective scan: the CUDA kernel's wrapper and its plain PyTorch
versions.

``h_t = exp(dt_t·a)·h_{t-1} + dt_t·x_t·b_t``, ``y_t = h_t·c_t + d·x_t``
per channel, with a (C, N) state per batch row.  The kernel
(``csrc/ssm_scan.cu``) replaces the TPU kernel
``src/repro/kernels/ssm_scan.py:ssm_scan``; in the port it carries
``models.ssm.mamba_full``, the legacy step's prefill chunks and recompute
prefill.  ``ssm_scan_ref`` and ``ssm_step_ref`` port
``src/repro/kernels/ref.py:ssm_scan_ref/ssm_step_ref``; the first is what
the CPU runs and what the card's kernel is held against, the second is
the one-token step of decode and of the packed step (plain ops, as in
JAX).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATES = (16, 32, 64)       # the state sizes the kernel is built for


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                 h0: Optional[torch.Tensor] = None):
    """Plain version.  x: (B, S, C); dt: (B, S, C) positive steps; a: (C,
    N); b, c: (B, S, N); d: (C,); h0: (B, C, N) or None for zeros.  Every
    input is taken in f32; returns (y (B, S, C) in x's dtype, h_final (B,
    C, N) f32)."""
    bsz, s, ch = x.shape
    n = a.shape[-1]
    h = torch.zeros((bsz, ch, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    x32, dt32 = x.float(), dt.float()
    b32, c32, a32 = b.float(), c.float(), a.float()
    ys = []
    for t in range(s):
        da = torch.exp(dt32[:, t, :, None] * a32)
        h = da * h + (dt32[:, t] * x32[:, t])[..., None] * b32[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, c32[:, t]))
    y = (torch.stack(ys, dim=1) if ys else torch.zeros_like(x32)) + \
        x32 * d.float()
    return y.to(x.dtype), h


def ssm_step_ref(x_t: torch.Tensor, dt_t: torch.Tensor, a: torch.Tensor,
                 b_t: torch.Tensor, c_t: torch.Tensor, d: torch.Tensor,
                 h: torch.Tensor):
    """One decode step.  x_t, dt_t: (B, C); b_t, c_t: (B, N); h: (B, C, N)
    f32.  Returns (y (B, C) in x_t's dtype, new h)."""
    da = torch.exp(dt_t.float()[..., None] * a.float())
    h = da * h + (dt_t * x_t).float()[..., None] * b_t.float()[:, None, :]
    y = torch.einsum("bcn,bn->bc", h, c_t.float()) + x_t.float() * d
    return y.to(x_t.dtype), h


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"ssm_scan kernel: {what}")


def _row_stride(t: torch.Tensor, name: str) -> int:
    """Elements between consecutive (batch, position) rows of a (B, S, W)
    tensor whose last axis is contiguous and whose rows are evenly spaced
    (a column slice of a projection is taken as it is)."""
    bsz, s, w = t.shape
    _check(t.stride(2) == 1 or w == 1, f"{name}: last axis not contiguous")
    if s <= 1:                      # one row per batch row
        return t.stride(0)
    _check(bsz == 1 or t.stride(0) == s * t.stride(1),
           f"{name}: rows not evenly spaced")
    return t.stride(1)


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                  h0: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel (same contract as ``ssm_scan_ref``, with dt,
    a, d and h0 in f32 and b, c in x's dtype; N in ``STATES``).  Raises on
    any input the kernel does not take and on a failed launch; counts
    launches in ``ssm_scan_cuda.launches``."""
    dev = x.device
    _check(dev.type == "cuda", "x is not a CUDA tensor")
    _check(x.dtype in _DTYPES, f"x dtype {x.dtype} (float32 or bfloat16)")
    _check(x.dim() == 3 and dt.shape == x.shape,
           f"x {tuple(x.shape)} and dt {tuple(dt.shape)} must be (B, S, C)")
    bsz, s, ch = x.shape
    _check(a.dim() == 2 and a.shape[0] == ch, f"a {tuple(a.shape)} not (C, N)")
    n = a.shape[1]
    _check(n in STATES, f"state size {n} (built for {STATES})")
    _check(b.shape == (bsz, s, n) and c.shape == (bsz, s, n),
           f"b {tuple(b.shape)} and c {tuple(c.shape)} must be (B, S, N)")
    _check(d.shape == (ch,), f"d {tuple(d.shape)} not (C,)")
    _check(b.dtype == x.dtype and c.dtype == x.dtype,
           "b and c must have x's dtype")
    for name, t in (("dt", dt), ("a", a), ("d", d), ("h0", h0)):
        _check(t is None or t.dtype == torch.float32, f"{name} must be f32")
    if h0 is not None:
        _check(h0.shape == (bsz, ch, n), f"h0 {tuple(h0.shape)} not (B, C, N)")
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c), ("d", d),
                    ("h0", h0)):
        _check(t is None or t.device == dev, f"{name} is on another device")
    for name, t in (("a", a), ("d", d), ("h0", h0)):
        _check(t is None or t.is_contiguous(), f"{name} must be contiguous")
    strides = [_row_stride(t, name) for name, t in
               (("x", x), ("dt", dt), ("b", b), ("c", c))]
    _check(bsz < 65536, "B too large for one launch")
    y = torch.empty((bsz, s, ch), dtype=x.dtype, device=dev)
    h_out = torch.empty((bsz, ch, n), dtype=torch.float32, device=dev)
    fn = build.build().fn("ssm_scan")
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), d.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(),
                h_out.data_ptr(), _DTYPES[x.dtype], bsz, s, ch, n, *strides,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: {rc}")
    ssm_scan_cuda.launches += 1
    return y, h_out


ssm_scan_cuda.launches = 0
