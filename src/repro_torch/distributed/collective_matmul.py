"""Collective matmuls over a ``torch.distributed`` group (port of
``repro.distributed.collective_matmul``; DESIGN.md §2, §11).

``matmul_allreduce`` is the row-parallel product the packed step runs:
each rank multiplies its row block and the partials are summed in f32
over the group, then cast to the activations' dtype, as JAX sums its f32
partials and casts after.  On the GPU the idiom is not JAX's ring of
ppermutes but one NCCL all-reduce, issued with ``async_op=True`` so that
it runs on NCCL's stream while the caller enqueues the next nano-batch
group's GEMM (``matmul_allreduce_start``; ``tp.row_parallel`` issues one
per group, then waits for them all).

``allgather_matmul`` and ``matmul_reduce_scatter`` keep JAX's ring
decomposition, over ``batch_isend_irecv``: the chunk in hand is multiplied
while it travels to the next rank.  No serving path calls them; gloo has
point-to-point ops for CPU tensors only, so they run on the CPU or over
NCCL.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as an f32 partial: f32 inputs as they are; bf16 inputs on
    the card through cuBLAS's f32 output (no rounding of the partial), on
    the CPU through f32 copies."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda and x.dim() == 2:
        return torch.mm(x, w, out_dtype=torch.float32)
    return torch.matmul(x.float(), w.float())


def matmul_allreduce_start(x: torch.Tensor, w: torch.Tensor, group):
    """Enqueue ``x (m, k_local) @ w (k_local, n)`` and the f32 all-reduce
    of the partial over ``group``; returns ``(buffer, work)``: after
    ``work.wait()`` the buffer holds the sum."""
    part = matmul_f32(x, w)
    return part, dist.all_reduce(part, group=group, async_op=True)


def matmul_allreduce(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Row-parallel matmul + all-reduce, a drop-in for ``psum(x @ w)``:
    (m, n) in x's dtype, the same on every rank."""
    part, work = matmul_allreduce_start(x, w, group)
    work.wait()
    return part.to(x.dtype)


def _ring_exchange(send: torch.Tensor, to: int, frm: int, group):
    """Start sending ``send`` to group rank ``to`` and receiving a tensor of
    its shape from ``frm``; returns (receive buffer, requests)."""
    send = send.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, to),
                      group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm),
                      group)]
    return recv, dist.batch_isend_irecv(ops)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """x: (m, k_local), this rank's feature block; w: (k_total, n_local),
    all rows of this rank's column block.  Returns ``x_full @ w`` (m,
    n_local) without materialising x_full: each ring step multiplies the
    chunk in hand while it travels to rank - 1, and rank + 1's arrives."""
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    k_local = x.shape[1]
    assert w.shape[0] == k_local * p, (x.shape, w.shape)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    chunk, src = x, idx
    for _ in range(p - 1):
        nxt, reqs = _ring_exchange(chunk, (idx - 1) % p, (idx + 1) % p,
                                   group)
        acc += matmul_f32(chunk, w[src * k_local:(src + 1) * k_local])
        for r in reqs:
            r.wait()
        chunk, src = nxt, (src + 1) % p
    acc += matmul_f32(chunk, w[src * k_local:(src + 1) * k_local])
    return acc.to(x.dtype)


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor,
                          group) -> torch.Tensor:
    """x: (m, k_local); w: (k_local, n), this rank's row block.  Returns
    (m, n / p): this rank's column block of the summed product.  The
    packet for column block c starts at rank c + 1 and flows to rank + 1,
    each rank adding its contribution before passing it on, so after p - 1
    hops rank j holds block j; each hop overlaps the next block's GEMM."""
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    n = w.shape[1]
    assert n % p == 0, (n, p)
    nc = n // p
    dst = (idx - 1) % p
    acc = matmul_f32(x, w[:, dst * nc:(dst + 1) * nc])
    for _ in range(p - 1):
        recv, reqs = _ring_exchange(acc, (idx + 1) % p, (idx - 1) % p, group)
        dst = (dst - 1) % p
        part = matmul_f32(x, w[:, dst * nc:(dst + 1) * nc])
        for r in reqs:
            r.wait()
        acc = recv + part
    # dst == idx: this rank's own contribution came last
    return acc.to(x.dtype)
