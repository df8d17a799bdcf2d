"""Tensor-parallel process groups (port of ``repro.launch.mesh``'s
``make_tp_mesh``; DESIGN.md §11).

JAX runs tp = N as one program over a 1-D ``("model",)`` mesh of N local
devices.  The port runs it as N SPMD processes, one rank each, in a
``torch.distributed`` group: ``spawn_tp`` starts them, with a ``FileStore``
rendezvous in a temporary directory (no address, no network), and each
rank's engine takes the group from ``make_tp_group``.

Backends: ``nccl`` on ``cuda`` (one rank per card), ``gloo`` on the CPU.
``gloo`` also takes CUDA tensors, staging each collective through the
host, which lets two ranks share one card (``backend="gloo"``): the
kernels then run at their real shard shapes and the collectives are real,
but the collectives cost host copies.  Nothing switches backend on its
own: ``nccl`` with fewer cards than ranks raises.

JAX's ``tp_size`` is ``torch.distributed.get_world_size`` here.
``make_production_mesh`` and ``dp_size`` belong to the dry run and are not
ported (ROADMAP A14).
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

# one host-side gloo group per process: the engines' agreement on what has
# landed (``host_group``)
_HOST: dict = {}


def default_backend(device: str | torch.device) -> str:
    """``nccl`` for ``cuda``, ``gloo`` for ``cpu``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_backend(tp: int, device: torch.device, backend: str) -> None:
    if backend == "nccl":
        if device.type != "cuda":
            raise RuntimeError(f"backend nccl needs a cuda device, not "
                               f"{device}; the CPU uses gloo")
        n = torch.cuda.device_count()
        if n < tp:
            raise RuntimeError(
                f"tp={tp} over nccl needs {tp} cards, one rank each, but "
                f"{n} are visible; pass backend='gloo' to share one card "
                f"through the host, or run on a {tp}-card host")
    elif backend != "gloo":
        raise RuntimeError(f"backend {backend!r}: nccl or gloo")


def make_tp_group(tp: int, device: str | torch.device,
                  backend: Optional[str] = None):
    """The current default process group, checked: it exists, has ``tp``
    ranks, and its backend serves ``device`` (``backend``, when given, must
    be the group's).  Otherwise an actionable ``RuntimeError``."""
    device = torch.device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"tp={tp} needs a torch.distributed process group of {tp} "
            "ranks and none is initialized; start the ranks with "
            "repro_torch.launch.mesh.spawn_tp (or torchrun)")
    world = dist.get_world_size()
    if world != tp:
        raise RuntimeError(f"tp={tp} needs a process group of {tp} ranks; "
                           f"the initialized group has {world}")
    have = dist.get_backend()
    if backend is not None and have != backend:
        raise RuntimeError(f"asked for backend {backend!r}; the initialized "
                           f"group runs {have!r}")
    _check_backend(tp, device, have)
    return dist.group.WORLD


def host_group():
    """A gloo group over the ranks of the default group, for host-side
    agreement that must never sync the device: the default group itself
    when it runs gloo, else one made once per process (a collective call:
    every rank makes it at the same point, in engine construction)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    key = id(dist.group.WORLD)
    if key not in _HOST:
        _HOST.clear()
        _HOST[key] = dist.new_group(backend="gloo")
    return _HOST[key]


def _rank_main(rank: int, tp: int, fn: Callable, args: tuple,
               device_type: str, backend: str, tmp: str,
               timeout_s: float) -> None:
    """One rank: bind its card (``cuda:rank``, or ``cuda:0`` for ranks
    sharing a card over gloo), join the group through the file store, run
    ``fn(*args)``; rank 0 leaves its result in ``tmp``."""
    # gloo and NCCL bootstrap over the loopback: the ranks share one host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device_type == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), tp),
        rank=rank, world_size=tp,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        if rank == 0:
            path = os.path.join(tmp, "result.pkl")
            with open(path + ".tmp", "wb") as f:
                pickle.dump(result, f)
            os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def spawn_tp(tp: int, fn: Callable, *args, device: str | torch.device,
             backend: Optional[str] = None,
             timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """Run ``fn(*args)`` on ``tp`` ranks (``torch.multiprocessing.spawn``:
    fresh interpreters, so ``fn`` must be importable, and CUDA may already
    be initialised here) and return rank 0's result.  ``backend`` defaults
    to ``default_backend(device)``; nccl with fewer cards than ranks
    raises.  A rank that raises stops the others and the call raises;
    ``timeout_s`` bounds each collective."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    _check_backend(tp, device, backend)
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(tp, fn, args, device.type, backend, tmp,
                              timeout_s), nprocs=tp, join=True)
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
