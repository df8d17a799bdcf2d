"""Checkpointing with atomic commit, retention and restore onto named
devices (port of ``repro.distributed.checkpoint``), in the JAX package's
on-disk layout, so that either package reads the other's checkpoints.

Layout (one directory per step):
    <dir>/step_00000420/
        METADATA.json        — {"step", "leaves": {name: {shape, dtype}}}
        <leaf-path>.npy      — one file per leaf

A leaf's name is its path joined with ``__``: dict keys (sorted) as they
are, list items as ``[i]``.  bfloat16 leaves are stored as a uint16 view
(``np.save`` has no bfloat16) with ``"bfloat16"`` in the metadata.  Writes
go to ``step_XXXXXXXX.tmp`` and are renamed on completion, so a crash
mid-save never corrupts the latest checkpoint.  ``restore`` puts each leaf
on the device it is given: one ``torch.device`` for all, or a tree
congruent with the template (JAX's ``shardings`` at one process).  Leaves
are written and read by a few threads at once (the device copies and the
file I/O of one leaf overlap another's); the files are JAX's.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

SEP = "__"
IO_THREADS = 8


def _flatten(tree: Any, path: tuple[str, ...] = ()) -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], path + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, path + (f"[{i}]",)))
    else:
        out[SEP.join(path)] = tree
    return out


def _unflatten(flat: dict[str, Any], template: Any,
               path: tuple[str, ...] = ()):
    if isinstance(template, dict):
        return {k: _unflatten(flat, template[k], path + (str(k),))
                for k in template}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten(flat, v, path + (f"[{i}]",))
               for i, v in enumerate(template)]
        return type(template)(seq) if isinstance(template, tuple) else seq
    return flat[SEP.join(path)]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array np.save writes, the dtype the metadata records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str,
                device: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")      # a copy, 0-d leaves kept 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(tree: Any, directory: str, step: int) -> str:
    """Atomic checkpoint write.  Returns the committed path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    def write(item):
        name, leaf = item
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        return name, {"shape": list(arr.shape), "dtype": dtype}
    with ThreadPoolExecutor(IO_THREADS) as pool:
        meta = {"step": step,
                "leaves": dict(pool.map(write, _flatten(tree).items()))}
    with open(os.path.join(tmp, "METADATA.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, template: Any, step: Optional[int] = None,
            devices: Optional[Any] = None) -> tuple[Any, int]:
    """Load a checkpoint (the latest unless ``step``) into the structure
    of ``template``.  ``devices``: a ``torch.device`` (or name) for every
    leaf, or a tree congruent with the template; by default each leaf
    lands on its template leaf's device (the CPU for a non-tensor).
    Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "METADATA.json")) as f:
        meta = json.load(f)
    if devices is None:
        where = {n: getattr(t, "device", torch.device("cpu"))
                 for n, t in _flatten(template).items()}
    elif isinstance(devices, (str, torch.device)):
        where = {n: torch.device(devices) for n in _flatten(template)}
    else:
        where = {n: torch.device(d) for n, d in _flatten(devices).items()}

    def read(item):
        name, info = item
        arr = np.load(os.path.join(path, name + ".npy"))
        return name, _from_numpy(arr, info["dtype"],
                                 where.get(name, torch.device("cpu")))
    with ThreadPoolExecutor(IO_THREADS) as pool:
        flat = dict(pool.map(read, meta["leaves"].items()))
    return _unflatten(flat, template), step


def retain(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


class CheckpointManager:
    """save-every-N + retention + restore-or-init, used by the train
    driver."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, tree: Any, step: int, force: bool = False) -> bool:
        if not force and (step == 0 or step % self.every):
            return False
        save(tree, self.directory, step)
        retain(self.directory, self.keep)
        return True

    def restore_or_none(self, template: Any, devices=None):
        try:
            return restore(self.directory, template, devices=devices)
        except FileNotFoundError:
            return None
