"""PyTorch/CUDA port of the NanoFlow serving system (``repro`` is the JAX
reference it is held against).

The port imports ``torch`` and never ``jax`` or any ``repro`` module.  Its
entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for the card where none is present raises.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  A CUDA device without a card raises — the port never moves to
    the CPU on its own."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:       # compare equal to tensors' devices
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
