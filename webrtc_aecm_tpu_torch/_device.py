"""The device the port's entry points build on unless told otherwise."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None.  A CUDA device without a
    card raises: the port never falls back to the CPU on its own; the CPU is
    used only when the caller asks for it (device="cpu")."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} asked for{' by default' if device is None else ''}"
            ", but no CUDA device is available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev
