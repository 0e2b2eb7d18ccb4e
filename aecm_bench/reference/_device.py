"""The device the port's entry points build on unless told otherwise."""
from __future__ import annotations

import functools
import numbers

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


@functools.lru_cache(maxsize=None)
def const(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-d constant, made once per device: a step that uses it copies no
    host data (which a CUDA graph capture refuses).  Never modify it."""
    return torch.tensor(value, dtype=dtype, device=device)


def as_int32(x, device: torch.device, shape=()) -> torch.Tensor:
    """x as an int32 tensor on `device`: a tensor is converted (a no-op when
    it is one already), a Python number is filled in on the device (no host
    copy, so a capture records it as a constant), anything else (a numpy
    array, a list) is copied from the host.  Numbers take `shape`."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int32)
    if isinstance(x, numbers.Real):
        return torch.full(shape, x, dtype=torch.int32, device=device)
    return torch.as_tensor(x, dtype=torch.int32, device=device)
