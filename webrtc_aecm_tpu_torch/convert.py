"""Move a fused state between the JAX package and the port, leaf by leaf.

`fused_state_from_numpy` takes the JAX package's `fused.FusedState` with
numpy leaves (e.g. `jax.tree_util.tree_map(np.asarray, state)`, or any
object tree with the same field names) and builds the port's FusedState on
a device; `fused_state_to_numpy` goes back, returning the port's
NamedTuples with numpy leaves in the JAX dtypes.  Field order is the same
in both packages, so the leaf lists line up one to one.

The only dtype difference: uint32 leaves (the CNG seed and the two binary
histories of the delay estimator) are int64 carriers in the port.  The
circular far-history head is a plain int beside the state in both
packages' serving loops; `head` passes through unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from . import core as core_mod, delay_estimator as de, fused
from .ops import ring_buffer as rbuf

U32_LEAVES = ("core.seed", "core.de_farend.binary_history",
              "core.de_near.binary_history")

_TYPES = {"": fused.FusedState, "ctrl": fused.CtrlState,
          "ctrl.farend_buf": rbuf.RingBuffer, "core": core_mod.CoreState,
          "core.de_farend": de.FarendState, "core.de_near": de.NearState}


def _build(path, src, leaf_fn):
    cls = _TYPES.get(path)
    if cls is None:
        return leaf_fn(path, src)
    prefix = path + "." if path else ""
    return cls(*[_build(prefix + f, getattr(src, f), leaf_fn)
                 for f in cls._fields])


def fused_state_from_numpy(tree, device=None) -> fused.FusedState:
    """JAX FusedState (numpy leaves) -> port FusedState on `device`."""
    def leaf(path, x):
        a = np.asarray(x)
        if path in U32_LEAVES:
            a = a.astype(np.uint32).astype(np.int64)
        elif a.dtype == np.uint32:
            raise TypeError(f"unexpected uint32 leaf {path}")
        return torch.as_tensor(np.array(a, copy=True), device=device)
    return _build("", tree, leaf)


def fused_state_to_numpy(state: fused.FusedState) -> fused.FusedState:
    """Port FusedState -> the same tree with numpy leaves in the JAX
    package's dtypes (uint32 carriers become uint32)."""
    def leaf(path, x):
        a = x.detach().cpu().numpy()
        if path in U32_LEAVES:
            if a.min(initial=0) < 0 or a.max(initial=0) > 0xFFFFFFFF:
                raise ValueError(f"{path} holds a value outside uint32")
            a = a.astype(np.uint32)
        return a
    return _build("", state, leaf)

