"""Move state between the JAX package and the port, leaf by leaf.

Two pairs, one per engine:

* `fused_state_from_numpy` / `fused_state_to_numpy`: the fused engine's
  `fused.FusedState`;
* `aecm_state_from_numpy` / `aecm_state_to_numpy`: the batch-major engine's
  `control.AecmState` (leaves with a leading stream axis).

`*_from_numpy` takes the JAX package's state with numpy leaves (e.g.
`jax.tree_util.tree_map(np.asarray, state)`, or any object tree with the
same field names) and builds the port's state on a device (the CUDA card
unless the caller asks for another); `*_to_numpy` goes back, returning the
port's NamedTuples with numpy leaves in the JAX dtypes.  Field order is the
same in both packages, so the leaf lists line up one to one.

The dtype differences: uint32 leaves (the CNG seed and the two binary
histories of the delay estimator) are int64 carriers in the port, and the
batch-major far history, uint16 in the JAX package, is int32.  The circular
far-history head of the fused serving loops is a plain int beside the state
in both packages; it passes through unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _device, control, core as core_mod, delay_estimator as de, fused
from .ops import ring_buffer as rbuf

U32_LEAVES = ("core.seed", "core.de_farend.binary_history",
              "core.de_near.binary_history")
U16_LEAVES = ("core.far_history",)   # batch-major only

_CORE_TYPES = {"core": core_mod.CoreState, "core.de_farend": de.FarendState,
               "core.de_near": de.NearState}
_FUSED_TYPES = {"": fused.FusedState, "ctrl": fused.CtrlState,
                "ctrl.farend_buf": rbuf.RingBuffer, **_CORE_TYPES}
_AECM_TYPES = {"": control.AecmState, "farend_buf": rbuf.RingBuffer,
               **_CORE_TYPES}


def _build(path, src, leaf_fn, types):
    cls = types.get(path)
    if cls is None:
        return leaf_fn(path, src)
    prefix = path + "." if path else ""
    return cls(*[_build(prefix + f, getattr(src, f), leaf_fn, types)
                 for f in cls._fields])


def _from_numpy(tree, device, types):
    device = _device.resolve(device)

    def leaf(path, x):
        a = np.asarray(x)
        if path in U32_LEAVES:
            a = a.astype(np.uint32).astype(np.int64)
        elif path in U16_LEAVES and a.dtype == np.uint16:
            a = a.astype(np.int32)
        elif a.dtype in (np.uint32, np.uint16):
            raise TypeError(f"unexpected {a.dtype} leaf {path}")
        return torch.as_tensor(np.array(a, copy=True), device=device)
    return _build("", tree, leaf, types)


def _to_numpy(state, types, u16_leaves=()):
    def leaf(path, x):
        a = x.detach().cpu().numpy()
        for names, dtype in ((U32_LEAVES, np.uint32), (u16_leaves, np.uint16)):
            if path in names:
                hi = np.iinfo(dtype).max
                if a.min(initial=0) < 0 or a.max(initial=0) > hi:
                    raise ValueError(f"{path} holds a value outside {dtype}")
                a = a.astype(dtype)
        return a
    return _build("", state, leaf, types)


def fused_state_from_numpy(tree, device=None) -> fused.FusedState:
    """JAX FusedState (numpy leaves) -> port FusedState on `device`."""
    return _from_numpy(tree, device, _FUSED_TYPES)


def fused_state_to_numpy(state: fused.FusedState) -> fused.FusedState:
    """Port FusedState -> the same tree with numpy leaves in the JAX
    package's dtypes (uint32 carriers become uint32)."""
    return _to_numpy(state, _FUSED_TYPES)


def aecm_state_from_numpy(tree, device=None) -> control.AecmState:
    """JAX batched control.AecmState (numpy leaves) -> port AecmState on
    `device` (far history uint16 -> int32)."""
    return _from_numpy(tree, device, _AECM_TYPES)


def aecm_state_to_numpy(state: control.AecmState) -> control.AecmState:
    """Port AecmState -> the same tree with numpy leaves in the JAX
    package's dtypes (uint32 carriers and the int32 far history become
    uint32 and uint16)."""
    return _to_numpy(state, _AECM_TYPES, U16_LEAVES)
