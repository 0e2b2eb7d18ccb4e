"""Batched AECM state: N independent streams with a leading stream axis.

Port of `create_batch` from webrtc_aecm_tpu/parallel/batch.py.  All streams
start identical (the reference's Create+Init is deterministic,
aecm_core.cc:179-473), so the batch is one instance repeated.
"""
from __future__ import annotations

from .. import control
from .._tree import tree_map


def create_batch(n_streams: int, sample_rate: int = 8000,
                 cng_mode: int = 1, echo_mode: int = 3,
                 device=None) -> control.AecmState:
    """N freshly Create+Init'ed instances as one state with (n_streams,
    ...) leaves (contiguous copies, not broadcast views)."""
    one = control.set_config(control.create(sample_rate, device=device),
                             cng_mode, echo_mode)
    return tree_map(lambda leaf: leaf.expand((n_streams,) + leaf.shape
                                             ).contiguous(), one)
