"""Binary-spectrum delay estimator state (PyTorch port).

Port of the state half of webrtc_aecm_tpu/delay_estimator.py (reference:
aecm/delay_estimator.{h,cc}, aecm/delay_estimator_wrapper.{h,cc}): the two
state tuples, their creation, and the fixed-point mean estimator.  The
per-block estimator itself runs lane-major in fused.py (and in the frames
kernel), as in the JAX package.

uint32 leaves (the binary histories) are carried in int64 tensors holding
[0, 2^32), the convention of ops/spl.py.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import defines as D

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32


class FarendState(NamedTuple):
    """Far-end half (delay_estimator.h:30-38 + wrapper mean spectrum)."""
    binary_history: torch.Tensor      # (history,) uint32 carrier (int64)
    bit_counts: torch.Tensor          # (history,) int32
    mean_spectrum: torch.Tensor       # (spectrum_size,) int32 (Q15)
    spectrum_initialized: torch.Tensor  # int32 scalar bool


class NearState(NamedTuple):
    """Near-end half (delay_estimator.h:40-63 + wrapper mean spectrum)."""
    mean_spectrum: torch.Tensor       # (spectrum_size,) int32 (Q15)
    spectrum_initialized: torch.Tensor
    binary_history: torch.Tensor      # (lookahead+1,) uint32 carrier (int64)
    bit_counts: torch.Tensor          # (history,) int32
    mean_bit_counts: torch.Tensor     # (history+1,) int32 Q9 (+1 dummy slot)
    histogram: torch.Tensor           # (history+1,) float32
    minimum_probability: torch.Tensor   # int32 Q9
    last_delay_probability: torch.Tensor  # int32 Q9
    last_delay: torch.Tensor          # int32 (-2 before a first estimate)
    last_candidate_delay: torch.Tensor  # int32
    compare_delay: torch.Tensor       # int32
    candidate_hits: torch.Tensor      # int32
    last_delay_histogram: torch.Tensor  # float32
    allowed_offset: torch.Tensor      # int32
    lookahead: torch.Tensor           # int32
    robust_validation_enabled: torch.Tensor  # int32 bool


def _scalar(v, dtype=I32, device=None):
    return torch.tensor(v, dtype=dtype, device=device)


def create_farend(history_size: int = D.MAX_DELAY,
                  spectrum_size: int = D.PART_LEN1,
                  device=None) -> FarendState:
    """WebRtc_CreateDelayEstimatorFarend + Init
    (delay_estimator_wrapper.cc:173-225), fixed-point spectra."""
    return FarendState(
        binary_history=torch.zeros((history_size,), dtype=I64,
                                   device=device),
        bit_counts=torch.zeros((history_size,), dtype=I32, device=device),
        mean_spectrum=torch.zeros((spectrum_size,), dtype=I32,
                                  device=device),
        spectrum_initialized=_scalar(0, device=device),
    )


def create_near(history_size: int = D.MAX_DELAY,
                spectrum_size: int = D.PART_LEN1,
                max_lookahead: int = 0,
                robust_validation: bool = False,
                device=None) -> NearState:
    """WebRtc_CreateDelayEstimator + Init (delay_estimator_wrapper.cc:
    306-355, delay_estimator.cc:408-504), fixed-point spectra."""
    return NearState(
        mean_spectrum=torch.zeros((spectrum_size,), dtype=I32,
                                  device=device),
        spectrum_initialized=_scalar(0, device=device),
        binary_history=torch.zeros((max_lookahead + 1,), dtype=I64,
                                   device=device),
        bit_counts=torch.zeros((history_size,), dtype=I32, device=device),
        mean_bit_counts=torch.full((history_size + 1,), 20 << 9, dtype=I32,
                                   device=device),
        histogram=torch.zeros((history_size + 1,), dtype=F32, device=device),
        minimum_probability=_scalar(D.MAX_BITCOUNTS_Q9, device=device),
        last_delay_probability=_scalar(D.MAX_BITCOUNTS_Q9, device=device),
        last_delay=_scalar(-2, device=device),
        last_candidate_delay=_scalar(-2, device=device),
        compare_delay=_scalar(history_size, device=device),
        candidate_hits=_scalar(0, device=device),
        last_delay_histogram=_scalar(0.0, F32, device=device),
        allowed_offset=_scalar(0, device=device),
        lookahead=_scalar(max_lookahead, device=device),
        robust_validation_enabled=_scalar(1 if robust_validation else 0,
                                          device=device),
    )


def mean_estimator_fix(new_value, factor, mean_value):
    """WebRtc_MeanEstimatorFix (delay_estimator.cc:690-702); factor may be
    an int or a per-element int32 tensor."""
    diff = new_value.to(I32) - mean_value.to(I32)
    step = torch.where(diff < 0, -((-diff) >> factor), diff >> factor)
    return (mean_value + step).to(I32)
