"""Binary-spectrum delay estimator, fixed-point path (PyTorch port).

Port of webrtc_aecm_tpu/delay_estimator.py (reference: aecm/
delay_estimator.{h,cc}, aecm/delay_estimator_wrapper.{h,cc}): the two state
tuples and their creation, and the fixed-point path of the batch-major
engine (`add_far_spectrum_fix`, `process_fix` and what they call), on a
batch of estimators whose leaves carry a leading stream axis.  The fused
path runs its own lane-major copy in fused.py (and in the frames kernel).

Layout: the public functions take states as stored, a per-stream scalar
being a (B,) leaf.  The `_`-prefixed functions work on the lifted form, in
which those leaves are (B, 1), so that they broadcast against the (B, n)
vectors as the JAX per-stream code does; core.py calls them on a lifted
core.

uint32 leaves (the binary histories) are carried in int64 tensors holding
[0, 2^32), the convention of ops/spl.py.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _device
from . import defines as D
from .ops import spl

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32

# Leaves that are vectors per stream; every other leaf is a scalar.
_FAR_VECTORS = ("binary_history", "bit_counts", "mean_spectrum")
_NEAR_VECTORS = ("mean_spectrum", "binary_history", "bit_counts",
                 "mean_bit_counts", "histogram")


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
    device = _device.resolve(device)
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
    device = _device.resolve(device)
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


def lift(state):
    """Per-stream scalar leaves (B,) -> (B, 1) (FarendState or
    NearState); views, no copies."""
    keep = _FAR_VECTORS if isinstance(state, FarendState) else _NEAR_VECTORS
    return state._replace(**{f: getattr(state, f)[..., None]
                             for f in state._fields if f not in keep})


def lower(state):
    """Inverse of `lift`."""
    keep = _FAR_VECTORS if isinstance(state, FarendState) else _NEAR_VECTORS
    return state._replace(**{f: getattr(state, f)[..., 0]
                             for f in state._fields if f not in keep})


def enable_robust_validation(state: NearState, enable):
    """WebRtc_enable_robust_validation (delay_estimator_wrapper.cc:424-437),
    per stream: enable is 0/1 (a scalar or (B,)); other values leave the
    stream unchanged and return -1.  Returns (state, result)."""
    dev = state.robust_validation_enabled.device
    en = torch.as_tensor(enable, dtype=I32, device=dev).expand_as(
        state.robust_validation_enabled)
    valid = (en >= 0) & (en <= 1)
    return (state._replace(robust_validation_enabled=torch.where(
        valid, en, state.robust_validation_enabled)),
        torch.where(valid, 0, -1).to(I32))


# ---------------------------------------------------------------------------
# Spectrum -> binary spectrum (wrapper layer)
# ---------------------------------------------------------------------------

def mean_estimator_fix(new_value, factor, mean_value):
    """WebRtc_MeanEstimatorFix (delay_estimator.cc:690-702); factor may be
    an int or a per-element int32 tensor."""
    diff = new_value.to(I32) - mean_value.to(I32)
    step = torch.where(diff < 0, -((-diff) >> factor), diff >> factor)
    return (mean_value + step).to(I32)


def _binary_spectrum_fix(spectrum, mean_spectrum, q_domain, initialized):
    """BinarySpectrumFix (delay_estimator_wrapper.cc:92-125), lifted:
    spectrum and mean (B, n) int32, q_domain and initialized (B, 1).
    Returns (bits (B, 1) uint32 carrier, mean, initialized)."""
    band = torch.arange(spectrum.shape[-1], device=spectrum.device)
    in_band = (band >= D.BAND_FIRST) & (band <= D.BAND_LAST)
    spectrum_q15 = spl.wrap32(spl.shl_u32(spectrum, 15 - q_domain))

    nonzero = in_band & (spectrum > 0)
    init_thresh = torch.where(nonzero, spectrum_q15 >> 1, mean_spectrum)
    do_init = initialized == 0
    mean_spectrum = torch.where(do_init, init_thresh, mean_spectrum)
    initialized = torch.where(do_init & nonzero.any(-1, keepdim=True), 1,
                              initialized).to(I32)

    updated = mean_estimator_fix(spectrum_q15, 6, mean_spectrum)
    mean_spectrum = torch.where(in_band, updated, mean_spectrum)
    bit_on = in_band & (spectrum_q15 > mean_spectrum)
    weights = torch.where(bit_on, 1 << (band - D.BAND_FIRST).clamp(min=0), 0)
    bits = weights.sum(-1, keepdim=True) & spl.MASK32
    return bits, mean_spectrum, initialized


def _add_far_spectrum_fix(state: FarendState, spectrum, far_q):
    """WebRtc_AddFarSpectrumFix (delay_estimator_wrapper.cc:233-262) +
    WebRtc_AddBinaryFarSpectrum (delay_estimator.cc:369-382), lifted."""
    bits, mean, inited = _binary_spectrum_fix(
        spectrum, state.mean_spectrum, far_q, state.spectrum_initialized)
    return FarendState(
        torch.cat([bits, state.binary_history[..., :-1]], -1),
        torch.cat([spl.popcount_u32(bits), state.bit_counts[..., :-1]], -1),
        mean, inited)


def add_far_spectrum_fix(state: FarendState, spectrum, far_q):
    """WebRtc_AddFarSpectrumFix for a batch: spectrum (B, n) int32 of
    uint16-range magnitudes in Q(far_q), far_q (B,)."""
    return lower(_add_far_spectrum_fix(lift(state), spectrum,
                                       far_q[..., None]))


# ---------------------------------------------------------------------------
# Binary core (delay_estimator.cc:521-663), lifted
# ---------------------------------------------------------------------------

def _select_at(values, index):
    """values[..., index] per stream; 0 where index is outside [0, n)."""
    n = values.shape[-1]
    got = torch.gather(values, -1, index.clamp(0, n - 1).long())
    return torch.where((index >= 0) & (index < n), got, 0).to(values.dtype)


def _update_robust_validation_statistics(state: NearState, candidate_delay,
                                         valley_depth_q14, valley_level_q14):
    """UpdateRobustValidationStatistics (delay_estimator.cc:96-154)."""
    history_size = state.bit_counts.shape[-1]
    valley_depth = valley_depth_q14.to(F32) * D.Q14_SCALING
    max_hits = torch.where(candidate_delay < state.last_delay,
                           D.MAX_HITS_WHEN_POSSIBLY_NON_CAUSAL,
                           D.MAX_HITS_WHEN_POSSIBLY_CAUSAL)
    new_candidate = candidate_delay != state.last_candidate_delay
    candidate_hits = (torch.where(new_candidate, 0, state.candidate_hits)
                      + 1).to(I32)

    i = torch.arange(history_size + 1, device=candidate_delay.device)
    histogram = torch.where(
        i == candidate_delay,
        (state.histogram + valley_depth).clamp(max=D.HISTOGRAM_MAX),
        state.histogram)
    decrease_in_last_set = torch.where(
        candidate_hits < max_hits,
        (_select_at(state.mean_bit_counts, state.compare_delay)
         - valley_level_q14).to(F32) * D.Q14_SCALING,
        valley_depth)
    in_range = i < history_size   # the C loop covers [0, history_size)
    is_in_last_set = ((i >= state.last_delay - 2)
                      & (i <= state.last_delay + 1) & (i != candidate_delay))
    is_in_candidate_set = ((i >= candidate_delay - 2)
                           & (i <= candidate_delay + 1))
    dec = (decrease_in_last_set * is_in_last_set.to(F32)
           + valley_depth * (~is_in_last_set & ~is_in_candidate_set).to(F32))
    histogram = torch.where(in_range, (histogram - dec).clamp(min=0.0),
                            histogram)
    return state._replace(histogram=histogram, candidate_hits=candidate_hits,
                          last_candidate_delay=candidate_delay)


def _histogram_based_validation(state: NearState, candidate_delay,
                                hist_at_candidate):
    """HistogramBasedValidation (delay_estimator.cc:178-223)."""
    delay_difference = (candidate_delay - state.last_delay).to(F32)
    allowed = state.allowed_offset.to(F32)
    fraction = torch.where(
        delay_difference > allowed,
        (1.0 - D.FRACTION_SLOPE * (delay_difference - allowed)).clamp(
            min=D.MIN_FRACTION_WHEN_POSSIBLY_CAUSAL),
        torch.where(delay_difference < 0,
                    (D.MIN_FRACTION_WHEN_POSSIBLY_NON_CAUSAL
                     - D.FRACTION_SLOPE * delay_difference).clamp(max=1.0),
                    torch.ones_like(delay_difference)))
    threshold = (_select_at(state.histogram, state.compare_delay)
                 * fraction).clamp(min=D.MIN_HISTOGRAM_THRESHOLD)
    return ((hist_at_candidate >= threshold)
            & (state.candidate_hits > D.MIN_REQUIRED_HITS))


def _robust_validation(state: NearState, hist_at_candidate,
                       is_instantaneous_valid, is_histogram_valid):
    """RobustValidation (delay_estimator.cc:242-266)."""
    is_robust = (state.last_delay < 0) & (is_instantaneous_valid
                                          | is_histogram_valid)
    is_robust = is_robust | (is_instantaneous_valid & is_histogram_valid)
    return is_robust | (is_histogram_valid
                        & (hist_at_candidate > state.last_delay_histogram))


def _process_binary_spectrum(state: NearState, farend: FarendState,
                             binary_near_spectrum):
    """WebRtc_ProcessBinarySpectrum (delay_estimator.cc:521-663), lifted;
    robust validation is the per-stream runtime toggle.  Returns (state,
    last_delay (B, 1))."""
    history_size = state.bit_counts.shape[-1]
    near_history_size = state.binary_history.shape[-1]
    if near_history_size > 1:
        near_history = torch.cat([binary_near_spectrum,
                                  state.binary_history[..., :-1]], -1)
        binary_near_spectrum = torch.gather(
            near_history, -1,
            state.lookahead.clamp(0, near_history_size - 1).long())
        state = state._replace(binary_history=near_history)
    else:
        state = state._replace(binary_history=binary_near_spectrum)

    bit_counts = spl.popcount_u32(binary_near_spectrum
                                  ^ farend.binary_history)
    shifts = D.SHIFTS_AT_ZERO - ((D.SHIFTS_LINEAR_SLOPE * farend.bit_counts)
                                 >> 4)
    mean_main = state.mean_bit_counts[..., :history_size]
    updated_mean = mean_estimator_fix(bit_counts << 9, shifts, mean_main)
    mean_main = torch.where(farend.bit_counts > 0, updated_mean, mean_main)
    mean_bit_counts = torch.cat(
        [mean_main, state.mean_bit_counts[..., history_size:]], -1)

    # Valley search: the C loop takes the FIRST strict minimum, and leaves
    # the candidate at -1 unless an entry beats kMaxBitCountsQ9.
    value_best = mean_main.amin(-1, keepdim=True)
    iota = torch.arange(history_size, device=mean_main.device)
    first_min = torch.where(mean_main == value_best, iota,
                            history_size).amin(-1, keepdim=True)
    candidate_delay = torch.where(value_best < D.MAX_BITCOUNTS_Q9,
                                  first_min, -1).to(I32)
    value_best = value_best.clamp(max=D.MAX_BITCOUNTS_Q9)
    value_worst = mean_main.amax(-1, keepdim=True).clamp(min=0)
    valley_depth = value_worst - value_best

    threshold = (value_best + D.PROBABILITY_OFFSET).clamp(
        min=D.PROBABILITY_LOWER_LIMIT)
    update_min_prob = ((state.minimum_probability
                        > D.PROBABILITY_LOWER_LIMIT)
                       & (valley_depth > D.PROBABILITY_MIN_SPREAD)
                       & (state.minimum_probability > threshold))
    minimum_probability = torch.where(update_min_prob, threshold,
                                      state.minimum_probability)
    last_delay_probability = state.last_delay_probability + 1
    valid_candidate = ((valley_depth > D.PROBABILITY_OFFSET)
                       & ((value_best < minimum_probability)
                          | (value_best < last_delay_probability)))
    non_stationary = (farend.bit_counts > 0).any(-1, keepdim=True)

    state = state._replace(bit_counts=bit_counts,
                           mean_bit_counts=mean_bit_counts,
                           minimum_probability=minimum_probability,
                           last_delay_probability=last_delay_probability)
    stats = _update_robust_validation_statistics(
        state, candidate_delay, valley_depth, value_best)
    state = state._replace(**{
        f: torch.where(non_stationary, getattr(stats, f), getattr(state, f))
        for f in ("histogram", "candidate_hits", "last_candidate_delay")})

    hist_cand = _select_at(state.histogram, candidate_delay)
    is_histogram_valid = _histogram_based_validation(state, candidate_delay,
                                                     hist_cand)
    robust_valid = _robust_validation(state, hist_cand, valid_candidate,
                                      is_histogram_valid)
    valid_candidate = torch.where(state.robust_validation_enabled != 0,
                                  robust_valid, valid_candidate)

    do_update = non_stationary & valid_candidate
    changed = do_update & (candidate_delay != state.last_delay)
    last_delay_histogram = torch.where(
        changed, hist_cand.clamp(max=D.LAST_HISTOGRAM_MAX),
        state.last_delay_histogram)
    i = torch.arange(history_size + 1, device=mean_main.device)
    histogram = torch.where(
        (i == state.compare_delay) & changed & (hist_cand < state.histogram),
        hist_cand, state.histogram)
    last_delay = torch.where(do_update, candidate_delay, state.last_delay)
    # state.last_delay_probability is already the ++'d value here.
    last_delay_probability = torch.where(
        do_update & (value_best < state.last_delay_probability),
        value_best, state.last_delay_probability)
    compare_delay = torch.where(do_update, last_delay, state.compare_delay)
    state = state._replace(histogram=histogram, last_delay=last_delay,
                           last_delay_probability=last_delay_probability,
                           compare_delay=compare_delay,
                           last_delay_histogram=last_delay_histogram)
    return state, last_delay


def _process_fix(state: NearState, farend: FarendState, near_spectrum,
                 near_q):
    """WebRtc_DelayEstimatorProcessFix (delay_estimator_wrapper.cc:447-476),
    lifted."""
    bits, mean, inited = _binary_spectrum_fix(
        near_spectrum, state.mean_spectrum, near_q,
        state.spectrum_initialized)
    state = state._replace(mean_spectrum=mean, spectrum_initialized=inited)
    return _process_binary_spectrum(state, farend, bits)


def process_fix(state: NearState, farend: FarendState, near_spectrum,
                near_q):
    """WebRtc_DelayEstimatorProcessFix for a batch: near_spectrum (B, n)
    int32, near_q (B,).  Returns (state, last_delay (B,) int32)."""
    near, delay = _process_fix(lift(state), lift(farend), near_spectrum,
                               near_q[..., None])
    return lower(near), delay[..., 0]


def _last_delay_quality(state: NearState):
    """WebRtc_binary_last_delay_quality (delay_estimator.cc:671-688),
    lifted; branches on the runtime robust-validation toggle.  The
    division by the constant is a product with its float32 reciprocal, as
    XLA compiles the JAX function."""
    robust_q = (_select_at(state.histogram, state.compare_delay)
                * (1.0 / D.HISTOGRAM_MAX))
    plain_q = ((D.MAX_BITCOUNTS_Q9 - state.last_delay_probability).to(F32)
               / D.MAX_BITCOUNTS_Q9).clamp(min=0.0)
    return torch.where(state.robust_validation_enabled != 0, robust_q,
                       plain_q)


def last_delay_quality(state: NearState):
    """WebRtc_binary_last_delay_quality for a batch -> (B,) float32."""
    return _last_delay_quality(lift(state))[..., 0]
