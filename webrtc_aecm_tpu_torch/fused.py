"""Fused lane-major AECM serving path (PyTorch port of webrtc_aecm_tpu/fused.py).

The whole per-step core path on lane-major state: every core leaf is shaped
(rows, n_streams), the control fields are batch-leading, exactly as in the
JAX package's FusedState, so the two compare leaf for leaf.

Two execution paths share one semantics:
  * plain path: `frames_step_cng` (the CNG chain, then `frames_step`) and
    `_ring_write_gather_multi` below are plain
    PyTorch tensor code; it runs on any device and is the CPU test target,
    held bit-exact against the JAX package (tests/test_torch_*.py);
  * kernel path: on CUDA tensors the step runs the jitter-ring kernel
    (ops/ring_kernels.py, csrc/ring.cu) and the frames kernel
    (fused_kernel.py, csrc/frames.cu), each held bit-exact against the
    plain path on the card (chip_smoke.py).

Scope: the JAX package's fused envelope at 8 and 16 kHz: any number of
chunks per step, on both paths, the circular far history where a step is
whole blocks dividing the history and the newest-first one elsewhere (the
10 ms real-time step), a single or a clean near input, `abs_approx`, a tail
of chunks as one final smaller step, and a delay estimator of any history
size and lookahead capacity (`delay_estimator.set_history_size`, a near
binary history of more than one row).  The kernel path refuses only a
history size whose one stream does not fit a thread block's shared memory
(fused_kernel.check_fits).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from . import _device
from . import control
from . import core as core_mod
from . import defines as D
from . import delay_estimator as de
from . import tables
from ._tree import tree_map
from .ops import ring_buffer as rbuf
from .ops import spl
from .tracing import span

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32

FAR_HIST_ROWS = 40
# Fused-layout far history (as in the JAX package): each 65-bin block packs
# into 40 int32 rows, bin f in the low 16 bits of row f and bin f + 40 in the
# high 16 bits (bins 65..79 are zero padding).


# ---------------------------------------------------------------------------
# Constant tables
# ---------------------------------------------------------------------------

class Tables(NamedTuple):
    """Constant tables of the core path, on one device.  The TPU package's
    int8 permutation matrices become index vectors."""
    win128: torch.Tensor      # (128, 1) int32 sqrt-Hanning analysis window
    fwr: torch.Tensor         # (7, 128, 1) int32 per-stage per-row wr
    fws: torch.Tensor         # (7, 128, 1) int32 per-stage per-row ws
    partner: torch.Tensor     # (7, 128) int64: row i pairs with i ^ 2^s
    is_a: torch.Tensor        # (7, 128, 1) bool: bit s of i clear
    bitrev: torch.Tensor      # (128,) int64 7-bit bit reversal
    ifft_src: torch.Tensor    # (128,) int64 conj-extension source bin
    ifft_sign: torch.Tensor   # (128, 1) int32 +1 / -1 (conjugated half)
    cos360: torch.Tensor      # (360,) int32 Q13 (CNG)
    sin360: torch.Tensor      # (360,) int32 Q13
    lcg_a: torch.Tensor       # (n_draws, 1) int64 LCG A powers
    lcg_c: torch.Tensor       # (n_draws, 1) int64 LCG C accumulants


def _bitrev7(i: int) -> int:
    return int(f"{i:07b}"[::-1], 2)


@functools.lru_cache(maxsize=None)
def _tables_np(n_draws: int):
    h = np.asarray(tables.SQRT_HANNING, np.int32)
    win128 = np.concatenate([h[:D.PART_LEN], h[D.PART_LEN:0:-1]])
    rows = np.arange(128)
    fwr = np.stack([tables.STAGE_WR[s][rows % (1 << s)] for s in range(7)])
    fws = np.stack([tables.STAGE_WS[s][rows % (1 << s)] for s in range(7)])
    partner = np.stack([rows ^ (1 << s) for s in range(7)])
    is_a = np.stack([(rows & (1 << s)) == 0 for s in range(7)])
    bitrev = np.array([_bitrev7(i) for i in range(128)])
    src = np.where(bitrev <= 64, bitrev, 128 - bitrev)
    sign = np.where(bitrev <= 64, 1, -1)
    a_np, c_np = tables.lcg_tables(n_draws)
    return dict(win128=win128.astype(np.int32)[:, None],
                fwr=fwr.astype(np.int32)[:, :, None],
                fws=fws.astype(np.int32)[:, :, None],
                partner=partner.astype(np.int64),
                is_a=is_a[:, :, None],
                bitrev=bitrev.astype(np.int64),
                ifft_src=src.astype(np.int64),
                ifft_sign=sign.astype(np.int32)[:, None],
                cos360=np.asarray(tables.COS_TABLE_360, np.int32),
                sin360=np.asarray(tables.SIN_TABLE_360, np.int32),
                lcg_a=a_np.astype(np.int64)[:, None],
                lcg_c=c_np.astype(np.int64)[:, None])


def make_tables(device=None, n_slots: int = 5) -> Tables:
    device = _device.resolve(device)
    arrs = _tables_np(n_slots * D.PART_LEN)
    return Tables(**{k: torch.tensor(v, device=device)
                     for k, v in arrs.items()})


# ---------------------------------------------------------------------------
# Layout conversion: batch-leading state <-> lane-major state
# ---------------------------------------------------------------------------

def _pack_far_block(xfa_rows):
    """(80, B) int32 bin rows (values in [0, 65535]) -> (40, B) packed."""
    lo = xfa_rows[:FAR_HIST_ROWS].to(I64)
    hi = xfa_rows[FAR_HIST_ROWS:].to(I64)
    return spl.wrap32(lo | (hi << 16))


def _unpack_far_block(packed):
    """(..., 40, B) packed int32 -> (..., 80, B) bin rows int32."""
    v = spl.u32(packed)
    return torch.cat([v & 0xFFFF, v >> 16], dim=-2).to(I32)


def to_fused_core(core_b):
    """Batched CoreState (leaves (B, ...)) -> lane-major (rows, B) leaves;
    far_history (B, 100, 65) -> bit-packed (100 * 40, B) int32."""
    fh = spl.u32(core_b.far_history)
    b = fh.shape[0]
    fh = torch.cat([fh, fh.new_zeros((b, D.MAX_DELAY,
                                      2 * FAR_HIST_ROWS - D.PART_LEN1))], -1)
    packed = spl.wrap32(fh[:, :, :FAR_HIST_ROWS]
                        | (fh[:, :, FAR_HIST_ROWS:] << 16))
    core_b = core_b._replace(far_history=packed)

    def conv(x):
        if x.ndim == 1:
            return x[None, :].contiguous()
        return x.reshape(x.shape[0], -1).T.contiguous()
    return tree_map(conv, core_b)


def from_fused_core(core_f, template=None):
    """Inverse of to_fused_core; `template` (a one-stream CoreState)
    supplies which leaves are scalars and the far history's shape; a
    vector leaf takes its length from core_f, so a resized delay estimator
    comes back as it is.  far_history comes back as int32 bins."""
    if template is None:
        template = core_mod.create_core(8000, device="cpu")
    template = template._replace(far_history=torch.zeros(
        (D.MAX_DELAY, FAR_HIST_ROWS), dtype=I32))

    def conv(x, t):
        if t.ndim == 0:
            return x[0].contiguous()
        if t.ndim == 1:     # rows from x: resized delay-estimator leaves
            return x.T.contiguous()
        return x.T.reshape((x.shape[1],) + tuple(t.shape)).contiguous()
    core_b = tree_map(conv, core_f, template)
    bins = _unpack_far_block(core_b.far_history.transpose(-1, -2))
    return core_b._replace(
        far_history=bins.transpose(-1, -2)[..., :D.PART_LEN1].contiguous())


# ---------------------------------------------------------------------------
# Lane-major helpers (rows first, streams last)
# ---------------------------------------------------------------------------

def _row(x, i):
    return x[i:i + 1]


def _set_row(x, i, v):
    return torch.cat([x[:i], v, x[i + 1:]], dim=0)


def _shift_in(x, v):
    """History shift register, newest first: roll by one, row 0 = v."""
    return torch.cat([v, x[:-1]], dim=0)


def _sum0(x):
    """int32 row sum with int32 wraparound (JAX's `_sum0`)."""
    return spl.wrap32(x.to(I64).sum(dim=0, keepdim=True))


def _sum0_u32(x):
    """uint32 row sum mod 2^32 of int32 bit patterns or uint32 carriers."""
    return spl.u32(x).sum(dim=0, keepdim=True) & spl.MASK32


def _max_abs_w16_0(x):
    return x.abs().amax(dim=0, keepdim=True).clamp(max=spl.WORD16_MAX)


def _iota_col(n, device):
    return torch.arange(n, dtype=I32, device=device)[:, None]


def _select_row_at(values, index):
    """values[index] per lane; 0 where index is outside [0, L)."""
    n = values.shape[0]
    valid = (index >= 0) & (index < n)
    g = torch.gather(values, 0, index.clamp(0, n - 1).long())
    return torch.where(valid, g, torch.zeros_like(g))


def _argmin0(v):
    """(min, first index of the min) along rows."""
    mn = v.amin(dim=0, keepdim=True)
    iota = _iota_col(v.shape[0], v.device).expand_as(v)
    idx = torch.where(v == mn, iota, 2 ** 30).amin(dim=0, keepdim=True)
    return mn, idx.to(I32)


def _zeros_row(x):
    return torch.zeros_like(x[:1])


# ---------------------------------------------------------------------------
# FFT pair, lane-major (ops/fft.py order 7, mode 1); butterflies pair row i
# with row i ^ 2^s by index, permutations are index gathers
# ---------------------------------------------------------------------------

def _butterfly_inputs(fr, fi, t: Tables, s: int):
    is_a = t.is_a[s]
    p = t.partner[s]
    pr, pi = fr[p], fi[p]
    return (is_a, torch.where(is_a, fr, pr), torch.where(is_a, fi, pi),
            torch.where(is_a, pr, fr), torch.where(is_a, pi, fi))


def _complex_fft_128(fr, fi, t: Tables):
    for s in range(7):
        wr, wi = t.fwr[s], -t.fws[s]
        is_a, ar, ai, br, bi = _butterfly_inputs(fr, fi, t, s)
        tr = (wr * br - wi * bi + D.CFFTRND) >> (15 - D.CFFTSFT)
        ti = (wr * bi + wi * br + D.CFFTRND) >> (15 - D.CFFTSFT)
        qr = ar << D.CFFTSFT
        qi = ai << D.CFFTSFT
        sgn = torch.where(is_a, 1, -1).to(I32)
        fr = spl.to_w16((qr + sgn * tr + D.CFFTRND2) >> (1 + D.CFFTSFT))
        fi = spl.to_w16((qi + sgn * ti + D.CFFTRND2) >> (1 + D.CFFTSFT))
    return fr, fi


def _complex_ifft_128(fr, fi, t: Tables):
    """Inverse with the data-dependent per-stage scaling, per stream;
    returns (fr, fi, scale (1, B))."""
    scale = torch.zeros_like(fr[:1])
    for s in range(7):
        maxabs = torch.maximum(fr.abs().amax(dim=0, keepdim=True),
                               fi.abs().amax(dim=0, keepdim=True)
                               ).clamp(max=32767)
        shift = ((maxabs > 13573).to(I32) + (maxabs > 27146).to(I32))
        scale = scale + shift
        rnd = torch.full_like(shift, 8192) << shift
        wr, wi = t.fwr[s], t.fws[s]
        is_a, ar, ai, br, bi = _butterfly_inputs(fr, fi, t, s)
        tr = (wr * br - wi * bi + D.CIFFTRND) >> (15 - D.CIFFTSFT)
        ti = (wr * bi + wi * br + D.CIFFTRND) >> (15 - D.CIFFTSFT)
        qr = ar << D.CIFFTSFT
        qi = ai << D.CIFFTSFT
        sgn = torch.where(is_a, 1, -1).to(I32)
        fr = spl.to_w16((qr + sgn * tr + rnd) >> (shift + D.CIFFTSFT))
        fi = spl.to_w16((qi + sgn * ti + rnd) >> (shift + D.CIFFTSFT))
    return fr, fi, scale


def _real_forward_fft(x128, t: Tables):
    """(128, B) int16-range -> (65, B) re, im."""
    fr = x128.to(I32)[t.bitrev]
    fr, fi = _complex_fft_128(fr, torch.zeros_like(fr), t)
    return fr[:65], fi[:65]


def _real_inverse_fft(re, im, t: Tables):
    """(65, B) half spectrum -> ((128, B) real out, scale (1, B)).  The
    conjugate extension and the bit reversal are one index gather; the
    post-hoc to_w16 reproduces the int16 wrap of -(-32768)."""
    fr = re.to(I32)[t.ifft_src]
    fi = spl.to_w16(im.to(I32)[t.ifft_src] * t.ifft_sign)
    fr, _, scale = _complex_ifft_128(fr, fi, t)
    return fr, scale


# ---------------------------------------------------------------------------
# Delay estimator, lane-major (any history size and lookahead capacity)
# ---------------------------------------------------------------------------

def _binary_spectrum_fix_f(spectrum, mean_spectrum, q_domain, initialized):
    dev = spectrum.device
    band = _iota_col(D.PART_LEN1, dev)
    in_band = (band >= D.BAND_FIRST) & (band <= D.BAND_LAST)
    shift = (15 - q_domain).to(I64)
    spectrum_q15 = spl.wrap32((spl.u32(spectrum) << shift) & spl.MASK32)

    nonzero = in_band & (spectrum > 0)
    init_thresh = torch.where(nonzero, spectrum_q15 >> 1, mean_spectrum)
    any_nonzero = nonzero.any(dim=0, keepdim=True)
    do_init = initialized == 0
    mean_spectrum = torch.where(do_init, init_thresh, mean_spectrum)
    initialized = torch.where(do_init & any_nonzero, 1, initialized).to(I32)

    updated = de.mean_estimator_fix(spectrum_q15, 6, mean_spectrum)
    mean_spectrum = torch.where(in_band, updated, mean_spectrum)
    bit_on = in_band & (spectrum_q15 > mean_spectrum)
    weights = torch.where(
        bit_on, torch.ones_like(band, dtype=I64)
        << (band - D.BAND_FIRST).clamp(min=0).to(I64), 0)
    return _sum0_u32(weights), mean_spectrum, initialized


def _add_far_spectrum_fix_f(farend: de.FarendState, spectrum, far_q):
    bits, mean, inited = _binary_spectrum_fix_f(
        spectrum, farend.mean_spectrum, far_q, farend.spectrum_initialized)
    return de.FarendState(
        _shift_in(farend.binary_history, bits),
        _shift_in(farend.bit_counts, spl.popcount_u32(bits)), mean, inited)


def _process_binary_spectrum_f(near: de.NearState, farend: de.FarendState,
                               bits):
    """delay_estimator.process_binary_spectrum, lane-major, at any history
    size and lookahead capacity (both from the leaf shapes).  Capacity > 1
    keeps the near binary history as a shift register and compares the row
    at the per-stream runtime lookahead, clamped to the capacity."""
    dev = bits.device
    history_size = near.bit_counts.shape[0]
    cap = near.binary_history.shape[0]
    if cap > 1:
        hist = _shift_in(near.binary_history, bits)
        near = near._replace(binary_history=hist)
        bits = torch.gather(hist, 0, near.lookahead.clamp(0, cap - 1).long())
    else:
        near = near._replace(binary_history=bits)
    bit_counts = spl.popcount_u32(bits ^ farend.binary_history)

    bit_count_q9 = bit_counts << 9
    shifts = D.SHIFTS_AT_ZERO - ((D.SHIFTS_LINEAR_SLOPE * farend.bit_counts)
                                 >> 4)
    mean_main = near.mean_bit_counts[:history_size]
    updated_mean = de.mean_estimator_fix(bit_count_q9, shifts, mean_main)
    mean_main = torch.where(farend.bit_counts > 0, updated_mean, mean_main)
    mean_bit_counts = torch.cat(
        [mean_main, near.mean_bit_counts[history_size:]], dim=0)

    value_best, candidate_delay = _argmin0(mean_main)
    candidate_delay = torch.where(value_best < D.MAX_BITCOUNTS_Q9,
                                  candidate_delay, -1).to(I32)
    value_best = value_best.clamp(max=D.MAX_BITCOUNTS_Q9)
    value_worst = mean_main.amax(dim=0, keepdim=True).clamp(min=0)
    valley_depth = value_worst - value_best

    threshold = (value_best + D.PROBABILITY_OFFSET).clamp(
        min=D.PROBABILITY_LOWER_LIMIT)
    update_min_prob = ((near.minimum_probability > D.PROBABILITY_LOWER_LIMIT)
                       & (valley_depth > D.PROBABILITY_MIN_SPREAD)
                       & (near.minimum_probability > threshold))
    minimum_probability = torch.where(update_min_prob, threshold,
                                      near.minimum_probability)
    last_delay_probability = near.last_delay_probability + 1

    valid_candidate = ((valley_depth > D.PROBABILITY_OFFSET)
                       & ((value_best < minimum_probability)
                          | (value_best < last_delay_probability)))
    non_stationary = (farend.bit_counts > 0).any(dim=0, keepdim=True)

    near = near._replace(bit_counts=bit_counts,
                         mean_bit_counts=mean_bit_counts,
                         minimum_probability=minimum_probability,
                         last_delay_probability=last_delay_probability)

    # --- UpdateRobustValidationStatistics (non-stationary far end only) ---
    valley_f = valley_depth.to(F32) * D.Q14_SCALING
    max_hits = torch.where(candidate_delay < near.last_delay,
                           D.MAX_HITS_WHEN_POSSIBLY_NON_CAUSAL,
                           D.MAX_HITS_WHEN_POSSIBLY_CAUSAL)
    new_candidate = candidate_delay != near.last_candidate_delay
    cand_hits_upd = torch.where(new_candidate, 0, near.candidate_hits) + 1

    i101 = _iota_col(history_size + 1, dev)
    hist_upd = torch.where(i101 == candidate_delay,
                           (near.histogram + valley_f).clamp(
                               max=D.HISTOGRAM_MAX), near.histogram)
    decrease_in_last_set = torch.where(
        cand_hits_upd < max_hits,
        (_select_row_at(near.mean_bit_counts, near.compare_delay)
         - value_best).to(F32) * D.Q14_SCALING,
        valley_f)
    in_range = i101 < history_size
    is_in_last_set = ((i101 >= near.last_delay - 2)
                      & (i101 <= near.last_delay + 1)
                      & (i101 != candidate_delay))
    is_in_candidate_set = ((i101 >= candidate_delay - 2)
                           & (i101 <= candidate_delay + 1))
    dec = (decrease_in_last_set * is_in_last_set.to(F32)
           + valley_f * (~is_in_last_set & ~is_in_candidate_set).to(F32))
    hist_upd = torch.where(in_range, (hist_upd - dec).clamp(min=0.0),
                           hist_upd)

    near = near._replace(
        histogram=torch.where(non_stationary, hist_upd, near.histogram),
        candidate_hits=torch.where(non_stationary, cand_hits_upd,
                                   near.candidate_hits).to(I32),
        last_candidate_delay=torch.where(non_stationary, candidate_delay,
                                         near.last_candidate_delay))

    # --- histogram-based + robust validation (runtime toggle) ---
    hist_cand = _select_row_at(near.histogram, candidate_delay)
    delay_difference = (candidate_delay - near.last_delay).to(F32)
    allowed = near.allowed_offset.to(F32)
    one = torch.ones_like(delay_difference)
    fraction = torch.where(
        delay_difference > allowed,
        (1.0 - D.FRACTION_SLOPE * (delay_difference - allowed)).clamp(
            min=D.MIN_FRACTION_WHEN_POSSIBLY_CAUSAL),
        torch.where(delay_difference < 0,
                    (D.MIN_FRACTION_WHEN_POSSIBLY_NON_CAUSAL
                     - D.FRACTION_SLOPE * delay_difference).clamp(max=1.0),
                    one))
    h_threshold = (_select_row_at(near.histogram, near.compare_delay)
                   * fraction).clamp(min=D.MIN_HISTOGRAM_THRESHOLD)
    is_histogram_valid = ((hist_cand >= h_threshold)
                          & (near.candidate_hits > D.MIN_REQUIRED_HITS))
    is_robust = (near.last_delay < 0) & (valid_candidate | is_histogram_valid)
    is_robust = is_robust | (valid_candidate & is_histogram_valid)
    is_robust = is_robust | (is_histogram_valid
                             & (hist_cand > near.last_delay_histogram))
    use_rv = near.robust_validation_enabled != 0
    valid_candidate = (use_rv & is_robust) | (~use_rv & valid_candidate)

    do_update = non_stationary & valid_candidate
    changed = do_update & (candidate_delay != near.last_delay)
    last_delay_histogram = torch.where(
        changed, hist_cand.clamp(max=D.LAST_HISTOGRAM_MAX),
        near.last_delay_histogram)
    histogram = torch.where(
        (i101 == near.compare_delay) & changed & (hist_cand < near.histogram),
        hist_cand, near.histogram)
    last_delay = torch.where(do_update, candidate_delay, near.last_delay)
    last_delay_probability = torch.where(
        do_update & (value_best < near.last_delay_probability),
        value_best, near.last_delay_probability)
    compare_delay = torch.where(do_update, last_delay, near.compare_delay)
    near = near._replace(histogram=histogram, last_delay=last_delay,
                         last_delay_probability=last_delay_probability,
                         compare_delay=compare_delay,
                         last_delay_histogram=last_delay_histogram)
    return near, last_delay


def _process_fix_f(near: de.NearState, farend: de.FarendState,
                   near_spectrum, near_q):
    bits, mean, inited = _binary_spectrum_fix_f(
        near_spectrum, near.mean_spectrum, near_q, near.spectrum_initialized)
    near = near._replace(mean_spectrum=mean, spectrum_initialized=inited)
    return _process_binary_spectrum_f(near, farend, bits)


# ---------------------------------------------------------------------------
# Core block path, lane-major (mirrors the JAX package's fused.py stages)
# ---------------------------------------------------------------------------

def _push_far_pending(ctx, far_spectrum, far_q):
    """Deferred far-history update: the block is pushed to the pending list
    (the caller appends the pending blocks to the circular history once per
    step)."""
    pad = torch.zeros((2 * FAR_HIST_ROWS - D.PART_LEN1,)
                      + far_spectrum.shape[1:], dtype=I32,
                      device=far_spectrum.device)
    ctx["pending"].append(_pack_far_block(torch.cat([far_spectrum, pad], 0)))
    ctx["pending_q"].append(far_q)


def _aligned_farend_deferred(ctx, delay):
    """AlignedFarend against the deferred view: delay d in slot s (s
    pending predecessors + this slot's block) is pending[s - d] for d <= s,
    else the old block written d - s - 1 blocks before the newest.  In the
    newest-first history (ctx["head0"] None) that block is row-group
    d - s - 1; in the circular one it is (head0 - 1 - (d - s - 1)) mod
    100."""
    hist_p, q_old = ctx["hist"], ctx["q"]
    pending, pending_q = ctx["pending"], ctx["pending_q"]
    head0 = ctx["head0"]
    s = len(pending) - 1
    b = hist_p.shape[-1]
    hist = hist_p.view(D.MAX_DELAY, FAR_HIST_ROWS, b)
    idx_old = delay - (s + 1)
    in_old = (delay < D.MAX_DELAY) & (idx_old >= 0)
    if head0 is None:
        tgt = idx_old
    else:
        tgt = head0 + (D.MAX_DELAY - 1) - idx_old
        tgt = torch.where(tgt >= D.MAX_DELAY, tgt - D.MAX_DELAY, tgt)
    tgt = tgt.clamp(0, D.MAX_DELAY - 1).long()
    packed = torch.gather(hist, 0, tgt.view(1, 1, b).expand(
        1, FAR_HIST_ROWS, b))[0]
    packed = torch.where(in_old, packed, 0)
    far_q = torch.where(in_old, torch.gather(q_old, 0, tgt), 0)
    for j in range(s + 1):
        hit = delay == j
        packed = torch.where(hit, pending[s - j], packed)
        far_q = torch.where(hit, pending_q[s - j], far_q)
    return _unpack_far_block(packed)[:D.PART_LEN1], far_q.to(I32)


def _far_merge_deferred(hist, pending, n_act, rows: int):
    """Merge the pending blocks into the (100 * rows, B) newest-first
    history: lanes with n_act = m get [pending[m-1] .. pending[0],
    old[:100-m]] (the pending blocks of inactive slots are never taken)."""
    S = len(pending)
    total = hist.shape[0]
    padded = torch.cat(list(reversed(pending)) + [hist], dim=0)
    out = padded[S * rows:S * rows + total]
    for m in range(1, S + 1):
        out = torch.where(n_act == m,
                          padded[(S - m) * rows:(S - m) * rows + total], out)
    return out


def _calc_energies_f(core, far_spectrum, far_q, near_ener):
    """core.calc_energies, lane-major."""
    near_log = core_mod.log_of_energy_in_q8(near_ener, core.dfa_noisy_q)
    near_log_energy = _shift_in(core.near_log_energy, near_log)

    echo_est = core.channel_stored * far_spectrum
    tmp_far = _sum0_u32(far_spectrum)
    tmp_adapt = _sum0_u32(core.channel_adapt16 * far_spectrum)
    tmp_stored = _sum0_u32(echo_est)

    far_log_energy = core_mod.log_of_energy_in_q8(tmp_far, far_q)
    adapt_log = core_mod.log_of_energy_in_q8(
        tmp_adapt, D.RESOLUTION_CHANNEL16 + far_q)
    stored_log = core_mod.log_of_energy_in_q8(
        tmp_stored, D.RESOLUTION_CHANNEL16 + far_q)
    echo_adapt_log_energy = _shift_in(core.echo_adapt_log_energy, adapt_log)
    echo_stored_log_energy = _shift_in(core.echo_stored_log_energy,
                                       stored_log)

    in_startup = core.startup_state == 0
    increase_max_shifts = torch.where(in_startup, 2, 4).to(I32)
    increase_min_shifts = torch.where(in_startup, 8, 11).to(I32)
    decrease_min_shifts = torch.where(in_startup, 2, 3).to(I32)

    active = far_log_energy > D.FAR_ENERGY_MIN
    new_min = core_mod.asym_filt(core.far_energy_min, far_log_energy,
                                 increase_min_shifts, decrease_min_shifts)
    new_max = core_mod.asym_filt(core.far_energy_max, far_log_energy,
                                 increase_max_shifts, 11)
    far_energy_min = torch.where(active, new_min, core.far_energy_min)
    far_energy_max = torch.where(active, new_max, core.far_energy_max)
    far_energy_max_min = torch.where(active, far_energy_max - far_energy_min,
                                     core.far_energy_max_min)

    tmp16 = spl.to_w16(2560 - far_energy_min)
    tmp16 = torch.where(tmp16 > 0,
                        spl.to_w16((tmp16 * D.FAR_ENERGY_VAD_REGION) >> 9),
                        0)
    tmp16 = spl.to_w16(tmp16 + D.FAR_ENERGY_VAD_REGION)

    vad_halted = in_startup | (core.vad_update_count > 1024)
    tracked_vad = core.far_energy_vad + (
        (far_log_energy + tmp16 - core.far_energy_vad) >> 6)
    track = core.far_energy_vad > far_log_energy
    far_energy_vad = torch.where(
        active,
        torch.where(vad_halted, far_energy_min + tmp16,
                    torch.where(track, tracked_vad, core.far_energy_vad)),
        core.far_energy_vad)
    vad_update_count = torch.where(
        active & ~vad_halted,
        torch.where(track, 0, spl.to_w16(core.vad_update_count + 1)),
        core.vad_update_count)
    far_energy_mse = torch.where(active, far_energy_vad + (1 << 8),
                                 core.far_energy_mse)

    above = far_log_energy > far_energy_vad
    dynamic = in_startup | (far_energy_max_min > D.FAR_ENERGY_DIFF)
    current_vad_value = torch.where(
        above, torch.where(dynamic, 1, core.current_vad_value), 0).to(I32)

    first_fire = (current_vad_value != 0) & (core.first_vad != 0)
    too_hot = _row(echo_adapt_log_energy, 0) > _row(near_log_energy, 0)
    scale_down = first_fire & too_hot
    channel_adapt16 = torch.where(scale_down, core.channel_adapt16 >> 3,
                                  core.channel_adapt16)
    echo_adapt_log_energy = _set_row(
        echo_adapt_log_energy, 0,
        torch.where(scale_down, _row(echo_adapt_log_energy, 0) - (3 << 8),
                    _row(echo_adapt_log_energy, 0)))
    first_vad = torch.where(first_fire & ~too_hot, 0,
                            core.first_vad).to(I32)

    core = core._replace(
        near_log_energy=near_log_energy,
        far_log_energy=far_log_energy,
        echo_adapt_log_energy=echo_adapt_log_energy,
        echo_stored_log_energy=echo_stored_log_energy,
        far_energy_min=far_energy_min,
        far_energy_max=far_energy_max,
        far_energy_max_min=far_energy_max_min,
        far_energy_vad=far_energy_vad,
        far_energy_mse=far_energy_mse,
        vad_update_count=vad_update_count.to(I32),
        current_vad_value=current_vad_value,
        channel_adapt16=channel_adapt16,
        first_vad=first_vad,
    )
    return core, echo_est


def _update_channel_f(core, far_spectrum, far_q, dfa, mu, echo_est):
    """core.update_channel, lane-major ((65, B) rows, (1, B) scalars)."""
    ch32 = core.channel_adapt32
    zeros_ch = spl.norm_u32(ch32)
    zeros_far = spl.norm_u32(far_spectrum)
    safe_mul = zeros_ch + zeros_far > 31
    shift_ch_far = torch.where(safe_mul, 0, 32 - zeros_ch - zeros_far
                               ).to(I32)
    prod_safe = (spl.u32(ch32) * spl.u32(far_spectrum)) & spl.MASK32
    shifted_ch = torch.where(shift_ch_far >= 32, 0,
                             spl.sar_i32(ch32, shift_ch_far))
    prod_shifted = (spl.u32(shifted_ch) * spl.u32(far_spectrum)) & spl.MASK32
    tmp_u32_no1 = torch.where(safe_mul, prod_safe, prod_shifted)

    zeros_num = spl.norm_u32(tmp_u32_no1)
    zeros_dfa = torch.where(dfa != 0, spl.norm_u32(dfa), 32).to(I32)
    tmp16_no1 = (zeros_dfa - 2 + core.dfa_noisy_q - D.RESOLUTION_CHANNEL32
                 - far_q + shift_ch_far)
    use_dfa_domain = zeros_num > tmp16_no1 + 1
    xfa_q = torch.where(use_dfa_domain, tmp16_no1, zeros_num - 2)
    dfa_q = torch.where(use_dfa_domain, zeros_dfa - 2,
                        D.RESOLUTION_CHANNEL32 + far_q - core.dfa_noisy_q
                        - shift_ch_far + (zeros_num - 2))

    tmp_u32_no1 = spl.shift_w32(tmp_u32_no1, xfa_q)
    tmp_u32_no2 = spl.shift_w32(spl.u32(dfa), dfa_q)
    tmp32_no1 = spl.wrap32(tmp_u32_no2 - tmp_u32_no1)
    zeros_num = spl.norm_w32(tmp32_no1)

    do_update = ((tmp32_no1 != 0)
                 & (far_spectrum > spl.shl_i32(
                     torch.full_like(far_q, D.CHANNEL_VAD), far_q)))

    safe_mul2 = zeros_num + zeros_far > 31
    pos = tmp32_no1 > 0
    prod2_safe = torch.where(pos, tmp32_no1 * far_spectrum,
                             -((-tmp32_no1) * far_spectrum))
    shift_num = torch.where(safe_mul2, 0, 32 - (zeros_num + zeros_far)
                            ).to(I32)
    prod2_shift = torch.where(
        pos, spl.sar_i32(tmp32_no1, shift_num) * far_spectrum,
        -(spl.sar_i32(-tmp32_no1, shift_num) * far_spectrum))
    tmp32_no2 = torch.where(safe_mul2, prod2_safe, prod2_shift)

    tmp32_no2 = spl.div_w32_w16(tmp32_no2,
                                _iota_col(D.PART_LEN1, far_q.device) + 1)
    shift2_res_chan = (shift_num + shift_ch_far - xfa_q - mu
                       - ((30 - zeros_far) << 1))
    overflow = spl.norm_w32(tmp32_no2) < shift2_res_chan
    tmp32_no2 = torch.where(overflow, D.WORD32_MAX,
                            spl.shift_w32(tmp32_no2, shift2_res_chan))

    new_ch32 = spl.add_sat_w32(ch32, tmp32_no2).clamp(min=0)
    apply = (mu != 0) & do_update
    channel_adapt32 = torch.where(apply, new_ch32, ch32)
    channel_adapt16 = torch.where(apply, channel_adapt32 >> 16,
                                  core.channel_adapt16)
    core = core._replace(channel_adapt32=channel_adapt32,
                         channel_adapt16=channel_adapt16)

    # --- store/restore arbitration ---
    startup_store = (core.startup_state == 0) & (core.current_vad_value != 0)
    mse_channel_count = torch.where(
        core.far_log_energy < core.far_energy_mse, 0,
        core.mse_channel_count + 1)
    evaluate = mse_channel_count >= (D.MIN_MSE_COUNT + 10)

    n = D.MIN_MSE_COUNT
    mse_stored = _sum0((core.echo_stored_log_energy[:n]
                        - core.near_log_energy[:n]).abs())
    mse_adapt = _sum0((core.echo_adapt_log_energy[:n]
                       - core.near_log_energy[:n]).abs())

    do_reset = evaluate & (
        (spl.shl_i32(mse_stored, D.MSE_RESOLUTION)
         < D.MIN_MSE_DIFF * mse_adapt)
        & (spl.shl_i32(core.mse_stored_old, D.MSE_RESOLUTION)
           < D.MIN_MSE_DIFF * core.mse_adapt_old))
    do_store = evaluate & ~do_reset & (
        (D.MIN_MSE_DIFF * mse_stored > spl.shl_i32(mse_adapt,
                                                   D.MSE_RESOLUTION))
        & (mse_adapt < core.mse_threshold)
        & (core.mse_adapt_old < core.mse_threshold))

    fresh = core.mse_threshold == D.WORD32_MAX
    scaled_threshold = spl.div_trunc(core.mse_threshold * 5, 8)
    bumped = core.mse_threshold + (
        ((mse_adapt - scaled_threshold) * 205) >> 8)
    new_threshold = torch.where(fresh, mse_adapt + core.mse_adapt_old, bumped)
    mse_threshold = torch.where(do_store & ~startup_store, new_threshold,
                                core.mse_threshold)

    store_now = startup_store | (~startup_store & do_store)
    stored_ch = core.channel_adapt16
    stored_echo_est = stored_ch * far_spectrum
    reset_now = ~startup_store & do_reset
    channel_stored = torch.where(store_now, stored_ch, core.channel_stored)
    echo_est = torch.where(store_now, stored_echo_est, echo_est)
    channel_adapt16 = torch.where(reset_now, core.channel_stored,
                                  core.channel_adapt16)
    channel_adapt32 = torch.where(reset_now,
                                  spl.shl_i32(core.channel_stored, 16),
                                  core.channel_adapt32)

    core = core._replace(
        channel_stored=channel_stored,
        channel_adapt16=channel_adapt16,
        channel_adapt32=channel_adapt32,
        mse_threshold=mse_threshold,
        mse_channel_count=torch.where(
            startup_store, core.mse_channel_count,
            torch.where(evaluate, 0, mse_channel_count)).to(I32),
        mse_stored_old=torch.where(~startup_store & evaluate, mse_stored,
                                   core.mse_stored_old),
        mse_adapt_old=torch.where(~startup_store & evaluate, mse_adapt,
                                  core.mse_adapt_old),
    )
    return core, echo_est


def _calc_suppression_gain_f(core):
    """core.calc_suppression_gain, lane-major ((1, B) scalars)."""
    tmp16 = (_row(core.near_log_energy, 0)
             - _row(core.echo_stored_log_energy, 0) - D.ENERGY_DEV_OFFSET)
    d_e = spl.to_w16(spl.to_w16(tmp16).abs())

    low = d_e < D.SUPGAIN_EPC_DT
    num_low = core.sup_gain_err_param_diff_ab * d_e + (D.SUPGAIN_EPC_DT >> 1)
    gain_low = core.sup_gain_err_param_a - spl.to_w16(
        spl.div_w32_w16(num_low, D.SUPGAIN_EPC_DT))
    num_high = (core.sup_gain_err_param_diff_bd * (D.ENERGY_DEV_TOL - d_e)
                + ((D.ENERGY_DEV_TOL - D.SUPGAIN_EPC_DT) >> 1))
    gain_high = core.sup_gain_err_param_d + spl.to_w16(
        spl.div_w32_w16(num_high, D.ENERGY_DEV_TOL - D.SUPGAIN_EPC_DT))
    sup_gain = torch.where(d_e < D.ENERGY_DEV_TOL,
                           torch.where(low, gain_low, gain_high),
                           core.sup_gain_err_param_d)
    sup_gain = torch.where(core.current_vad_value == 0, 0, sup_gain)

    target = torch.maximum(sup_gain, core.sup_gain_old)
    new_sup = spl.to_w16(core.sup_gain
                         + spl.to_w16((target - core.sup_gain) >> 4))
    core = core._replace(sup_gain=new_sup, sup_gain_old=sup_gain.to(I32))
    return core, new_sup


def _time_to_frequency_domain_f(time_signal, t: Tables,
                                abs_approx: bool = False):
    """core.time_to_frequency_domain, lane-major ((128, B) in); abs_approx
    takes the alpha-max-plus-beta-min magnitude (AECM_WITH_ABS_APPROX)."""
    max_abs = _max_abs_w16_0(time_signal)
    scaling = spl.norm_w16(max_abs)
    scaled = spl.to_w16(spl.shl_i32(time_signal, scaling))
    windowed = spl.to_w16((scaled * t.win128) >> 14)
    re, im = _real_forward_fft(windowed, t)
    z = _zeros_row(im)
    im = torch.cat([z, spl.to_w16(-im[1:D.PART_LEN]), z], dim=0)

    abs_re, mag = core_mod.bin_magnitudes(re, im, abs_approx)
    mag = torch.cat([_row(abs_re, 0), mag[1:D.PART_LEN],
                     _row(abs_re, D.PART_LEN)], dim=0)
    return scaling, (re, im), mag, _sum0_u32(mag)


def _inverse_fft_and_window_f(core, efw_re, efw_im, has_clean: bool,
                              t: Tables):
    """core.inverse_fft_and_window, lane-major."""
    ifft_out, out_cfft = _real_inverse_fft(efw_re, spl.to_w16(-efw_im), t)
    shift = out_cfft - core.dfa_clean_q
    P = D.PART_LEN
    first = spl.to_w16((ifft_out[:P] * t.win128[:P] + 8192) >> 14)
    output = spl.sat_w16(spl.shift_w32(first, shift) + core.out_buf)
    second = (ifft_out[P:] * t.win128[P:]) >> 14
    out_buf = spl.sat_w16(spl.shift_w32(second, shift))
    x_buf = torch.cat([core.x_buf[P:], core.x_buf[P:]], dim=0)
    d_noisy = torch.cat([core.d_buf_noisy[P:], core.d_buf_noisy[P:]], dim=0)
    core = core._replace(x_buf=x_buf, d_buf_noisy=d_noisy, out_buf=out_buf)
    if has_clean:
        core = core._replace(d_buf_clean=torch.cat(
            [core.d_buf_clean[P:], core.d_buf_clean[P:]], dim=0))
    return core, output


def _comfort_noise_f(core, dfa, efw_re, efw_im, lam, phase_v):
    """core.comfort_noise, lane-major; phase_v (64, B) int32 packs the Q13
    cos (low 16 bits) and sin (high 16 bits) of this block's draws."""
    cos_v = spl.to_w16(phase_v)
    sin_v = phase_v >> 16
    shift_noise = D.NOISE_EST_Q_DOMAIN - core.dfa_clean_q
    fast = core.noise_est_ctr < 100
    noise_est_ctr = torch.where(fast, core.noise_est_ctr + 1,
                                core.noise_est_ctr)
    min_track_shift = torch.where(fast, 6, 9).to(I32)

    noise = core.noise_est
    too_low = core.noise_est_too_low_ctr
    too_high = core.noise_est_too_high_ctr
    out_lshift = spl.shl_i32(dfa, shift_noise)

    below = out_lshift < noise
    small = noise < spl.shl_i32(torch.ones_like(min_track_shift),
                                min_track_shift)
    th_inc = too_high + 1
    dec_small = th_inc >= D.NOISE_EST_INC_COUNT
    noise_b_small = torch.where(dec_small, noise - 1, noise)
    th_small = torch.where(dec_small, 0, th_inc)
    noise_b_big = noise - spl.sar_i32(noise - out_lshift, min_track_shift)
    noise_below = torch.where(small, noise_b_small, noise_b_big)
    too_high_below = torch.where(small, th_small, too_high)
    big1 = (noise >> 19) > 0
    big2 = (noise >> 11) > 0
    noise_a1 = (noise >> 11) * 2049
    noise_a2 = (noise * 2049) >> 11
    tl_inc = too_low + 1
    inc_small = tl_inc >= D.NOISE_EST_INC_COUNT
    noise_a3 = torch.where(inc_small, noise + (noise >> 9) + 1, noise)
    tl_small = torch.where(inc_small, 0, tl_inc)
    noise_above = torch.where(big1, noise_a1,
                              torch.where(big2, noise_a2, noise_a3))
    too_low_above = torch.where(big1 | big2, too_low, tl_small)

    noise = torch.where(below, noise_below, noise_above)
    too_low = torch.where(below, 0, too_low_above).to(I32)
    too_high = torch.where(below, too_high_below, 0).to(I32)

    tmp32 = spl.sar_i32(noise, shift_noise)
    clip = tmp32 > 32767
    tmp32 = torch.where(clip, 32767, tmp32).to(I32)
    noise = torch.where(clip, spl.shl_i32(tmp32, shift_noise), noise)
    noise_rshift16 = spl.to_w16(
        ((D.ONE_Q14 - lam) * spl.to_w16(tmp32)) >> 14)

    amp = noise_rshift16[1:]
    z = _zeros_row(amp)
    u_real = torch.cat([z, spl.to_w16((amp * cos_v) >> 13)], dim=0)
    u_imag = torch.cat([z, spl.to_w16((-amp[:-1] * sin_v[:-1]) >> 13), z],
                       dim=0)
    efw_re = spl.add_sat_w16(efw_re, u_real)
    efw_im = spl.add_sat_w16(efw_im, u_imag)
    core = core._replace(noise_est=noise, noise_est_too_low_ctr=too_low,
                         noise_est_too_high_ctr=too_high,
                         noise_est_ctr=noise_est_ctr.to(I32))
    return core, efw_re, efw_im


def _calc_step_size_f(core):
    """core.calc_step_size, lane-major."""
    tmp32 = (core.far_log_energy - core.far_energy_min) * D.MU_DIFF
    ratio = spl.to_w16(spl.div_w32_w16(tmp32, core.far_energy_max_min))
    mu_dyn = (D.MU_MIN - 1 - ratio).clamp(min=D.MU_MAX)
    mu = torch.where(core.far_energy_min >= core.far_energy_max,
                     D.MU_MIN, mu_dyn)
    mu = torch.where(core.startup_state > 0, mu, D.MU_MAX)
    return torch.where(core.current_vad_value == 0, 0, mu).to(I32)


def _process_block_f(core, t: Tables, farend, nearend_noisy, nearend_clean,
                     phase_v, mult: int, has_clean: bool, abs_approx: bool,
                     far_ctx):
    """core.process_block, lane-major; blocks are (64, B).  The CNG seed
    passes through (advanced before the step), and the far-history update
    is deferred through far_ctx."""
    P = D.PART_LEN
    startup_state = torch.where(
        core.startup_state < 2,
        (core.tot_count >= D.CONV_LEN).to(I32)
        + (core.tot_count >= D.CONV_LEN2).to(I32),
        core.startup_state)
    core = core._replace(
        startup_state=startup_state,
        x_buf=torch.cat([core.x_buf[:P], farend], dim=0),
        d_buf_noisy=torch.cat([core.d_buf_noisy[:P], nearend_noisy], dim=0))
    if has_clean:
        core = core._replace(d_buf_clean=torch.cat(
            [core.d_buf_clean[:P], nearend_clean], dim=0))

    far_q, _, xfa, _ = _time_to_frequency_domain_f(core.x_buf, t, abs_approx)
    zeros_d_noisy, dfw, dfa_noisy, dfa_noisy_sum = (
        _time_to_frequency_domain_f(core.d_buf_noisy, t, abs_approx))
    core = core._replace(dfa_noisy_q_old=core.dfa_noisy_q,
                         dfa_noisy_q=zeros_d_noisy)
    if has_clean:
        # the clean Q history is its own (dfa_clean_q_old takes the old
        # dfa_clean_q, not dfa_noisy_q_old), and the Wiener stage filters
        # the clean spectrum
        zeros_d_clean, dfw, ptr_dfa_clean, _ = _time_to_frequency_domain_f(
            core.d_buf_clean, t, abs_approx)
        core = core._replace(dfa_clean_q_old=core.dfa_clean_q,
                             dfa_clean_q=zeros_d_clean)
    else:
        core = core._replace(dfa_clean_q_old=core.dfa_noisy_q_old,
                             dfa_clean_q=core.dfa_noisy_q)
        ptr_dfa_clean = dfa_noisy

    _push_far_pending(far_ctx, xfa, far_q)
    core = core._replace(
        de_farend=_add_far_spectrum_fix_f(core.de_farend, xfa, far_q))
    de_near, delay = _process_fix_f(core.de_near, core.de_farend,
                                    dfa_noisy, zeros_d_noisy)
    core = core._replace(de_near=de_near)
    delay = torch.where(delay == -2, 0, delay)
    delay = torch.where(core.fixed_delay >= 0, core.fixed_delay, delay)

    far_spectrum, zeros_x_buf = _aligned_farend_deferred(far_ctx, delay)

    core, echo_est = _calc_energies_f(core, far_spectrum, zeros_x_buf,
                                      dfa_noisy_sum)
    mu = _calc_step_size_f(core)
    core = core._replace(tot_count=core.tot_count + 1)
    core, echo_est = _update_channel_f(core, far_spectrum, zeros_x_buf,
                                       dfa_noisy, mu, echo_est)
    core, sup_gain = _calc_suppression_gain_f(core)

    # --- Wiener filter hnl ---
    diff = echo_est - core.echo_filt
    echo_filt = core.echo_filt + spl.mul_i64_shift_right(diff, 50, 8)

    zeros32 = spl.norm_w32(echo_filt) + 1
    zeros16 = spl.norm_w16(sup_gain) + 1
    safe = zeros32 + zeros16 > 16
    gained_safe = (spl.u32(echo_filt) * spl.u32(sup_gain)) & spl.MASK32
    tmp16_no1 = 17 - zeros32 - zeros16
    res_diff_safe = (14 - D.RESOLUTION_CHANNEL16 - D.RESOLUTION_SUPGAIN
                     + core.dfa_clean_q - zeros_x_buf)
    res_diff_unsafe = (14 + tmp16_no1 - D.RESOLUTION_CHANNEL16
                       - D.RESOLUTION_SUPGAIN + core.dfa_clean_q
                       - zeros_x_buf)
    gained_a = (spl.u32(echo_filt)
                * spl.u32(spl.sar_i32(sup_gain, tmp16_no1))) & spl.MASK32
    gained_b = spl.u32(spl.sar_i32(echo_filt, tmp16_no1) * sup_gain)
    gained_unsafe = torch.where(zeros32 > tmp16_no1, gained_a, gained_b)
    echo_est_gained = torch.where(safe, gained_safe, gained_unsafe)
    resolution_diff = torch.where(safe, res_diff_safe, res_diff_unsafe)

    zeros16n = spl.norm_w16(core.near_filt)
    dq_diff = core.dfa_clean_q - core.dfa_clean_q_old
    cramped = (zeros16n < dq_diff) & (core.near_filt != 0)
    t1_a = spl.to_w16(spl.shl_i32(core.near_filt, zeros16n))
    qdd_a = zeros16n - dq_diff
    t2_a = spl.sar_i32(ptr_dfa_clean, -qdd_a)
    t1_b = spl.to_w16(torch.where(dq_diff < 0,
                                  spl.sar_i32(core.near_filt, -dq_diff),
                                  spl.shl_i32(core.near_filt, dq_diff)))
    t2_b = spl.to_w16(ptr_dfa_clean)
    tmp16no1 = torch.where(cramped, t1_a, t1_b)
    q_domain_diff = torch.where(cramped, qdd_a, 0)
    tmp16no2 = torch.where(cramped, t2_a, t2_b)

    t32 = tmp16no2 - tmp16no1
    tmp16no2 = spl.to_w16(spl.to_w16(t32 >> 4) + tmp16no1)
    zeros16n2 = spl.norm_w16(tmp16no2)
    sat_near = ((tmp16no2 & 1) != 0) & (-q_domain_diff > zeros16n2)
    near_filt = torch.where(
        sat_near, D.WORD16_MAX,
        torch.where(q_domain_diff < 0,
                    spl.to_w16(spl.shl_i32(tmp16no2, -q_domain_diff)),
                    spl.sar_i32(tmp16no2, q_domain_diff)))

    rounded = (echo_est_gained + spl.u32(spl.sar_i32(near_filt, 1))
               ) & spl.MASK32
    ratio = spl.div_u32_u16(rounded, spl.u32(near_filt & 0xFFFF))
    tmp32no1 = spl.wrap32(spl.shift_w32(ratio, resolution_diff))
    hnl_core = (D.ONE_Q14 - tmp32no1).clamp(min=0)
    hnl = torch.where(tmp32no1 > D.ONE_Q14, 0,
                      torch.where(tmp32no1 < 0, D.ONE_Q14, hnl_core))
    hnl = torch.where(echo_est_gained == 0, D.ONE_Q14,
                      torch.where(near_filt == 0, 0, hnl)).to(I32)
    num_pos_coef = _sum0((hnl != 0).to(I32))

    core = core._replace(echo_filt=echo_filt, near_filt=near_filt.to(I32))

    if mult == 2:
        hnl = spl.to_w16((hnl * hnl) >> 14)
        k_min, k_max = 4, 24
        avg = _sum0(hnl[k_min:k_max + 1])
        avg = spl.div_trunc(avg, k_max - k_min + 1)
        upper = _iota_col(D.PART_LEN1, hnl.device) >= k_max
        hnl = torch.where(upper & (hnl > avg), avg, hnl)

    nlp_hnl = torch.where(hnl < D.NLP_COMP_LOW, 0,
                          torch.where(hnl > D.NLP_COMP_HIGH, D.ONE_Q14, hnl))
    nlp_gain = torch.where(num_pos_coef < 3, 0, D.ONE_Q14).to(I32)
    nlp_hnl = torch.where((nlp_hnl == D.ONE_Q14) & (nlp_gain == D.ONE_Q14),
                          D.ONE_Q14, spl.to_w16((nlp_hnl * nlp_gain) >> 14))
    hnl = torch.where(core.nlp_flag != 0, nlp_hnl, hnl)

    dfw_re, dfw_im = dfw
    efw_re = spl.to_w16((dfw_re * hnl + 8192) >> 14)
    efw_im = spl.to_w16((dfw_im * hnl + 8192) >> 14)

    cng_core, cng_re, cng_im = _comfort_noise_f(core, ptr_dfa_clean,
                                                efw_re, efw_im, hnl, phase_v)
    use_cng = core.cng_mode != 0
    core = core._replace(**{
        f: torch.where(use_cng, getattr(cng_core, f), getattr(core, f))
        for f in ("noise_est", "noise_est_too_low_ctr",
                  "noise_est_too_high_ctr", "noise_est_ctr")})
    efw_re = torch.where(use_cng, cng_re, efw_re)
    efw_im = torch.where(use_cng, cng_im, efw_im)

    return _inverse_fft_and_window_f(core, efw_re, efw_im, has_clean, t)


def _place_at_fill(carry, payload, fill):
    """core._place_at_fill, lane-major: carry (64, B), payload (P, B),
    fill (1, B) in {0, 16, 32, 48} -> (P + 64, B)."""
    pad = torch.zeros((D.PART_LEN,) + payload.shape[1:], dtype=payload.dtype,
                      device=payload.device)
    out = torch.cat([payload, pad], dim=0)
    sel = fill >> 4
    for k in (1, 2, 3):
        cand = torch.cat([carry[:16 * k], payload, pad[:64 - 16 * k]], dim=0)
        out = torch.where(sel == k, cand, out)
    return torch.where((sel >= 0) & (sel <= 3), out, 0)


def _where_tree(mask, new, old):
    """Per-lane select over a state tree; leaves passed through untouched
    (the same object in new and old) are not copied."""
    return tree_map(lambda a, b: b if a is b else torch.where(mask, a, b),
                    new, old)


def _n_slots_for(n_frames: int) -> int:
    """Max live 64-sample blocks over an n_frames-frame span (carry fill
    <= 48)."""
    return (n_frames * D.FRAME_LEN + 48) // D.PART_LEN


def _select_slot(outs, idx):
    sel = torch.zeros_like(outs[0])
    for s, o in enumerate(outs):
        sel = torch.where(idx == s, o, sel)
    return sel


def _suffix_frames(payload, k, n_frames: int, frames_per_chunk: int):
    """Front-align the last k frames of payload ((n*80, B)), zeros after;
    k (1, B) is a multiple of frames_per_chunk."""
    F = D.FRAME_LEN
    out = torch.zeros_like(payload)
    for kk in range(frames_per_chunk, n_frames + 1, frames_per_chunk):
        cand = torch.cat([payload[(n_frames - kk) * F:],
                          torch.zeros_like(payload[:(n_frames - kk) * F])],
                         dim=0)
        out = torch.where(k == kk, cand, out)
    return out


def _emit_frame_f(core, produced, two_blocks, run_mask):
    """The 80-sample output assembly of core.process_frame (out_carry /
    out_fill / first-frame zero-stuff / out_tail), lane-major; `produced`
    is (128, B), the second half zero when the frame made one block."""
    o = core.out_fill
    n_blocks = 1 + two_blocks.to(I32)
    work_out = _place_at_fill(core.out_carry, produced, o)
    avail = o + n_blocks * D.PART_LEN
    stuff = (D.FRAME_LEN - avail).clamp(min=0)
    stuffed = stuff > 0
    out = torch.where(stuffed, torch.cat([core.out_tail, work_out[:64]], 0),
                      work_out[:D.FRAME_LEN])
    new_carry = torch.where(stuffed, work_out[64:64 + D.PART_LEN],
                            work_out[D.FRAME_LEN:D.FRAME_LEN + D.PART_LEN])
    core = core._replace(
        out_carry=torch.where(run_mask, new_carry, core.out_carry),
        out_fill=torch.where(run_mask, avail + stuff - D.FRAME_LEN,
                             core.out_fill),
        out_tail=torch.where(run_mask, out[-16:], core.out_tail))
    return core, out


def frames_step(core, t: Tables, far_frames, noisy_frames, clean_frames,
                phase_all, run_rows, mult: int, n_frames: int,
                has_clean: bool, abs_approx: bool = False,
                frames_per_chunk: int = 1, far_head=None):
    """The full n_frames-frame core path, lane-major, as the slot-major
    block schedule of the JAX package's `frames_step`: block s is always
    samples [64s, 64s + 64) of the stream carry + payload, and
    (fill0 + 80k) // 64 of the _n_slots_for(n_frames) slots are live.

    far/noisy/clean_frames: (n_frames*80, B) int32 (clean_frames None
    unless has_clean); phase_all: (n_slots*64, B) packed CNG phase rows;
    run_rows: (n_frames, B) bool, non-decreasing along frames and constant
    within a chunk.  far_head None: the far history is newest-first and the
    step's new blocks are merged into it, returns (core, out (n_frames*80,
    B)).  far_head an int or a 0-d int32 tensor (the circular history's
    head, the same for every stream): the history leaves pass through
    untouched and the step returns (core, out, pend_hist (n_slots*40, B),
    pend_q (n_slots, B)) for the caller to append.  This is the plain version of the frames kernel."""
    F, P = D.FRAME_LEN, D.PART_LEN
    n = n_frames
    n_slots = _n_slots_for(n)
    assert phase_all.shape[0] == n_slots * P, (phase_all.shape, n_slots)
    fill0 = core.frame_fill
    k = _sum0(run_rows.to(I32))
    run_last = run_rows[n - 1:n]
    pad_rows = P * (n_slots + 1) - (n * F + P)

    def stream(carry, payload):
        placed = _place_at_fill(
            carry, _suffix_frames(payload, k, n, frames_per_chunk), fill0)
        if pad_rows:
            placed = torch.cat([placed, placed.new_zeros(
                (pad_rows,) + placed.shape[1:])], dim=0)
        return placed

    full_far = stream(core.in_carry_far, far_frames)
    full_noi = stream(core.in_carry_noisy, noisy_frames)
    full_cl = (stream(core.in_carry_clean, clean_frames) if has_clean
               else None)

    total = fill0 + F * k
    far_ctx = {"hist": core.far_history, "q": core.far_q_domains,
               "pending": [], "pending_q": [], "head0": far_head}
    outs = []
    for s in range(n_slots):
        act = total >= P * (s + 1)
        rows = slice(s * P, (s + 1) * P)
        new_core, out_b = _process_block_f(
            core, t, full_far[rows], full_noi[rows],
            full_cl[rows] if has_clean else None, phase_all[rows], mult,
            has_clean, abs_approx, far_ctx)
        core = _where_tree(act, new_core, core)
        outs.append(torch.where(act, out_b, 0))

    if far_head is None:
        n_act = total >> 6
        core = core._replace(
            far_history=_far_merge_deferred(
                core.far_history, far_ctx["pending"], n_act, FAR_HIST_ROWS),
            far_q_domains=_far_merge_deferred(
                core.far_q_domains, far_ctx["pending_q"], n_act, 1))
    else:
        pend_hist = torch.cat(far_ctx["pending"], dim=0)
        pend_q = torch.cat(far_ctx["pending_q"], dim=0)

    # in-carry update: rows [64, 128) of the last active frame's window
    b_last_p1 = ((fill0 + F * (k - 1).clamp(min=0)) >> 6) + 1

    def carry_from(full, old):
        sel = torch.zeros_like(old)
        for w in range(1, n_slots + 1):
            sel = torch.where(b_last_p1 == w, full[w * P:(w + 1) * P], sel)
        return torch.where(run_last, sel, old)

    core = core._replace(
        in_carry_far=carry_from(full_far, core.in_carry_far),
        in_carry_noisy=carry_from(full_noi, core.in_carry_noisy),
        frame_fill=(fill0 + 16 * k) & 63)
    if has_clean:
        core = core._replace(
            in_carry_clean=carry_from(full_cl, core.in_carry_clean))

    # per-frame output attribution + the 80-sample emit, in frame order
    out_frames = []
    for f in range(n):
        run_f = run_rows[f:f + 1]
        j_f = (k - (n - f)).clamp(min=0)
        two_f = (((fill0 + 16 * j_f) & 63) >= 48) & run_f
        b_f = (fill0 + F * j_f) >> 6
        first = _select_slot(outs, b_f)
        second = torch.where(two_f, _select_slot(outs, b_f + 1), 0)
        core, out_f = _emit_frame_f(core, torch.cat([first, second], 0),
                                    two_f, run_f)
        out_frames.append(out_f)
    out = torch.cat(out_frames, dim=0)
    if far_head is None:
        return core, out
    return core, out, pend_hist, pend_q


def frames_step_cng(core, t: Tables, far_frames, noisy_frames, clean_frames,
                    run_rows, mult: int, n_frames: int, has_clean: bool,
                    abs_approx: bool = False, frames_per_chunk: int = 1,
                    far_head=None):
    """The plain version of the frames kernel (fused_kernel.
    frames_kernel_call): the CNG chain (_precompute_cng_phases), then
    frames_step on the advanced seed.  Returns what frames_step returns."""
    phase_all, seed = _precompute_cng_phases(core, run_rows, n_frames, t)
    return frames_step(core._replace(seed=seed), t, far_frames, noisy_frames,
                       clean_frames, phase_all, run_rows, mult, n_frames,
                       has_clean, abs_approx, frames_per_chunk, far_head)


# ---------------------------------------------------------------------------
# Control layer (batch-leading) and the serving step
# ---------------------------------------------------------------------------

class CtrlState(NamedTuple):
    """AecmState minus core (echo_control_mobile.cc:42-79), batch-leading."""
    farend_buf: rbuf.RingBuffer        # data (B, 4000) int16, pointers (B,)
    farend_old: torch.Tensor           # (B, 2, 80)
    ec_startup: torch.Tensor           # (B,) scalars...
    check_buff_size: torch.Tensor
    check_buf_size_ctr: torch.Tensor
    counter: torch.Tensor
    sum: torch.Tensor
    first_val: torch.Tensor
    buf_size_start: torch.Tensor
    ms_in_sndcard_buf: torch.Tensor
    filt_delay: torch.Tensor
    time_for_delay_change: torch.Tensor
    known_delay: torch.Tensor
    last_delay_diff: torch.Tensor
    delay_change: torch.Tensor
    echo_mode: torch.Tensor


class FusedState(NamedTuple):
    """Batched AECM state in the fused layout: control fields batch-leading,
    core fields lane-major (rows, n_streams)."""
    ctrl: CtrlState
    core: core_mod.CoreState


def to_fused_state(state_b) -> FusedState:
    """Batched control.AecmState -> FusedState."""
    ctrl = CtrlState(**{f: getattr(state_b, f) for f in CtrlState._fields})
    return FusedState(ctrl=ctrl, core=to_fused_core(state_b.core))


def from_fused_state(fstate: FusedState) -> control.AecmState:
    return control.AecmState(core=from_fused_core(fstate.core),
                             **fstate.ctrl._asdict())


def create_fused(n_streams: int, sample_rate: int = 8000, cng_mode: int = 1,
                 echo_mode: int = 3, device=None) -> FusedState:
    """N fresh streams in the fused layout, on `device` (the CUDA card
    unless the caller asks for another)."""
    from .parallel import batch as pbatch
    return to_fused_state(pbatch.create_batch(n_streams, sample_rate,
                                              cng_mode, echo_mode,
                                              device=device))


def _ring_write_gather_multi(data, wpos, values, n_write, rpos, n_read: int):
    """The plain jitter-ring pass: for c = 0..cps-1, a wrapped write of
    chunk c's far samples, then a wrapped gather of chunk c's n_read
    samples (chunk c's gather sees writes 0..c).  wpos/n_write/rpos (cps,
    B); values (B, cps*n_read).  Returns (new ring, gathered (B,
    cps*n_read) int32); the input ring is not modified.  This is the plain
    version of the ring kernel (ops/ring_kernels.py)."""
    outs = []
    for c in range(wpos.shape[0]):
        data = rbuf._contig_write(
            data, wpos[c], values[:, c * n_read:(c + 1) * n_read], n_write[c])
        outs.append(rbuf._contig_read(data, rpos[c], n_read).to(I32))
    return data, torch.cat(outs, dim=1)


def _precompute_cng_phases(core_f, run_rows, n_frames: int, t: Tables):
    """Advance the CNG LCG chain and look up the phase tables ahead of
    frames_step (as the JAX package does outside its kernel; the frames
    kernel draws the same phases lane by lane and advances the seed
    itself).  An active slot s always draws from the seed advanced exactly
    64*s times, so the whole chain is one affine-closure op over the step's
    draws.  Returns phase_all (n_slots*64, B) int32 (Q13 cos in the low 16
    bits, sin in the high 16) and the new seed row (1, B)."""
    n_slots = _n_slots_for(n_frames)
    seed = core_f.seed
    cng = core_f.cng_mode != 0
    k = _sum0(run_rows.to(I32))
    n_act = (core_f.frame_fill + D.FRAME_LEN * k) >> 6

    seeds_all = (t.lcg_a[:n_slots * D.PART_LEN] * seed
                 + t.lcg_c[:n_slots * D.PART_LEN]) & tables.LCG_MASK
    rand_w16 = (seeds_all >> 16).to(I32)
    idx_all = (359 * rand_w16) >> 15
    cos_all, sin_all = core_mod._phase_table_lookup(idx_all, t.cos360,
                                                    t.sin360)
    phase_all = spl.wrap32((cos_all.to(I64) & 0xFFFF)
                           | (sin_all.to(I64) << 16))
    new_seed = seed
    for v in range(1, n_slots + 1):
        new_seed = torch.where(cng & (n_act >= v),
                               seeds_all[v * D.PART_LEN - 1:v * D.PART_LEN],
                               new_seed)
    return phase_all, new_seed


def _to_circular_far(core_f):
    """Newest-first far history -> circular order at head 0."""
    b = core_f.far_history.shape[-1]
    h3 = core_f.far_history.view(D.MAX_DELAY, FAR_HIST_ROWS, b)
    return core_f._replace(
        far_history=torch.flip(h3, (0,)).reshape(-1, b),
        far_q_domains=torch.flip(core_f.far_q_domains, (0,)))


def _from_circular_far(core_f, head):
    """Circular order at `head` (an int or a 0-d int32 tensor) ->
    newest-first: nf[d] = circ[(head - 1 - d) mod MAX_DELAY], one gather
    (no read of the head on the host)."""
    b = core_f.far_history.shape[-1]
    h3 = core_f.far_history.view(D.MAX_DELAY, FAR_HIST_ROWS, b)
    idx = torch.remainder(head - 1 - torch.arange(
        D.MAX_DELAY, device=h3.device), D.MAX_DELAY)
    return core_f._replace(
        far_history=h3.index_select(0, idx).reshape(-1, b),
        far_q_domains=core_f.far_q_domains.index_select(0, idx))


def _check_envelope(sample_rate: int, use_kernel: bool, state=None,
                    has_clean: bool = False):
    """What the port still refuses: a sample rate other than 8 or 16 kHz,
    and on the kernel path a delay-estimator history size whose one stream
    does not fit a thread block's shared memory
    (fused_kernel.check_fits)."""
    if sample_rate not in (8000, 16000):
        raise ValueError("sample_rate must be 8000 or 16000")
    if use_kernel and state is not None:
        from . import fused_kernel
        fused_kernel.check_fits(state.core, has_clean)


class FusedAecm(nn.Module):
    """One serving step of `chunks_per_step` x 10 ms on a FusedState: the
    JAX package's make_fused_chunk_step.  The constant tables are buffers.

    forward(state, far, noisy[, clean], ms) -> (state, out, warn), or with
    circular_far forward(state, head, far, noisy[, clean], ms) -> (state,
    head', out, warn) where head is the circular far history's head: a 0-d
    int32 tensor on the state's device, as the JAX package carries it in its
    scan (the frames kernel reads it from device memory, the new blocks are
    placed by index, so a CUDA graph of the step serves every head), or an
    int, which comes back an int.  far is (B, cps*chunk) batch-leading;
    noisy / clean / out are the same shape, or (cps*chunk, B) lane-major
    when lane_major_io; ms a scalar, (B,) or (cps, B); warn (B,) at cps =
    1, else (cps, B).
    circular_far needs an exact-block schedule (cps*chunk a multiple of
    64, the block count dividing 100); left None it is taken wherever the
    schedule is exact-block (the serving defaults, 2 chunks at 16 kHz and 4
    at 8 kHz, are).

    The step consumes its input state: on the kernel path the ring kernel
    and the frames kernel update the ring and every core leaf in place (as
    input_output_aliases does in the JAX kernels), and the circular append
    writes into core.far_history.  Use the returned state.

    use_kernel=True runs the CUDA kernels for CUDA tensors and the plain
    versions for CPU tensors (the wrappers dispatch on the device);
    use_kernel=False runs the plain versions on any device."""

    def __init__(self, sample_rate: int = 16000,
                 chunks_per_step: Optional[int] = None,
                 use_kernel: bool = True, device=None,
                 has_clean: bool = False, abs_approx: bool = False,
                 lane_major_io: bool = True,
                 circular_far: Optional[bool] = None):
        super().__init__()
        cps = chunks_per_step or (4 if sample_rate == 8000 else 2)
        _check_envelope(sample_rate, use_kernel)
        device = _device.resolve(device)
        self.sample_rate = sample_rate
        self.cps = cps
        self.use_kernel = use_kernel
        self.has_clean = has_clean
        self.abs_approx = abs_approx
        self.lane_major_io = lane_major_io
        self.mult = sample_rate // 8000
        self.out_len = min(160, sample_rate // 100)
        self.fpc = self.out_len // D.FRAME_LEN
        self.n_blocks_10ms = self.fpc // self.mult
        self.est_idx = 0 if sample_rate == 8000 else 1
        self.n_frames = self.fpc * cps
        self.s_blocks = (self.n_frames * D.FRAME_LEN) // D.PART_LEN
        if circular_far is None:
            circular_far = _exact_block(cps * self.out_len)
        self.circular_far = circular_far
        if circular_far and not _exact_block(cps * self.out_len):
            raise ValueError(
                f"circular_far needs an exact-block schedule: {cps} chunks "
                f"of {self.out_len} samples are not a whole number of "
                f"{D.PART_LEN}-sample blocks dividing {D.MAX_DELAY}")
        for name, v in make_tables(device, _n_slots_for(self.n_frames)
                                   )._asdict().items():
            self.register_buffer(name, v, persistent=False)
        # the rows of the circular history that a step's new blocks take,
        # from the head's
        self.register_buffer("pend_rows", torch.arange(
            self.s_blocks * FAR_HIST_ROWS, device=device), persistent=False)

    @property
    def tables(self) -> Tables:
        return Tables(**{f: getattr(self, f) for f in Tables._fields})

    def _ctrl_chunk_ptr(self, ctrl: CtrlState, ms_c):
        """The exact per-10 ms control sequence (echo_control_mobile.cc),
        pointer phase: delay comp, jitter-ring write pointer, sndcard
        clamp, startup machine, per-frame availability + EstBufDelay,
        startup-field merge.  The ring data pass is deferred to one pass
        per step.  Returns (ctrl, (write_pos, n_write, read_pos), haves,
        run, in_startup, warn)."""
        mult = self.mult
        comped = control._delay_comp(ctrl, mult)
        enabled = ctrl.ec_startup == 0
        fb = ctrl.farend_buf
        ctrl = ctrl._replace(
            farend_buf=fb._replace(
                read_pos=torch.where(enabled, comped.farend_buf.read_pos,
                                     fb.read_pos),
                rw_wrap=torch.where(enabled, comped.farend_buf.rw_wrap,
                                    fb.rw_wrap)),
            delay_change=torch.where(enabled, comped.delay_change,
                                     ctrl.delay_change))
        fb = ctrl.farend_buf
        cap = fb.capacity
        n_write = rbuf.available_write(fb).clamp(max=self.out_len)
        margin = cap - fb.write_pos
        wrapped = n_write > margin
        write_pos0 = fb.write_pos
        ctrl = ctrl._replace(farend_buf=fb._replace(
            write_pos=torch.where(wrapped, n_write - margin,
                                  fb.write_pos + n_write).to(I32),
            rw_wrap=torch.where(wrapped, rbuf.DIFF_WRAP, fb.rw_wrap
                                ).to(I32)))

        warn = torch.where((ms_c < 0) | (ms_c > 500),
                           D.AECM_BAD_PARAMETER_WARNING, 0).to(I32)
        ctrl = ctrl._replace(ms_in_sndcard_buf=(ms_c.clamp(0, 500) + 10
                                                ).to(I32))
        in_startup = ctrl.ec_startup != 0
        run = ~in_startup
        started = control._startup_machine(ctrl, self.n_blocks_10ms, mult)

        read_pos0 = ctrl.farend_buf.read_pos
        haves = []
        for i in range(self.fpc):
            filled = torch.div(rbuf.available_read(ctrl.farend_buf),
                               D.FRAME_LEN, rounding_mode="floor")
            have_data = (filled > 0) & run
            haves.append(have_data)
            ctrl = ctrl._replace(farend_buf=rbuf.move_read_ptr(
                ctrl.farend_buf,
                torch.where(have_data, D.FRAME_LEN, 0).to(I32)))
            if i == self.est_idx:
                est = control._est_buf_delay(ctrl, mult)
                fb = ctrl.farend_buf
                ctrl = ctrl._replace(
                    farend_buf=fb._replace(
                        read_pos=torch.where(run, est.farend_buf.read_pos,
                                             fb.read_pos),
                        rw_wrap=torch.where(run, est.farend_buf.rw_wrap,
                                            fb.rw_wrap)),
                    **{f: torch.where(run, getattr(est, f), getattr(ctrl, f))
                       for f in ("filt_delay", "time_for_delay_change",
                                 "known_delay", "last_delay_diff")})

        fb = ctrl.farend_buf
        ctrl = ctrl._replace(
            farend_buf=fb._replace(
                read_pos=torch.where(in_startup, started.farend_buf.read_pos,
                                     fb.read_pos),
                rw_wrap=torch.where(in_startup, started.farend_buf.rw_wrap,
                                    fb.rw_wrap)),
            **{f: torch.where(in_startup, getattr(started, f),
                              getattr(ctrl, f))
               for f in ("ec_startup", "check_buff_size",
                         "check_buf_size_ctr", "counter", "sum",
                         "first_val", "buf_size_start")})
        return (ctrl, (write_pos0, n_write, read_pos0), haves, run,
                in_startup, warn)

    def _ring_pass(self, ptrs, data, far):
        """The step's jitter-ring data pass: one ring_pass launch at one
        chunk per step, one ring_multi_pass launch at more."""
        from .ops import ring_kernels
        wpos, n_write, rpos = (torch.stack([p[i] for p in ptrs])
                               for i in range(3))
        if not self.use_kernel:
            return _ring_write_gather_multi(data, wpos, far, n_write, rpos,
                                            self.out_len)
        if self.cps == 1:
            return ring_kernels.ring_pass(data, wpos[0], far, n_write[0],
                                          rpos[0], self.out_len)
        return ring_kernels.ring_multi_pass(data, wpos, far, n_write, rpos,
                                            self.out_len)

    def forward(self, state: FusedState, *args):
        from . import fused_kernel
        head = args[0] if self.circular_far else None
        args = args[1:] if self.circular_far else args
        if len(args) != 3 + self.has_clean:
            raise TypeError(
                "expected (state, " + ("head, " if self.circular_far else "")
                + "far, noisy, " + ("clean, " if self.has_clean else "")
                + "ms)")
        far, noisy = args[0], args[1]
        clean = args[2] if self.has_clean else None
        ms = args[-1]
        t = self.tables
        cps, out_len, fpc = self.cps, self.out_len, self.fpc
        ctrl, core_f = state.ctrl, state.core
        _check_envelope(self.sample_rate, self.use_kernel, state,
                        self.has_clean)
        b = ctrl.ec_startup.shape[0]
        dev = ctrl.ec_startup.device
        ms_all = _device.as_int32(ms, dev).expand(cps, b)

        # --- pointer phase: the exact per-chunk control sequence ---
        ring_data0 = ctrl.farend_buf.data
        ptrs, haves_l, run_l, startup_l, warns = [], [], [], [], []
        for c in range(cps):
            ctrl, ptr_c, haves_c, run_c, in_st_c, warn_c = \
                self._ctrl_chunk_ptr(ctrl, ms_all[c])
            ptrs.append(ptr_c)
            haves_l.append(haves_c)
            run_l.append(run_c)
            startup_l.append(in_st_c)
            warns.append(warn_c)

        # --- one ring data pass for all cps chunks ---
        new_ring, gathered = self._ring_pass(
            ptrs, ring_data0,
            torch.as_tensor(far, device=dev).to(I32).contiguous())
        ctrl = ctrl._replace(
            farend_buf=ctrl.farend_buf._replace(data=new_ring))

        # --- frame assembly + underrun replay ---
        frames_far = []
        farend_old = ctrl.farend_old
        for c in range(cps):
            rows_old = []
            for i in range(fpc):
                old_i = farend_old[:, i, :]
                lo = c * out_len + i * D.FRAME_LEN
                farend_i = torch.where(haves_l[c][i][:, None],
                                       gathered[:, lo:lo + D.FRAME_LEN],
                                       old_i)
                rows_old.append(torch.where(run_l[c][:, None], farend_i,
                                            old_i))
                frames_far.append(farend_i)
            # at 8 kHz (one frame a chunk) the second replay row stays
            farend_old = torch.stack(
                rows_old + [farend_old[:, i] for i in range(fpc, 2)], dim=1)
        ctrl = ctrl._replace(farend_old=farend_old)
        run_rows = torch.stack([r for r in run_l for _ in range(fpc)], dim=0)

        far_lm = torch.cat([f.T for f in frames_far], dim=0).contiguous()

        def to_lm(x):
            x = torch.as_tensor(x, device=dev).to(I32)
            return (x if self.lane_major_io else x.T).contiguous()
        noisy_lm = to_lm(noisy)
        clean_lm = to_lm(clean) if self.has_clean else None
        fill0 = core_f.frame_fill.clone()   # the kernel updates it in place

        # --- the core, CNG draws included (the kernel advances the seed) ---
        frames = (fused_kernel.frames_kernel_call if self.use_kernel
                  else frames_step_cng)
        res = frames(core_f, t, far_lm, noisy_lm, clean_lm, run_rows,
                     self.mult, self.n_frames, self.has_clean,
                     self.abs_approx, fpc, head)

        if self.circular_far:
            core_f, out_lm, pend_hist, pend_q = res
            # Streams that started mid-step have n_act < S pending blocks;
            # they shift to the END of the head window (rows left uncovered
            # = zeros = the initial history), which holds because a stream
            # starts once and never pauses.
            S = self.s_blocks
            k_act = _sum0(run_rows.to(I32))
            rot = S - ((fill0 + D.FRAME_LEN * k_act) >> 6)
            ph, pq = pend_hist, pend_q
            for r in range(1, S + 1):
                cand_h = torch.cat(
                    [torch.zeros_like(pend_hist[:r * FAR_HIST_ROWS]),
                     pend_hist[:(S - r) * FAR_HIST_ROWS]], dim=0)
                cand_q = torch.cat([torch.zeros_like(pend_q[:r]),
                                    pend_q[:S - r]], dim=0)
                ph = torch.where(rot == r, cand_h, ph)
                pq = torch.where(rot == r, cand_q, pq)
            core_f.far_history.index_copy_(
                0, head * FAR_HIST_ROWS + self.pend_rows, ph)
            core_f.far_q_domains.index_copy_(
                0, head + self.pend_rows[:S], pq)
            head = (head + S) % D.MAX_DELAY
        else:
            core_f, out_lm = res

        # --- per-chunk startup passthrough of the near input (the clean
        # one when there is one, echo_control_mobile.cc:289) ---
        pass_lm = clean_lm if self.has_clean else noisy_lm
        out_lm = torch.cat([
            torch.where(startup_l[c][None, :],
                        pass_lm[c * out_len:(c + 1) * out_len],
                        out_lm[c * out_len:(c + 1) * out_len])
            for c in range(cps)], dim=0)
        out = out_lm if self.lane_major_io else out_lm.T.contiguous()
        warn = warns[0] if cps == 1 else torch.stack(warns, dim=0)
        new_state = FusedState(ctrl=ctrl, core=core_f)
        if self.circular_far:
            return new_state, head, out, warn
        return new_state, out, warn


def make_fused_chunk_step(sample_rate: int, has_clean: bool = False,
                          use_kernel: bool = True, abs_approx: bool = False,
                          lane_major_io: bool = False,
                          chunks_per_step: int = 1,
                          circular_far: bool = False,
                          device=None) -> FusedAecm:
    """The JAX package's factory of the same name, with its defaults: one
    10 ms real-time step, batch-leading input and output, newest-first far
    history.  Returns the FusedAecm module (see there)."""
    return FusedAecm(sample_rate, chunks_per_step, use_kernel, device,
                     has_clean, abs_approx, lane_major_io, circular_far)


def _exact_block(span: int) -> bool:
    """A span of `span` samples is whole 64-sample blocks whose count
    divides the 100-block history: the circular schedule's condition."""
    return (span % D.PART_LEN == 0
            and D.MAX_DELAY % (span // D.PART_LEN) == 0)


def clone_state(state):
    return tree_map(lambda x: x.clone(), state)


@functools.lru_cache(maxsize=16)
def _span_step(sample_rate: int, cps: int, use_kernel: bool, device,
               has_clean: bool, circular: bool):
    """run_streams_fused's step for spans of `cps` chunks, compiled
    (compiled.py: one CUDA graph per input signature on the card, the
    JAX package's jitted scan body); it donates its state, which the loop
    passes back.  Kept, as jit keeps its cache: each signature holds a copy
    of a state in its static buffers."""
    from .compiled import compile_step
    step = FusedAecm(sample_rate, cps, use_kernel, device, has_clean,
                     lane_major_io=True, circular_far=circular)
    return compile_step(step, carry=((0, 0), (1, 1)) if circular
                        else ((0, 0),), donate=True,
                        name=f"fused {sample_rate} Hz, {cps} chunks"
                        f"{', clean' if has_clean else ''}"
                        f"{'' if use_kernel else ', plain'}")


def run_streams_fused(state: FusedState, far, near, sample_rate: int,
                      ms_in_sndcard_buf=40, use_kernel: bool = True,
                      clean=None, chunks_per_step: Optional[int] = None):
    """Whole signals through the fused serving step (the JAX package's
    run_streams_fused).  far/near[/clean]: (n_streams, n_samples)
    int16-range; ms_in_sndcard_buf: a scalar, (n_streams,), (n_chunks,) or
    (n_chunks, n_streams).  chunks_per_step defaults to 4 at 8 kHz and 2
    at 16 kHz (5 blocks a step), capped at the number of chunks; a tail of
    chunks that it does not divide runs as one final smaller step.  A span
    whose step is whole blocks dividing the history keeps the far history
    circular.  Returns (state, out (n_streams, n_chunks*chunk) int32).  The
    input state is not modified (the loop runs on a copy), and what it
    returns is its own.

    Each span replays one compiled step per step (compiled.py: the step
    captured once per input signature as a CUDA graph on the card; eager
    under compiled.disable_graphs() and on the CPU), with the circular
    history's head carried as a 0-d int32 tensor, as the JAX package's
    scan carries it.  On CUDA tensors with use_kernel=True every step runs
    the ring kernel and the frames kernel once each."""
    with span("run"):
        chunk = min(160, sample_rate // 100)
        dev = state.ctrl.ec_startup.device
        with span("run.inputs"):
            far = torch.as_tensor(far, device=dev).to(I32)
            near = torch.as_tensor(near, device=dev).to(I32)
            has_clean = clean is not None
            if has_clean:
                clean = torch.as_tensor(clean, device=dev).to(I32)
            n_streams, n_samples = near.shape
            n_chunks = n_samples // chunk
            cps = chunks_per_step or (4 if sample_rate == 8000 else 2)
            cps = max(1, min(cps, n_chunks))
            n_super, rem = divmod(n_chunks, cps)
            spans = [(0, n_super * cps, cps)] + (
                [(n_super * cps, n_chunks, rem)] if rem else [])
            _check_envelope(sample_rate, use_kernel, state, has_clean)

            ms = torch.as_tensor(ms_in_sndcard_buf, dtype=I32, device=dev)
            if ms.ndim == 0 or (ms.ndim == 1 and ms.shape[0] == n_streams):
                ms_t = ms.expand(n_chunks, n_streams)
            elif ms.ndim == 1:
                ms_t = ms[:, None].expand(n_chunks, n_streams)
            else:
                ms_t = ms

            st = clone_state(state)
        outs = []
        for lo, hi, c in spans:
            if hi == lo:
                continue
            width = c * chunk
            circ = _exact_block(width)
            step = _span_step(sample_rate, c, use_kernel, dev, has_clean, circ)
            near_lm = near[:, lo * chunk:hi * chunk].T
            clean_lm = clean[:, lo * chunk:hi * chunk].T if has_clean else None
            if circ:
                st = st._replace(core=_to_circular_far(st.core))
            head = torch.zeros((), dtype=I32, device=dev)
            for s in range(lo, hi, c):
                cols = slice((s - lo) * chunk, (s - lo) * chunk + width)
                xs = (far[:, s * chunk:s * chunk + width], near_lm[cols]) + (
                    (clean_lm[cols],) if has_clean else ()) + (ms_t[s:s + c],)
                if circ:
                    st, head, out, _ = step(st, head, *xs)
                else:
                    st, out, _ = step(st, *xs)
                outs.append(out)
            if circ:
                st = st._replace(core=_from_circular_far(st.core, head))
        with span("run.outputs"):
            out = (torch.cat(outs, dim=0).T.contiguous() if outs
                   else near.new_zeros((n_streams, 0)))
            return clone_state(st), out
