"""AECM core: state and the batch-major per-block path (PyTorch port).

Port of webrtc_aecm_tpu/core.py (reference: aecm/aecm_core.{h,cc},
aecm/aecm_core_c.cc): the state tuple and its creation, and the block
stages, `process_block` and `process_frame` of the batch-major engine
(control.process, parallel/batch.py).  The JAX functions are per stream
and vmapped; here every leaf carries a leading stream axis, the bins last.
Inside the block path a per-stream scalar is a (B, 1) tensor (the "lifted"
state, see `lift`), so that it broadcasts against the (B, 65) spectra as
the JAX scalars do; `process_block` and `process_frame` take and return
the state as stored, scalars (B,).  The fused serving path has its own
lane-major copy of the stages in fused.py (and the frames kernel).

Dtypes follow the JAX package, with two changes forced by PyTorch: the
uint32 `seed` is carried in an int64 tensor ([0, 2^32), see ops/spl.py),
and `far_history` is int32 holding the uint16 magnitudes.  The TPU
workarounds of the JAX module (the one-hot masked history select, the int8
matrix-unit phase lookup) become index gathers with the same results.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _device
from . import defines as D
from . import delay_estimator as de
from . import tables
from ._tree import tree_map
from . import fft, spl

I32 = torch.int32
I64 = torch.int64


class Options(NamedTuple):
    """Static configuration, the reference's compile-time knobs.

    abs_approx: AECM_WITH_ABS_APPROX magnitudes (aecm_core_c.cc:316-341).
    robust_validation: the initial value of the per-stream runtime toggle
        (delay_estimator.enable_robust_validation); the core does not read
        it.
    debug: the block and frame steps also return the JAX package's debug
        taps (its equivalent of the reference's AEC_DEBUG dumps,
        echo_control_mobile.cc:105-136), a dict of per-stream tensors.
    """
    abs_approx: bool = False
    robust_validation: bool = False
    debug: bool = False


DEFAULT_OPTIONS = Options()


def set_control(state, delay, nlp_flag):
    """WebRtcAecm_Control (aecm_core.cc:477-482): fixed delay (-1 = use the
    delay estimator) and the NLP toggle, per stream."""
    dev = state.fixed_delay.device
    return state._replace(
        fixed_delay=_device.as_int32(delay, dev).expand_as(
            state.fixed_delay).clone(),
        nlp_flag=_device.as_int32(nlp_flag, dev).expand_as(
            state.nlp_flag).clone())


class CoreState(NamedTuple):
    """The reference's AecmCore fields (aecm_core.h:41-141); the same
    fields, in the same order, as webrtc_aecm_tpu.core.CoreState."""
    x_buf: torch.Tensor
    d_buf_noisy: torch.Tensor
    d_buf_clean: torch.Tensor
    out_buf: torch.Tensor
    known_delay: torch.Tensor
    frame_fill: torch.Tensor
    in_carry_far: torch.Tensor
    in_carry_noisy: torch.Tensor
    in_carry_clean: torch.Tensor
    out_fill: torch.Tensor
    out_carry: torch.Tensor
    out_tail: torch.Tensor
    seed: torch.Tensor
    de_farend: de.FarendState
    de_near: de.NearState
    far_history: torch.Tensor
    far_q_domains: torch.Tensor
    nlp_flag: torch.Tensor
    fixed_delay: torch.Tensor
    tot_count: torch.Tensor
    dfa_clean_q: torch.Tensor
    dfa_clean_q_old: torch.Tensor
    dfa_noisy_q: torch.Tensor
    dfa_noisy_q_old: torch.Tensor
    near_log_energy: torch.Tensor
    far_log_energy: torch.Tensor
    echo_adapt_log_energy: torch.Tensor
    echo_stored_log_energy: torch.Tensor
    channel_stored: torch.Tensor
    channel_adapt16: torch.Tensor
    channel_adapt32: torch.Tensor
    echo_filt: torch.Tensor
    near_filt: torch.Tensor
    noise_est: torch.Tensor
    noise_est_too_low_ctr: torch.Tensor
    noise_est_too_high_ctr: torch.Tensor
    noise_est_ctr: torch.Tensor
    cng_mode: torch.Tensor
    mse_adapt_old: torch.Tensor
    mse_stored_old: torch.Tensor
    mse_threshold: torch.Tensor
    far_energy_min: torch.Tensor
    far_energy_max: torch.Tensor
    far_energy_max_min: torch.Tensor
    far_energy_vad: torch.Tensor
    far_energy_mse: torch.Tensor
    current_vad_value: torch.Tensor
    vad_update_count: torch.Tensor
    first_vad: torch.Tensor
    startup_state: torch.Tensor
    mse_channel_count: torch.Tensor
    sup_gain: torch.Tensor
    sup_gain_old: torch.Tensor
    sup_gain_err_param_a: torch.Tensor
    sup_gain_err_param_d: torch.Tensor
    sup_gain_err_param_diff_ab: torch.Tensor
    sup_gain_err_param_diff_bd: torch.Tensor


def _initial_noise_est() -> np.ndarray:
    """Pink-noise-shaped initial noiseEst (aecm_core.cc:427-435)."""
    tmp32 = D.PART_LEN1 * D.PART_LEN1
    tmp16 = D.PART_LEN1
    vals = np.zeros(D.PART_LEN1, dtype=np.int64)
    i = 0
    while i < (D.PART_LEN1 >> 1) - 1:
        vals[i] = tmp32 << 8
        tmp16 -= 1
        tmp32 -= (tmp16 << 1) + 1
        i += 1
    while i < D.PART_LEN1:
        vals[i] = tmp32 << 8
        i += 1
    return vals.astype(np.int32)


def init_echo_path(state: CoreState, echo_path) -> CoreState:
    """WebRtcAecm_InitEchoPathCore (aecm_core.cc:249-265) for one stream or
    a batch; echo_path (65,) or (B, 65)."""
    echo_path = torch.as_tensor(
        echo_path, dtype=I32, device=state.x_buf.device).expand_as(
            state.channel_stored).clone()

    def s(v):
        return torch.full_like(state.mse_adapt_old, v)
    return state._replace(
        channel_stored=echo_path,
        channel_adapt16=echo_path.clone(),
        channel_adapt32=spl.shl_i32(echo_path, 16),
        mse_adapt_old=s(1000),
        mse_stored_old=s(1000),
        mse_threshold=s(D.WORD32_MAX),
        mse_channel_count=s(0),
    )


def create_core(sample_rate: int = 8000, device=None) -> CoreState:
    """WebRtcAecm_CreateCore + WebRtcAecm_InitCore (aecm_core.cc:179-473)
    for one stream."""
    if sample_rate not in (8000, 16000):
        raise ValueError("sample_rate must be 8000 or 16000")
    device = _device.resolve(device)
    prior = (tables.CHANNEL_STORED_8KHZ if sample_rate == 8000
             else tables.CHANNEL_STORED_16KHZ)

    def z(n):
        return torch.zeros((n,), dtype=I32, device=device)

    def s(v, dtype=I32):
        return torch.tensor(v, dtype=dtype, device=device)

    state = CoreState(
        x_buf=z(D.PART_LEN2),
        d_buf_noisy=z(D.PART_LEN2),
        d_buf_clean=z(D.PART_LEN2),
        out_buf=z(D.PART_LEN),
        known_delay=s(0),
        frame_fill=s(0),
        in_carry_far=z(D.PART_LEN),
        in_carry_noisy=z(D.PART_LEN),
        in_carry_clean=z(D.PART_LEN),
        out_fill=s(0),
        out_carry=z(D.PART_LEN),
        out_tail=z(16),
        seed=s(666, I64),
        de_farend=de.create_farend(device=device),
        de_near=de.create_near(device=device),
        far_history=torch.zeros((D.MAX_DELAY, D.PART_LEN1), dtype=I32,
                                device=device),
        far_q_domains=z(D.MAX_DELAY),
        nlp_flag=s(1),
        fixed_delay=s(-1),
        tot_count=s(0),
        dfa_clean_q=s(0),
        dfa_clean_q_old=s(0),
        dfa_noisy_q=s(0),
        dfa_noisy_q_old=s(0),
        near_log_energy=z(D.MAX_BUF_LEN),
        far_log_energy=s(0),
        echo_adapt_log_energy=z(D.MAX_BUF_LEN),
        echo_stored_log_energy=z(D.MAX_BUF_LEN),
        channel_stored=z(D.PART_LEN1),
        channel_adapt16=z(D.PART_LEN1),
        channel_adapt32=z(D.PART_LEN1),
        echo_filt=z(D.PART_LEN1),
        near_filt=z(D.PART_LEN1),
        noise_est=torch.as_tensor(_initial_noise_est(), device=device),
        noise_est_too_low_ctr=z(D.PART_LEN1),
        noise_est_too_high_ctr=z(D.PART_LEN1),
        noise_est_ctr=s(0),
        cng_mode=s(1),
        mse_adapt_old=s(0),
        mse_stored_old=s(0),
        mse_threshold=s(0),
        far_energy_min=s(D.WORD16_MAX),
        far_energy_max=s(D.WORD16_MIN),
        far_energy_max_min=s(0),
        far_energy_vad=s(D.FAR_ENERGY_MIN),
        far_energy_mse=s(0),
        current_vad_value=s(0),
        vad_update_count=s(0),
        first_vad=s(1),
        startup_state=s(0),
        mse_channel_count=s(0),
        sup_gain=s(D.SUPGAIN_DEFAULT),
        sup_gain_old=s(D.SUPGAIN_DEFAULT),
        sup_gain_err_param_a=s(D.SUPGAIN_ERROR_PARAM_A),
        sup_gain_err_param_d=s(D.SUPGAIN_ERROR_PARAM_D),
        sup_gain_err_param_diff_ab=s(D.SUPGAIN_ERROR_PARAM_A
                                     - D.SUPGAIN_ERROR_PARAM_B),
        sup_gain_err_param_diff_bd=s(D.SUPGAIN_ERROR_PARAM_B
                                     - D.SUPGAIN_ERROR_PARAM_D),
    )
    return init_echo_path(state, prior)


def log_of_energy_in_q8(energy, q_domain):
    """LogOfEnergyInQ8 (aecm_core.cc:618-628); energy is a uint32 carrier
    (or a non-negative int32)."""
    k_log_low = D.PART_LEN_SHIFT << 7
    energy = spl.u32(energy)
    zeros = spl.norm_u32(energy)
    frac = spl.to_w16((spl.shl_u32(energy, zeros) & 0x7FFFFFFF) >> 23)
    log_q8 = k_log_low + ((31 - zeros) << 8) + frac - (q_domain << 8)
    return torch.where(energy > 0, log_q8, k_log_low).to(I32)


def asym_filt(filt_old, in_val, step_pos, step_neg):
    """WebRtcAecm_AsymFilt (aecm_core.cc:588-605)."""
    passthrough = (filt_old == D.WORD16_MAX) | (filt_old == D.WORD16_MIN)
    dec = filt_old - ((filt_old - in_val) >> step_neg)
    inc = filt_old + ((in_val - filt_old) >> step_pos)
    return torch.where(passthrough, in_val,
                       torch.where(filt_old > in_val, dec, inc)).to(I32)


def _phase_table_lookup(idx, cos360, sin360):
    """The comfort-noise cos/sin lookup (aecm_core_c.cc) as a plain table
    index: idx int32 in [0, 360), tables (360,) int32 on idx's device."""
    i = idx.long()
    return cos360[i], sin360[i]


# ---------------------------------------------------------------------------
# Batch-major block path.  States here are lifted: per-stream scalars are
# (B, 1); spectra and buffers (B, n).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _scalar_fields():
    one = create_core(8000, device="cpu")
    return tuple(f for f in CoreState._fields
                 if torch.is_tensor(getattr(one, f))
                 and getattr(one, f).ndim == 0)


def lift(state: CoreState) -> CoreState:
    """Per-stream scalar leaves (B,) -> (B, 1), views; the estimator
    states too."""
    return state._replace(de_farend=de.lift(state.de_farend),
                          de_near=de.lift(state.de_near),
                          **{f: getattr(state, f)[..., None]
                             for f in _scalar_fields()})


def lower(state: CoreState) -> CoreState:
    """Inverse of `lift`."""
    return state._replace(de_farend=de.lower(state.de_farend),
                          de_near=de.lower(state.de_near),
                          **{f: getattr(state, f)[..., 0]
                             for f in _scalar_fields()})


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """Constant tables of the block path on one device."""
    h = np.asarray(tables.SQRT_HANNING, np.int32)
    a, c = tables.lcg_tables(D.PART_LEN)
    as_t = functools.partial(torch.as_tensor, device=device)
    win128 = np.concatenate([h[:D.PART_LEN], h[D.PART_LEN:0:-1]])
    return dict(win128=as_t(win128),   # the 128-sample analysis window
                win_lo=as_t(win128[:D.PART_LEN]),   # its rising half
                win_hi=as_t(win128[D.PART_LEN:]),   # its falling half
                bins=as_t(np.arange(D.PART_LEN1, dtype=np.int32)),
                cos360=as_t(np.asarray(tables.COS_TABLE_360, np.int32)),
                sin360=as_t(np.asarray(tables.SIN_TABLE_360, np.int32)),
                lcg_a=as_t(a.astype(np.int64)), lcg_c=as_t(c.astype(np.int64)))


def _shift_in(hist, v):
    """History shift register along the last axis, newest first."""
    return torch.cat([v, hist[..., :-1]], dim=-1)


def _sum_i32(x):
    """int32 sum over the last axis with int32 wraparound, keepdim."""
    return spl.wrap32(x.to(I64).sum(-1, keepdim=True))


def _sum_u32(x):
    """uint32 sum mod 2^32 over the last axis (int32 bit patterns or
    carriers in), keepdim."""
    return spl.u32(x).sum(-1, keepdim=True) & spl.MASK32


def where_tree(mask, new, old):
    """Per-stream select over a state tree: mask (B,) or (B, 1) bool is
    shaped to each leaf.  A leaf passed through untouched (the same object
    in new and old) is not copied."""
    m = mask.reshape(-1)

    def sel(a, b):
        if a is b:
            return b
        return torch.where(m.view((-1,) + (1,) * (a.ndim - 1)), a, b)
    return tree_map(sel, new, old)


def update_far_history(state: CoreState, far_spectrum, far_q):
    """UpdateFarHistory (aecm_core.cc:125-141): a shift register, newest at
    row 0; the magnitudes are stored as the uint16 they are in the
    reference."""
    return state._replace(
        far_q_domains=_shift_in(state.far_q_domains, far_q),
        far_history=torch.cat([(far_spectrum & 0xFFFF)[..., None, :],
                               state.far_history[..., :-1, :]], dim=-2))


def aligned_farend(state: CoreState, delay):
    """AlignedFarend (aecm_core.cc:143-172): row `delay` of the newest-first
    history, an index gather; zeros where delay is outside the history."""
    valid = (delay >= 0) & (delay < D.MAX_DELAY)
    idx = delay.clamp(0, D.MAX_DELAY - 1).long()
    xfa = torch.gather(state.far_history, -2, idx[..., None].expand(
        idx.shape[:-1] + (1, D.PART_LEN1)))[..., 0, :]
    far_q = torch.gather(state.far_q_domains, -1, idx)
    return torch.where(valid, xfa, 0), torch.where(valid, far_q, 0)


def calc_energies(state: CoreState, far_spectrum, far_q, near_ener):
    """WebRtcAecm_CalcEnergies (aecm_core.cc:644-755); returns (state,
    echo_est)."""
    near_log_energy = _shift_in(state.near_log_energy,
                                log_of_energy_in_q8(near_ener,
                                                    state.dfa_noisy_q))
    echo_est = state.channel_stored * far_spectrum
    far_log_energy = log_of_energy_in_q8(_sum_u32(far_spectrum), far_q)
    echo_adapt_log_energy = _shift_in(
        state.echo_adapt_log_energy,
        log_of_energy_in_q8(_sum_u32(state.channel_adapt16 * far_spectrum),
                            D.RESOLUTION_CHANNEL16 + far_q))
    echo_stored_log_energy = _shift_in(
        state.echo_stored_log_energy,
        log_of_energy_in_q8(_sum_u32(echo_est),
                            D.RESOLUTION_CHANNEL16 + far_q))

    in_startup = state.startup_state == 0
    increase_max_shifts = torch.where(in_startup, 2, 4).to(I32)
    increase_min_shifts = torch.where(in_startup, 8, 11).to(I32)
    decrease_min_shifts = torch.where(in_startup, 2, 3).to(I32)

    active = far_log_energy > D.FAR_ENERGY_MIN
    new_min = asym_filt(state.far_energy_min, far_log_energy,
                        increase_min_shifts, decrease_min_shifts)
    new_max = asym_filt(state.far_energy_max, far_log_energy,
                        increase_max_shifts, 11)
    far_energy_min = torch.where(active, new_min, state.far_energy_min)
    far_energy_max = torch.where(active, new_max, state.far_energy_max)
    far_energy_max_min = torch.where(active, far_energy_max - far_energy_min,
                                     state.far_energy_max_min)

    tmp16 = spl.to_w16(2560 - far_energy_min)
    tmp16 = torch.where(tmp16 > 0,
                        spl.to_w16((tmp16 * D.FAR_ENERGY_VAD_REGION) >> 9),
                        0)
    tmp16 = spl.to_w16(tmp16 + D.FAR_ENERGY_VAD_REGION)

    vad_halted = in_startup | (state.vad_update_count > 1024)
    tracked_vad = state.far_energy_vad + (
        (far_log_energy + tmp16 - state.far_energy_vad) >> 6)
    track = state.far_energy_vad > far_log_energy
    far_energy_vad = torch.where(
        active,
        torch.where(vad_halted, far_energy_min + tmp16,
                    torch.where(track, tracked_vad, state.far_energy_vad)),
        state.far_energy_vad)
    vad_update_count = torch.where(
        active & ~vad_halted,
        torch.where(track, 0, spl.to_w16(state.vad_update_count + 1)),
        state.vad_update_count).to(I32)
    far_energy_mse = torch.where(active, far_energy_vad + (1 << 8),
                                 state.far_energy_mse)

    # VAD decision (no change when above threshold but dynamics low)
    above = far_log_energy > far_energy_vad
    dynamic = in_startup | (far_energy_max_min > D.FAR_ENERGY_DIFF)
    current_vad_value = torch.where(
        above, torch.where(dynamic, 1, state.current_vad_value), 0).to(I32)

    # first-VAD channel sanity scale-down (aecm_core.cc:741-754)
    first_fire = (current_vad_value != 0) & (state.first_vad != 0)
    too_hot = echo_adapt_log_energy[..., :1] > near_log_energy[..., :1]
    scale_down = first_fire & too_hot
    channel_adapt16 = torch.where(scale_down, state.channel_adapt16 >> 3,
                                  state.channel_adapt16)
    echo_adapt_log_energy = torch.cat([
        torch.where(scale_down, echo_adapt_log_energy[..., :1] - (3 << 8),
                    echo_adapt_log_energy[..., :1]),
        echo_adapt_log_energy[..., 1:]], dim=-1)
    first_vad = torch.where(first_fire & ~too_hot, 0,
                            state.first_vad).to(I32)

    state = state._replace(
        near_log_energy=near_log_energy,
        far_log_energy=far_log_energy,
        echo_adapt_log_energy=echo_adapt_log_energy,
        echo_stored_log_energy=echo_stored_log_energy,
        far_energy_min=far_energy_min,
        far_energy_max=far_energy_max,
        far_energy_max_min=far_energy_max_min,
        far_energy_vad=far_energy_vad,
        far_energy_mse=far_energy_mse,
        vad_update_count=vad_update_count,
        current_vad_value=current_vad_value,
        channel_adapt16=channel_adapt16,
        first_vad=first_vad,
    )
    return state, echo_est


def calc_step_size(state: CoreState):
    """WebRtcAecm_CalcStepSize (aecm_core.cc:767-794)."""
    tmp32 = (state.far_log_energy - state.far_energy_min) * D.MU_DIFF
    ratio = spl.to_w16(spl.div_w32_w16(tmp32, state.far_energy_max_min))
    mu_dyn = (D.MU_MIN - 1 - ratio).clamp(min=D.MU_MAX)
    mu = torch.where(state.far_energy_min >= state.far_energy_max,
                     D.MU_MIN, mu_dyn)
    mu = torch.where(state.startup_state > 0, mu, D.MU_MAX)
    return torch.where(state.current_vad_value == 0, 0, mu).to(I32)


def update_channel(state: CoreState, far_spectrum, far_q, dfa, mu,
                   echo_est):
    """WebRtcAecm_UpdateChannel (aecm_core.cc:810-986): the NLMS update and
    the store/restore arbitration.  Returns (state, echo_est)."""
    ch32 = state.channel_adapt32
    zeros_ch = spl.norm_u32(ch32)
    zeros_far = spl.norm_u32(far_spectrum)
    safe_mul = zeros_ch + zeros_far > 31
    shift_ch_far = torch.where(safe_mul, 0, 32 - zeros_ch - zeros_far
                               ).to(I32)
    prod_safe = (spl.u32(ch32) * spl.u32(far_spectrum)) & spl.MASK32
    shifted_ch = torch.where(shift_ch_far >= 32, 0,
                             spl.sar_i32(ch32, shift_ch_far))
    prod_shifted = (spl.u32(shifted_ch) * spl.u32(far_spectrum)
                    ) & spl.MASK32
    tmp_u32_no1 = torch.where(safe_mul, prod_safe, prod_shifted)

    zeros_num = spl.norm_u32(tmp_u32_no1)
    zeros_dfa = torch.where(dfa != 0, spl.norm_u32(dfa), 32).to(I32)
    tmp16_no1 = (zeros_dfa - 2 + state.dfa_noisy_q - D.RESOLUTION_CHANNEL32
                 - far_q + shift_ch_far)
    use_dfa_domain = zeros_num > tmp16_no1 + 1
    xfa_q = torch.where(use_dfa_domain, tmp16_no1, zeros_num - 2)
    dfa_q = torch.where(use_dfa_domain, zeros_dfa - 2,
                        D.RESOLUTION_CHANNEL32 + far_q - state.dfa_noisy_q
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

    tmp32_no2 = spl.div_w32_w16(tmp32_no2, _consts(far_q.device)["bins"] + 1)
    shift2_res_chan = (shift_num + shift_ch_far - xfa_q - mu
                       - ((30 - zeros_far) << 1))
    overflow = spl.norm_w32(tmp32_no2) < shift2_res_chan
    tmp32_no2 = torch.where(overflow, D.WORD32_MAX,
                            spl.shift_w32(tmp32_no2, shift2_res_chan))

    new_ch32 = spl.add_sat_w32(ch32, tmp32_no2).clamp(min=0)
    apply = (mu != 0) & do_update
    channel_adapt32 = torch.where(apply, new_ch32, ch32)
    channel_adapt16 = torch.where(apply, channel_adapt32 >> 16,
                                  state.channel_adapt16)
    state = state._replace(channel_adapt32=channel_adapt32,
                           channel_adapt16=channel_adapt16)

    # --- store/restore arbitration (aecm_core.cc:926-985) ---
    startup_store = ((state.startup_state == 0)
                     & (state.current_vad_value != 0))
    mse_channel_count = torch.where(
        state.far_log_energy < state.far_energy_mse, 0,
        state.mse_channel_count + 1)
    evaluate = mse_channel_count >= (D.MIN_MSE_COUNT + 10)

    n = D.MIN_MSE_COUNT
    mse_stored = _sum_i32((state.echo_stored_log_energy[..., :n]
                           - state.near_log_energy[..., :n]).abs())
    mse_adapt = _sum_i32((state.echo_adapt_log_energy[..., :n]
                          - state.near_log_energy[..., :n]).abs())

    do_reset = evaluate & (
        (spl.shl_i32(mse_stored, D.MSE_RESOLUTION)
         < D.MIN_MSE_DIFF * mse_adapt)
        & (spl.shl_i32(state.mse_stored_old, D.MSE_RESOLUTION)
           < D.MIN_MSE_DIFF * state.mse_adapt_old))
    do_store = evaluate & ~do_reset & (
        (D.MIN_MSE_DIFF * mse_stored > spl.shl_i32(mse_adapt,
                                                   D.MSE_RESOLUTION))
        & (mse_adapt < state.mse_threshold)
        & (state.mse_adapt_old < state.mse_threshold))

    # threshold update when storing (aecm_core.cc:968-974)
    fresh = state.mse_threshold == D.WORD32_MAX
    scaled_threshold = spl.div_trunc(state.mse_threshold * 5, 8)
    bumped = state.mse_threshold + (
        ((mse_adapt - scaled_threshold) * 205) >> 8)
    new_threshold = torch.where(fresh, mse_adapt + state.mse_adapt_old,
                                bumped)
    mse_threshold = torch.where(do_store & ~startup_store, new_threshold,
                                state.mse_threshold)

    store_now = startup_store | (~startup_store & do_store)
    reset_now = ~startup_store & do_reset
    channel_stored = torch.where(store_now, state.channel_adapt16,
                                 state.channel_stored)
    echo_est = torch.where(store_now, state.channel_adapt16 * far_spectrum,
                           echo_est)
    channel_adapt16 = torch.where(reset_now, state.channel_stored,
                                  state.channel_adapt16)
    channel_adapt32 = torch.where(reset_now,
                                  spl.shl_i32(state.channel_stored, 16),
                                  state.channel_adapt32)

    state = state._replace(
        channel_stored=channel_stored,
        channel_adapt16=channel_adapt16,
        channel_adapt32=channel_adapt32,
        mse_threshold=mse_threshold,
        mse_channel_count=torch.where(
            startup_store, state.mse_channel_count,
            torch.where(evaluate, 0, mse_channel_count)).to(I32),
        mse_stored_old=torch.where(~startup_store & evaluate, mse_stored,
                                   state.mse_stored_old),
        mse_adapt_old=torch.where(~startup_store & evaluate, mse_adapt,
                                  state.mse_adapt_old),
    )
    return state, echo_est


def calc_suppression_gain(state: CoreState):
    """WebRtcAecm_CalcSuppressionGain (aecm_core.cc:1000-1052); returns
    (state, gain)."""
    tmp16 = (state.near_log_energy[..., :1]
             - state.echo_stored_log_energy[..., :1] - D.ENERGY_DEV_OFFSET)
    # WEBRTC_SPL_ABS_W16(-32768) stays -32768 when stored back into int16.
    d_e = spl.to_w16(spl.to_w16(tmp16).abs())

    low = d_e < D.SUPGAIN_EPC_DT
    num_low = state.sup_gain_err_param_diff_ab * d_e + (D.SUPGAIN_EPC_DT >> 1)
    gain_low = state.sup_gain_err_param_a - spl.to_w16(
        spl.div_w32_w16(num_low, D.SUPGAIN_EPC_DT))
    num_high = (state.sup_gain_err_param_diff_bd * (D.ENERGY_DEV_TOL - d_e)
                + ((D.ENERGY_DEV_TOL - D.SUPGAIN_EPC_DT) >> 1))
    gain_high = state.sup_gain_err_param_d + spl.to_w16(
        spl.div_w32_w16(num_high, D.ENERGY_DEV_TOL - D.SUPGAIN_EPC_DT))
    sup_gain = torch.where(d_e < D.ENERGY_DEV_TOL,
                           torch.where(low, gain_low, gain_high),
                           state.sup_gain_err_param_d)
    sup_gain = torch.where(state.current_vad_value == 0, 0, sup_gain)

    target = torch.maximum(sup_gain, state.sup_gain_old)
    new_sup = spl.to_w16(state.sup_gain
                         + spl.to_w16((target - state.sup_gain) >> 4))
    return state._replace(sup_gain=new_sup,
                          sup_gain_old=sup_gain.to(I32)), new_sup


def time_to_frequency_domain(time_signal, abs_approx: bool = False):
    """TimeToFrequencyDomain (aecm_core_c.cc:166-365): dynamic-Q scaling,
    sqrt-Hanning window, forward FFT, magnitudes.  time_signal (B, 128).
    Returns (q_scaling (B, 1), (re, im), magnitudes (B, 65), magnitude sum
    (B, 1) uint32 carrier)."""
    c = _consts(time_signal.device)
    scaling = spl.norm_w16(spl.max_abs_value_w16(time_signal)[..., None])
    scaled = spl.to_w16(spl.shl_i32(time_signal, scaling))
    windowed = spl.to_w16((scaled * c["win128"]) >> 14)
    re, im = fft.real_forward_fft(windowed)
    # conjugate bins 1..63 (the int16 store wraps); bins 0 and 64 are zero
    z = torch.zeros_like(im[..., :1])
    im = torch.cat([z, spl.to_w16(-im[..., 1:D.PART_LEN]), z], dim=-1)

    abs_re, mag = bin_magnitudes(re, im, abs_approx)
    mag = torch.cat([abs_re[..., :1], mag[..., 1:D.PART_LEN],
                     abs_re[..., D.PART_LEN:]], dim=-1)
    return scaling, (re, im), mag, _sum_u32(mag)


def bin_magnitudes(re, im, abs_approx: bool):
    """The interior bins' magnitudes of TimeToFrequencyDomain
    (aecm_core_c.cc:316-365), elementwise in any layout: |im| where re is
    0, |re| where im is 0, else the rounded-down root of the saturated
    power, or with abs_approx the alpha-max-plus-beta-min estimate
    (AECM_WITH_ABS_APPROX).  Returns (|re|, magnitudes int32); the caller
    takes |re| for bins 0 and 64."""
    abs_re, abs_im = re.abs(), im.abs()
    if abs_approx:
        max_v = torch.maximum(abs_re, abs_im)
        min_v = torch.minimum(abs_re, abs_im)
        c4, c2 = (max_v >> 2) > min_v, (max_v >> 1) > min_v
        alpha = torch.where(c4, 32584, torch.where(c2, 30879, 26951))
        beta = torch.where(c4, 4249, torch.where(c2, 11072, 18927))
        interior = ((spl.to_w16((max_v * alpha) >> 15) & 0xFFFF)
                    + (spl.to_w16((min_v * beta) >> 15) & 0xFFFF)
                    ) & 0xFFFF   # the uint16_t sum wraps
    else:
        interior = spl.sqrt_floor(
            spl.add_sat_w32(abs_re * abs_re, abs_im * abs_im))
    return abs_re, torch.where(re == 0, abs_im,
                               torch.where(im == 0, abs_re, interior)).to(I32)


def inverse_fft_and_window(state: CoreState, efw_re, efw_im,
                           has_clean: bool):
    """InverseFFTAndWindow (aecm_core_c.cc:193-246); returns (state, 64
    output samples)."""
    c = _consts(efw_re.device)
    P = D.PART_LEN
    ifft_out, out_cfft = fft.real_inverse_fft(efw_re, spl.to_w16(-efw_im))
    shift = out_cfft[..., None] - state.dfa_clean_q
    first = spl.to_w16((ifft_out[..., :P] * c["win_lo"] + 8192) >> 14)
    output = spl.sat_w16(spl.shift_w32(first, shift) + state.out_buf)
    second = (ifft_out[..., P:] * c["win_hi"]) >> 14
    out_buf = spl.sat_w16(spl.shift_w32(second, shift))

    def slide(buf):
        return torch.cat([buf[..., P:], buf[..., P:]], dim=-1)
    state = state._replace(x_buf=slide(state.x_buf),
                           d_buf_noisy=slide(state.d_buf_noisy),
                           out_buf=out_buf)
    if has_clean:
        state = state._replace(d_buf_clean=slide(state.d_buf_clean))
    return state, output


def comfort_noise(state: CoreState, dfa, efw_re, efw_im, lam):
    """ComfortNoise (aecm_core_c.cc:52-164): minimum-statistics noise floor
    and random-phase synthesis; the LCG advances 64 draws per block."""
    c = _consts(dfa.device)
    shift_noise = D.NOISE_EST_Q_DOMAIN - state.dfa_clean_q
    fast = state.noise_est_ctr < 100
    noise_est_ctr = torch.where(fast, state.noise_est_ctr + 1,
                                state.noise_est_ctr).to(I32)
    min_track_shift = torch.where(fast, 6, 9).to(I32)

    noise = state.noise_est
    too_low = state.noise_est_too_low_ctr
    too_high = state.noise_est_too_high_ctr
    out_lshift = spl.shl_i32(dfa, shift_noise)

    below = out_lshift < noise
    # below: track the minimum
    small = noise < spl.shl_i32(torch.ones_like(min_track_shift),
                                min_track_shift)
    th_inc = too_high + 1
    dec_small = th_inc >= D.NOISE_EST_INC_COUNT
    noise_below = torch.where(
        small, torch.where(dec_small, noise - 1, noise),
        noise - spl.sar_i32(noise - out_lshift, min_track_shift))
    too_high_below = torch.where(small, torch.where(dec_small, 0, th_inc),
                                 too_high)
    # above: ramp slowly upwards
    big1 = (noise >> 19) > 0
    big2 = (noise >> 11) > 0
    tl_inc = too_low + 1
    inc_small = tl_inc >= D.NOISE_EST_INC_COUNT
    noise_above = torch.where(
        big1, (noise >> 11) * 2049,
        torch.where(big2, (noise * 2049) >> 11,
                    torch.where(inc_small, noise + (noise >> 9) + 1, noise)))
    too_low_above = torch.where(big1 | big2, too_low,
                                torch.where(inc_small, 0, tl_inc))

    noise = torch.where(below, noise_below, noise_above)
    too_low = torch.where(below, 0, too_low_above).to(I32)
    too_high = torch.where(below, too_high_below, 0).to(I32)

    # synthesis amplitudes
    tmp32 = spl.sar_i32(noise, shift_noise)
    clip = tmp32 > 32767
    tmp32 = torch.where(clip, 32767, tmp32).to(I32)
    noise = torch.where(clip, spl.shl_i32(tmp32, shift_noise), noise)
    noise_rshift16 = spl.to_w16(
        ((D.ONE_Q14 - lam) * spl.to_w16(tmp32)) >> 14)

    # WebRtcSpl_RandUArray: 64 draws through the LCG's affine closure
    seeds = (c["lcg_a"] * state.seed + c["lcg_c"]) & tables.LCG_MASK
    phase_idx = (359 * (seeds >> 16).to(I32)) >> 15
    cos_v, sin_v = _phase_table_lookup(phase_idx, c["cos360"], c["sin360"])
    amp = noise_rshift16[..., 1:]
    z = torch.zeros_like(amp[..., :1])
    u_real = torch.cat([z, spl.to_w16((amp * cos_v) >> 13)], dim=-1)
    u_imag = torch.cat([z, spl.to_w16((-amp[..., :-1] * sin_v[..., :-1])
                                      >> 13), z], dim=-1)
    efw_re = spl.add_sat_w16(efw_re, u_real)
    efw_im = spl.add_sat_w16(efw_im, u_imag)

    state = state._replace(noise_est=noise, noise_est_too_low_ctr=too_low,
                           noise_est_too_high_ctr=too_high,
                           noise_est_ctr=noise_est_ctr,
                           seed=seeds[..., -1:])
    return state, efw_re, efw_im


def _process_block(state: CoreState, farend, nearend_noisy, nearend_clean,
                   mult: int, opts: Options):
    """WebRtcAecm_ProcessBlock on a lifted state: one 64-sample block
    (B, 64) through the whole chain.  Returns (state, output (B, 64))."""
    has_clean = nearend_clean is not None
    P = D.PART_LEN
    startup_state = torch.where(
        state.startup_state < 2,
        (state.tot_count >= D.CONV_LEN).to(I32)
        + (state.tot_count >= D.CONV_LEN2).to(I32),
        state.startup_state)
    state = state._replace(
        startup_state=startup_state,
        x_buf=torch.cat([state.x_buf[..., :P], farend], dim=-1),
        d_buf_noisy=torch.cat([state.d_buf_noisy[..., :P], nearend_noisy],
                              dim=-1))
    if has_clean:
        state = state._replace(d_buf_clean=torch.cat(
            [state.d_buf_clean[..., :P], nearend_clean], dim=-1))

    # the far, noisy (and clean) analyses as one batch of transforms
    q, (re, im), mag, mag_sum = time_to_frequency_domain(
        torch.stack([state.x_buf, state.d_buf_noisy]
                    + ([state.d_buf_clean] if has_clean else [])),
        opts.abs_approx)
    far_q, xfa = q[0], mag[0]
    zeros_d_noisy, dfa_noisy, dfa_noisy_sum = q[1], mag[1], mag_sum[1]
    dfw = (re[1], im[1])
    state = state._replace(dfa_noisy_q_old=state.dfa_noisy_q,
                           dfa_noisy_q=zeros_d_noisy)
    if has_clean:
        dfw, ptr_dfa_clean = (re[2], im[2]), mag[2]
        state = state._replace(dfa_clean_q_old=state.dfa_clean_q,
                               dfa_clean_q=q[2])
    else:
        state = state._replace(dfa_clean_q_old=state.dfa_noisy_q_old,
                               dfa_clean_q=state.dfa_noisy_q)
        ptr_dfa_clean = dfa_noisy

    # delay estimation over binary spectra
    state = update_far_history(state, xfa, far_q)
    state = state._replace(
        de_farend=de._add_far_spectrum_fix(state.de_farend, xfa, far_q))
    de_near, delay = de._process_fix(state.de_near, state.de_farend,
                                     dfa_noisy, zeros_d_noisy)
    state = state._replace(de_near=de_near)
    delay = torch.where(delay == -2, 0, delay)
    delay = torch.where(state.fixed_delay >= 0, state.fixed_delay, delay)
    far_spectrum, zeros_x_buf = aligned_farend(state, delay)

    state, echo_est = calc_energies(state, far_spectrum, zeros_x_buf,
                                    dfa_noisy_sum)
    mu = calc_step_size(state)
    state = state._replace(tot_count=state.tot_count + 1)
    state, echo_est = update_channel(state, far_spectrum, zeros_x_buf,
                                     dfa_noisy, mu, echo_est)
    state, sup_gain = calc_suppression_gain(state)

    # --- Wiener filter hnl (aecm_core_c.cc:517-615) ---
    echo_filt = state.echo_filt + spl.mul_i64_shift_right(
        echo_est - state.echo_filt, 50, 8)
    zeros32 = spl.norm_w32(echo_filt) + 1
    zeros16 = spl.norm_w16(sup_gain) + 1
    safe = zeros32 + zeros16 > 16
    gained_safe = (spl.u32(echo_filt) * spl.u32(sup_gain)) & spl.MASK32
    tmp16_no1 = 17 - zeros32 - zeros16
    res_diff_safe = (14 - D.RESOLUTION_CHANNEL16 - D.RESOLUTION_SUPGAIN
                     + state.dfa_clean_q - zeros_x_buf)
    res_diff_unsafe = (14 + tmp16_no1 - D.RESOLUTION_CHANNEL16
                       - D.RESOLUTION_SUPGAIN + state.dfa_clean_q
                       - zeros_x_buf)
    gained_a = (spl.u32(echo_filt)
                * spl.u32(spl.sar_i32(sup_gain, tmp16_no1))) & spl.MASK32
    gained_b = spl.u32(spl.sar_i32(echo_filt, tmp16_no1) * sup_gain)
    gained_unsafe = torch.where(zeros32 > tmp16_no1, gained_a, gained_b)
    echo_est_gained = torch.where(safe, gained_safe, gained_unsafe)
    resolution_diff = torch.where(safe, res_diff_safe, res_diff_unsafe)

    # nearFilt IIR with Q-domain re-alignment (aecm_core_c.cc:552-579)
    zeros16n = spl.norm_w16(state.near_filt)
    dq_diff = state.dfa_clean_q - state.dfa_clean_q_old
    cramped = (zeros16n < dq_diff) & (state.near_filt != 0)
    qdd_a = zeros16n - dq_diff
    tmp16no1 = torch.where(
        cramped, spl.to_w16(spl.shl_i32(state.near_filt, zeros16n)),
        spl.to_w16(torch.where(dq_diff < 0,
                               spl.sar_i32(state.near_filt, -dq_diff),
                               spl.shl_i32(state.near_filt, dq_diff))))
    q_domain_diff = torch.where(cramped, qdd_a, 0)
    tmp16no2 = torch.where(cramped, spl.sar_i32(ptr_dfa_clean, -qdd_a),
                           spl.to_w16(ptr_dfa_clean))
    tmp16no2 = spl.to_w16(spl.to_w16((tmp16no2 - tmp16no1) >> 4) + tmp16no1)
    # C quirk: `if (tmp16no2 & (-qDomainDiff > zeros16))` tests the LSB.
    sat_near = (((tmp16no2 & 1) != 0)
                & (-q_domain_diff > spl.norm_w16(tmp16no2)))
    near_filt = torch.where(
        sat_near, D.WORD16_MAX,
        torch.where(q_domain_diff < 0,
                    spl.to_w16(spl.shl_i32(tmp16no2, -q_domain_diff)),
                    spl.sar_i32(tmp16no2, q_domain_diff))).to(I32)

    # hnl = 1 - supGain*echoEst/nearFilt in Q14 (aecm_core_c.cc:581-611)
    rounded = (echo_est_gained + spl.u32(spl.sar_i32(near_filt, 1))
               ) & spl.MASK32
    ratio = spl.div_u32_u16(rounded, spl.u32(near_filt & 0xFFFF))
    tmp32no1 = spl.wrap32(spl.shift_w32(ratio, resolution_diff))
    hnl = torch.where(tmp32no1 > D.ONE_Q14, 0,
                      torch.where(tmp32no1 < 0, D.ONE_Q14,
                                  (D.ONE_Q14 - tmp32no1).clamp(min=0)))
    hnl = torch.where(echo_est_gained == 0, D.ONE_Q14,
                      torch.where(near_filt == 0, 0, hnl)).to(I32)
    num_pos_coef = _sum_i32((hnl != 0).to(I32))
    state = state._replace(echo_filt=echo_filt, near_filt=near_filt)

    # wideband upper-band clamp (aecm_core_c.cc:618-648)
    if mult == 2:
        hnl = spl.to_w16((hnl * hnl) >> 14)
        k_min, k_max = 4, 24
        avg = spl.div_trunc(_sum_i32(hnl[..., k_min:k_max + 1]),
                            k_max - k_min + 1)
        upper = _consts(hnl.device)["bins"] >= k_max
        hnl = torch.where(upper & (hnl > avg), avg, hnl)

    # NLP + apply the Wiener coefficients (aecm_core_c.cc:651-700)
    nlp_hnl = torch.where(hnl < D.NLP_COMP_LOW, 0,
                          torch.where(hnl > D.NLP_COMP_HIGH, D.ONE_Q14, hnl))
    nlp_gain = torch.where(num_pos_coef < 3, 0, D.ONE_Q14).to(I32)
    nlp_hnl = torch.where((nlp_hnl == D.ONE_Q14) & (nlp_gain == D.ONE_Q14),
                          D.ONE_Q14, spl.to_w16((nlp_hnl * nlp_gain) >> 14))
    hnl = torch.where(state.nlp_flag != 0, nlp_hnl, hnl)

    dfw_re, dfw_im = dfw
    efw_re = spl.to_w16((dfw_re * hnl + 8192) >> 14)
    efw_im = spl.to_w16((dfw_im * hnl + 8192) >> 14)

    # comfort noise, gated on the runtime cngMode; it touches only the
    # noise-estimator fields and the RNG seed
    cng_state, cng_re, cng_im = comfort_noise(state, ptr_dfa_clean,
                                              efw_re, efw_im, hnl)
    use_cng = state.cng_mode != 0
    state = state._replace(**{
        f: torch.where(use_cng, getattr(cng_state, f), getattr(state, f))
        for f in ("noise_est", "noise_est_too_low_ctr",
                  "noise_est_too_high_ctr", "noise_est_ctr", "seed")})
    efw_re = torch.where(use_cng, cng_re, efw_re)
    efw_im = torch.where(use_cng, cng_im, efw_im)
    state, out = inverse_fft_and_window(state, efw_re, efw_im, has_clean)
    if not opts.debug:
        return state, out
    # the JAX package's taps, with its names and Q formats: (B, 65) for
    # hnl, (B,) for the rest
    taps = {
        "hnl_q14": hnl,
        "sup_gain_q8": sup_gain[..., 0],
        "mu": mu[..., 0],
        "delay_blocks": delay[..., 0],
        "vad_far": state.current_vad_value[..., 0],
        "near_log_energy_q8": state.near_log_energy[..., 0],
        "echo_stored_log_energy_q8": state.echo_stored_log_energy[..., 0],
        "delay_quality": de._last_delay_quality(state.de_near)[..., 0],
    }
    return state, out, taps


def process_block(state: CoreState, farend, nearend_noisy,
                  nearend_clean=None, mult: int = 1,
                  opts: Options = DEFAULT_OPTIONS):
    """WebRtcAecm_ProcessBlock for a batch: blocks (B, 64) int32, state
    as stored.  Returns (state, output (B, 64) int32), with opts.debug
    also the taps dict."""
    res = _process_block(lift(state), farend, nearend_noisy, nearend_clean,
                         mult, opts)
    return (lower(res[0]),) + tuple(res[1:])


# ---------------------------------------------------------------------------
# Frame layer: 80-sample frames re-blocked into 64-sample blocks
# (aecm_core.cc:501-572)
# ---------------------------------------------------------------------------

def _place_at_fill(carry, payload, fill):
    """concat(carry[..., :fill], payload), left-aligned in a buffer of
    width payload + 64; fill (B, 1) is one of {0, 16, 32, 48} (other
    values give zeros)."""
    pad = torch.zeros_like(carry)
    out = torch.cat([payload, pad], dim=-1)
    sel = fill >> 4
    for k in (1, 2, 3):
        cand = torch.cat([carry[..., :16 * k], payload,
                          pad[..., :64 - 16 * k]], dim=-1)
        out = torch.where(sel == k, cand, out)
    return torch.where((sel >= 0) & (sel <= 3), out, 0)


def process_frame(state: CoreState, farend, nearend_noisy,
                  nearend_clean=None, mult: int = 1,
                  opts: Options = DEFAULT_OPTIONS, run_mask=None):
    """WebRtcAecm_ProcessFrame (aecm_core.cc:501-572) for a batch: one
    80-sample frame per stream in ((B, 80) int32), one out, re-blocked
    through 64-sample blocks.  Because writes are always 80 and reads 64,
    the reference's rings reduce to <= 48-sample carries (see the JAX
    package's core.process_frame).

    run_mask: optional (B,) bool; where False the stream's state comes
    back unchanged (the control layer's startup gate).  Returns (state,
    out (B, 80) int32), with opts.debug also the taps of both block slots,
    each (B, 2, ...): as in the JAX package, slot 1's taps are what the
    block computed whether or not the slot ran."""
    has_clean = nearend_clean is not None
    state = lift(state)
    if run_mask is None:
        run_mask = torch.ones_like(state.frame_fill, dtype=torch.bool)
    else:
        run_mask = run_mask.reshape(-1, 1)
    P = D.PART_LEN

    def gated(new, old):
        return torch.where(run_mask, new, old)

    fill = state.frame_fill
    two_blocks = fill >= 48           # fill + 80 >= 128
    work_far = _place_at_fill(state.in_carry_far, farend.to(I32), fill)
    work_noisy = _place_at_fill(state.in_carry_noisy,
                                nearend_noisy.to(I32), fill)
    state = state._replace(
        in_carry_far=gated(work_far[..., P:2 * P], state.in_carry_far),
        in_carry_noisy=gated(work_noisy[..., P:2 * P], state.in_carry_noisy),
        frame_fill=gated(torch.where(two_blocks, fill - 48, fill + 16),
                         fill))
    work_clean = None
    if has_clean:
        work_clean = _place_at_fill(state.in_carry_clean,
                                    nearend_clean.to(I32), fill)
        state = state._replace(in_carry_clean=gated(
            work_clean[..., P:2 * P], state.in_carry_clean))

    # block 1 runs only when the carry fill makes a second block
    outs, taps = [], []
    for k, active in enumerate((run_mask, run_mask & two_blocks)):
        blk = slice(k * P, (k + 1) * P)
        res = _process_block(
            state, work_far[..., blk], work_noisy[..., blk],
            None if work_clean is None else work_clean[..., blk], mult,
            opts)
        state = where_tree(active, res[0], state)
        outs.append(torch.where(active, res[1], 0))
        if opts.debug:
            taps.append(res[2])

    # out side: place the produced samples after the carried out_fill
    # samples, zero-stuff to 80 if short (first frames only), emit 80
    o = state.out_fill
    work_out = _place_at_fill(state.out_carry, torch.cat(outs, dim=-1), o)
    avail = o + (1 + two_blocks.to(I32)) * P
    stuff = (D.FRAME_LEN - avail).clamp(min=0)      # 0 or 16
    stuffed = stuff > 0
    out = torch.where(
        stuffed, torch.cat([state.out_tail, work_out[..., :P]], dim=-1),
        work_out[..., :D.FRAME_LEN])
    new_carry = torch.where(stuffed, work_out[..., P:2 * P],
                            work_out[..., D.FRAME_LEN:D.FRAME_LEN + P])
    state = state._replace(
        out_carry=gated(new_carry, state.out_carry),
        out_fill=gated(avail + stuff - D.FRAME_LEN, state.out_fill),
        out_tail=gated(out[..., -16:], state.out_tail))
    if opts.debug:
        return lower(state), out, {
            name: torch.stack([t[name] for t in taps], dim=1)
            for name in taps[0]}
    return lower(state), out
