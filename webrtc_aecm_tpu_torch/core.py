"""AECM core state and its scalar helpers (PyTorch port).

Port of the parts of webrtc_aecm_tpu/core.py (reference: aecm/aecm_core.
{h,cc}, aecm/aecm_core_c.cc) that the fused serving path uses: the state
tuple and its creation, the log-energy and asymmetric-filter helpers, and
the comfort-noise phase lookup.  The per-block core itself is lane-major in
fused.py and, on the GPU, in the frames kernel (csrc/frames.cu).

Dtypes follow the JAX package, with two changes forced by PyTorch: the
uint32 `seed` is carried in an int64 tensor ([0, 2^32), see ops/spl.py),
and the batch-major `far_history` is int32 (it exists only to be packed
into the fused layout by fused.to_fused_core).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import defines as D
from . import delay_estimator as de
from . import tables
from .ops import spl

I32 = torch.int32
I64 = torch.int64


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
    """WebRtcAecm_InitEchoPathCore (aecm_core.cc:249-265)."""
    dev = state.x_buf.device
    echo_path = torch.as_tensor(echo_path, dtype=I32, device=dev)
    s = lambda v: torch.tensor(v, dtype=I32, device=dev)  # noqa: E731
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
