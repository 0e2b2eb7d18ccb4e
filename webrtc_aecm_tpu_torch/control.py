"""Control layer: state, configuration, delay and startup governance.

Port of the parts of webrtc_aecm_tpu/control.py (reference: aecm/
echo_control_mobile.{h,cc}) that the fused serving path uses: the state
tuple, `create`/`set_config`, and the three elementwise pointer machines
(`_delay_comp`, `_est_buf_delay`, `_startup_machine`).  They work on any
container with the control fields, batched or not, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import core as core_mod
from . import defines as D
from .ops import ring_buffer as rbuf, spl

I32 = torch.int32
F32 = torch.float32


class AecmState(NamedTuple):
    """AecMobile (echo_control_mobile.cc:42-79)."""
    core: core_mod.CoreState
    farend_buf: rbuf.RingBuffer        # 4000-sample int16 jitter ring
    farend_old: torch.Tensor           # (2, FRAME_LEN) underrun replay
    ec_startup: torch.Tensor
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


def _supgain_table() -> np.ndarray:
    """echoMode 0-4 -> suppression-gain parameter rows
    (echo_control_mobile.cc:431-476): [default, a, d, a - b, b - d]."""
    rows = []
    for mode in range(5):
        shift = mode - 3

        def s(v):
            return v << shift if shift >= 0 else v >> -shift

        a = s(D.SUPGAIN_ERROR_PARAM_A)
        b = s(D.SUPGAIN_ERROR_PARAM_B)
        d = s(D.SUPGAIN_ERROR_PARAM_D)
        rows.append([s(D.SUPGAIN_DEFAULT), a, d, a - b, b - d])
    return np.array(rows, dtype=np.int32)


_SUPGAIN_TABLE = _supgain_table()


def create(sample_rate: int = 8000, device=None) -> AecmState:
    """WebRtcAecm_Create + WebRtcAecm_Init (echo_control_mobile.cc:89-191)
    with the default config {cngMode=on, echoMode=3}."""
    def s(v):
        return torch.tensor(v, dtype=I32, device=device)

    state = AecmState(
        core=core_mod.create_core(sample_rate, device=device),
        farend_buf=rbuf.create(D.BUF_SIZE_SAMP, torch.int16, device=device),
        farend_old=torch.zeros((2, D.FRAME_LEN), dtype=I32, device=device),
        ec_startup=s(1),
        check_buff_size=s(1),
        check_buf_size_ctr=s(0),
        counter=s(0),
        sum=s(0),
        first_val=s(0),
        buf_size_start=s(0),
        ms_in_sndcard_buf=s(0),
        filt_delay=s(0),
        time_for_delay_change=s(0),
        known_delay=s(0),
        last_delay_diff=s(0),
        delay_change=s(1),
        echo_mode=s(3),
    )
    return set_config(state, cng_mode=1, echo_mode=3)


def set_config(state: AecmState, cng_mode, echo_mode) -> AecmState:
    """WebRtcAecm_set_config (echo_control_mobile.cc:410-479) for one
    stream (scalar or 0-d cng_mode/echo_mode)."""
    dev = state.ec_startup.device
    echo_mode = torch.as_tensor(echo_mode, dtype=I32, device=dev)
    table = torch.as_tensor(_SUPGAIN_TABLE, device=dev)
    row = table[echo_mode.clamp(0, 4).long()]
    core = state.core._replace(
        cng_mode=torch.as_tensor(cng_mode, dtype=I32, device=dev),
        sup_gain=row[..., 0],
        sup_gain_old=row[..., 0].clone(),
        sup_gain_err_param_a=row[..., 1],
        sup_gain_err_param_d=row[..., 2],
        sup_gain_err_param_diff_ab=row[..., 3],
        sup_gain_err_param_diff_bd=row[..., 4],
    )
    return state._replace(core=core, echo_mode=echo_mode)


def _delay_comp(state, mult: int):
    """WebRtcAecm_DelayComp (echo_control_mobile.cc:575-594)."""
    n_samp_far = rbuf.available_read(state.farend_buf)
    n_samp_sndcard = state.ms_in_sndcard_buf * D.SAMP_MS_NB * mult
    delay_new = n_samp_sndcard - n_samp_far
    stuff = delay_new > (D.FAR_BUF_LEN - D.FRAME_LEN * mult)
    n_samp_add = ((n_samp_sndcard >> 1) - n_samp_far).clamp(
        min=D.FRAME_LEN, max=10 * D.FRAME_LEN)
    farend_buf = rbuf.move_read_ptr(
        state.farend_buf, torch.where(stuff, -n_samp_add, 0).to(I32))
    delay_change = torch.where(stuff, 1, state.delay_change).to(I32)
    return state._replace(farend_buf=farend_buf, delay_change=delay_change)


def _est_buf_delay(state, mult: int):
    """WebRtcAecm_EstBufDelay (echo_control_mobile.cc:534-573)."""
    n_samp_far = rbuf.available_read(state.farend_buf)
    n_samp_sndcard = state.ms_in_sndcard_buf * D.SAMP_MS_NB * mult
    delay_new = n_samp_sndcard - n_samp_far

    shortfall = delay_new < D.FRAME_LEN
    farend_buf = rbuf.move_read_ptr(
        state.farend_buf, torch.where(shortfall, D.FRAME_LEN, 0).to(I32))
    delay_new = torch.where(shortfall, delay_new + D.FRAME_LEN, delay_new)

    filt_delay = spl.div_trunc(8 * state.filt_delay + 2 * delay_new,
                               10).clamp(min=0)

    diff = filt_delay - state.known_delay
    inc_hi = torch.where(state.last_delay_diff < 96, 0,
                         state.time_for_delay_change + 1)
    inc_lo = torch.where(state.last_delay_diff > 224, 0,
                         state.time_for_delay_change + 1)
    time_for_delay_change = torch.where(
        diff > 224, inc_hi,
        torch.where((diff < 96) & (state.known_delay > 0), inc_lo,
                    torch.zeros_like(inc_lo))).to(I32)

    known_delay = torch.where(time_for_delay_change > 25,
                              (filt_delay - 160).clamp(min=0),
                              state.known_delay).to(I32)
    return state._replace(farend_buf=farend_buf, filt_delay=filt_delay,
                          time_for_delay_change=time_for_delay_change,
                          known_delay=known_delay,
                          last_delay_diff=diff.to(I32))


def _startup_machine(state, n_blocks_10ms: int, mult: int):
    """The ECstartup governance (echo_control_mobile.cc:285-355): wait for
    the reported sound-card buffer to settle, size the jitter buffer,
    align the read pointer, and enable cancellation."""
    filled = torch.div(rbuf.available_read(state.farend_buf), D.FRAME_LEN,
                       rounding_mode="floor").to(I32)

    # --- check_size, applied where check_buff_size != 0 ---
    ms = state.ms_in_sndcard_buf
    ctr = state.check_buf_size_ctr + 1
    first_val = torch.where(state.counter == 0, ms, state.first_val)
    acc = torch.where(state.counter == 0, 0, state.sum)
    thresh = torch.clamp(
        torch.tensor(0.2, dtype=F32, device=ms.device) * ms.to(F32),
        min=float(D.SAMP_MS_NB))
    stable = (first_val - ms).abs().to(F32) < thresh
    acc = torch.where(stable, acc + ms, acc)
    counter = torch.where(stable, state.counter + 1, 0)

    done_avg = counter * n_blocks_10ms >= 6
    size_avg = spl.div_trunc(3 * acc * mult, counter * 40).clamp(
        max=D.BUF_SIZE_FRAMES)
    done_timeout = ctr * n_blocks_10ms > 50
    size_timeout = spl.div_trunc(3 * ms * mult, 40).clamp(
        max=D.BUF_SIZE_FRAMES)
    buf_size_start = torch.where(
        done_timeout, size_timeout,
        torch.where(done_avg, size_avg, state.buf_size_start))
    check_buff_size = torch.where(done_avg | done_timeout, 0, 1)

    checking = state.check_buff_size != 0
    checked = dict(check_buf_size_ctr=ctr, first_val=first_val, sum=acc,
                   counter=counter, buf_size_start=buf_size_start,
                   check_buff_size=check_buff_size)
    state = state._replace(**{
        f: torch.where(checking, v, getattr(state, f)).to(I32)
        for f, v in checked.items()})

    # --- buffer sizing settled -> align and enable ---
    settled = state.check_buff_size == 0
    enable_eq = settled & (filled == state.buf_size_start)
    enable_gt = settled & (filled > state.buf_size_start)
    avail = rbuf.available_read(state.farend_buf)
    farend_buf = rbuf.move_read_ptr(
        state.farend_buf,
        torch.where(enable_gt, avail - state.buf_size_start * D.FRAME_LEN,
                    0).to(I32))
    ec_startup = torch.where(enable_eq | enable_gt, 0,
                             state.ec_startup).to(I32)
    return state._replace(farend_buf=farend_buf, ec_startup=ec_startup)
