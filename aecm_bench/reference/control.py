"""Control layer: state, configuration, buffering, startup governance.

Port of webrtc_aecm_tpu/control.py (reference: aecm/echo_control_mobile.
{h,cc}): the state tuple, `create`/`set_config`, the echo-path accessors,
and `buffer_farend` / `process`.  Each takes one stream's state, as
`create` makes it and as the JAX functions take it, or a batch of streams
(leaves (B, ...)) where the JAX functions are vmapped; one stream runs as a
batch of one.
The three elementwise pointer machines (`_delay_comp`, `_est_buf_delay`,
`_startup_machine`) work on any container with the control fields, batched
or not; the fused serving path shares them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import core as core_mod
from . import _device
from . import defines as D
from ._tree import tree_map
from . import ring_buffer as rbuf, spl

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
    with the default config {cngMode=on, echoMode=3}, on `device` (the
    CUDA card unless the caller asks for another)."""
    device = _device.resolve(device)

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
        _device.const(0.2, F32, ms.device) * ms.to(F32),
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


def _one_stream(state) -> bool:
    """Whether `state` is one stream's (scalar leaves 0-d), not a batch."""
    return state.ec_startup.ndim == 0


def _as_batch(state):
    """One stream's state as a batch of one (views)."""
    return tree_map(lambda x: x[None], state)


def _from_batch(state):
    """The only stream of a batch of one (views)."""
    return tree_map(lambda x: x[0], state)


def get_echo_path(state: AecmState):
    """WebRtcAecm_GetEchoPath (echo_control_mobile.cc:506-528)."""
    return state.core.channel_stored


def init_echo_path(state: AecmState, echo_path) -> AecmState:
    """WebRtcAecm_InitEchoPath (echo_control_mobile.cc:481-504)."""
    return state._replace(core=core_mod.init_echo_path(state.core, echo_path))


def buffer_farend(state: AecmState, farend, mult: int = 1) -> AecmState:
    """WebRtcAecm_BufferFarend (echo_control_mobile.cc:215-234): farend
    (80 * mult,) for one stream, (B, 80 * mult) int32 for a batch (rows may
    be a column slice of a longer signal).  One jitter-ring write, pointers
    and all (ring_buffer.write)."""
    if _one_stream(state):
        farend = torch.as_tensor(farend, device=state.ec_startup.device)
        return _from_batch(buffer_farend(_as_batch(state),
                                         farend.to(I32)[None], mult))
    comped = _delay_comp(state, mult)
    # _delay_comp moves only the read pointer and the delay_change flag
    enabled = state.ec_startup == 0
    fb = state.farend_buf
    fb = fb._replace(
        read_pos=torch.where(enabled, comped.farend_buf.read_pos,
                             fb.read_pos),
        rw_wrap=torch.where(enabled, comped.farend_buf.rw_wrap, fb.rw_wrap))
    return state._replace(
        farend_buf=rbuf.write(fb, farend),
        delay_change=torch.where(enabled, comped.delay_change,
                                 state.delay_change))


def process(state: AecmState, nearend_noisy, nearend_clean, out_len: int,
            ms_in_sndcard_buf, sample_rate: int,
            opts: core_mod.Options = core_mod.DEFAULT_OPTIONS):
    """WebRtcAecm_Process (echo_control_mobile.cc:236-408).

    nearend_noisy / nearend_clean: (B, out_len) int32 for a batch, or
    (out_len,) for one stream (clean may be None); out_len is 80 or 160;
    ms_in_sndcard_buf a scalar or (B,), clamped to [0, 500] + 10.  Returns
    (state, out (B, out_len) int32, warning (B,)), for one stream (state,
    out (out_len,), warning 0-d).  With opts.debug also the debug taps, a
    dict of (B, n_frames, 2 blocks, ...) tensors ((n_frames, 2, ...) for
    one stream); as in the JAX package they are what the enabled branch
    computed, in startup too.

    As in the JAX package both branches run for every stream and are
    merged: the startup machine, and the enabled frames gated by
    run_mask = not in startup.  So every call reads the jitter ring, in
    startup too: all of its 80-sample frames in one read_frames call,
    since nothing between the reads of a call moves the ring's pointers
    but the reads themselves."""
    if _one_stream(state):
        dev = state.ec_startup.device
        rows = [None if x is None
                else torch.as_tensor(x, device=dev).to(I32)[None]
                for x in (nearend_noisy, nearend_clean)]
        res = process(_as_batch(state), rows[0], rows[1], out_len,
                      ms_in_sndcard_buf, sample_rate, opts)
        one = (_from_batch(res[0]), res[1][0], res[2][0])
        if opts.debug:
            one += ({k: v[0] for k, v in res[3].items()},)
        return one
    mult = sample_rate // 8000
    n_frames = out_len // D.FRAME_LEN
    n_blocks_10ms = n_frames // mult
    has_clean = nearend_clean is not None
    F = D.FRAME_LEN

    ms = _device.as_int32(ms_in_sndcard_buf, state.ec_startup.device
                          ).expand_as(state.ec_startup)
    warn = torch.where((ms < 0) | (ms > 500),
                       D.AECM_BAD_PARAMETER_WARNING, 0).to(I32)
    state = state._replace(ms_in_sndcard_buf=(ms.clamp(0, 500) + 10
                                              ).to(I32))
    in_startup = state.ec_startup != 0
    run_mask = ~in_startup
    started = _startup_machine(state, n_blocks_10ms, mult)

    # --- enabled branch, gated per stream by run_mask ---
    est_idx = 0 if sample_rate == 8000 else 1
    noisy = nearend_noisy.to(I32)
    clean = nearend_clean.to(I32) if has_clean else None
    # The reads up to and including frame est_idx come before
    # _est_buf_delay, which moves the read pointer, and nothing else
    # between them does: they are one launch (at both rates' serving sizes,
    # all of the call's frames), and any frames after it a second.
    split = min(est_idx + 1, n_frames)
    ran, outs, taps = state, [], []
    for i in range(n_frames):
        if i in (0, split):
            first = i
            frames, haves, read_buf = rbuf.read_frames(
                ran.farend_buf, F, (split if i == 0 else n_frames) - i,
                run_mask)
            ran = ran._replace(farend_buf=read_buf)
        have_data = haves[:, i - first]
        old_i = ran.farend_old[:, i]
        farend = torch.where(have_data[:, None], frames[:, i - first], old_i)
        farend_old = torch.stack(
            [torch.where(run_mask[:, None], farend, old_i) if r == i
             else ran.farend_old[:, r] for r in range(2)], dim=1)
        ran = ran._replace(farend_old=farend_old)
        if i == est_idx:
            # _est_buf_delay touches only the ring pointers and the
            # delay-governance scalars
            est = _est_buf_delay(ran, mult)
            fb = ran.farend_buf
            ran = ran._replace(
                farend_buf=fb._replace(
                    read_pos=torch.where(run_mask, est.farend_buf.read_pos,
                                         fb.read_pos),
                    rw_wrap=torch.where(run_mask, est.farend_buf.rw_wrap,
                                        fb.rw_wrap)),
                **{f: torch.where(run_mask, getattr(est, f), getattr(ran, f))
                   for f in ("filt_delay", "time_for_delay_change",
                             "known_delay", "last_delay_diff")})
        # The reference extraction never forwards the control-layer
        # knownDelay into the core (echo_control_mobile.cc:390-391).
        res = core_mod.process_frame(
            ran.core, farend, noisy[:, i * F:(i + 1) * F],
            None if clean is None else clean[:, i * F:(i + 1) * F],
            mult=mult, opts=opts, run_mask=run_mask)
        ran = ran._replace(core=res[0])
        outs.append(res[1])
        if opts.debug:
            taps.append(res[2])

    # --- merge: the enabled branch is self-gated, so only the fields that
    # the startup machine writes are selected ---
    out = torch.where(in_startup[:, None],
                      noisy if clean is None else clean,
                      torch.cat(outs, dim=-1))
    fb = ran.farend_buf
    state = ran._replace(
        farend_buf=fb._replace(
            read_pos=torch.where(in_startup, started.farend_buf.read_pos,
                                 fb.read_pos),
            rw_wrap=torch.where(in_startup, started.farend_buf.rw_wrap,
                                fb.rw_wrap)),
        **{f: torch.where(in_startup, getattr(started, f), getattr(ran, f))
           for f in ("ec_startup", "check_buff_size", "check_buf_size_ctr",
                     "counter", "sum", "first_val", "buf_size_start")})
    if opts.debug:
        return state, out, warn, {
            name: torch.stack([t[name] for t in taps], dim=1)
            for name in taps[0]}
    return state, out, warn
