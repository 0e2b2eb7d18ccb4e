"""Bit-exact int16 radix-2 FFT, batch-major (PyTorch port).

Port of webrtc_aecm_tpu/ops/fft.py (reference: aecm/complex_fft.c:241-491,
aecm/real_fft.c:47-102) in its batched form: every function takes int32
tensors of shape (..., 2^order) holding int16-range values, the leading
axes being streams, and runs each butterfly stage as one elementwise pass
over a (..., groups, 2, half) view.  Both accuracy modes (mode 1, the
high-accuracy mode AECM uses, and mode 0) and every order up to
kMaxFFTOrder = 10 are covered; the inverse keeps the data-dependent
per-stage scaling, chosen per stream from the running max-abs.

The lane-major order-7 pair of the fused path lives in fused.py.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import defines as D
from . import spl

I32 = torch.int32

ORDER = 7            # 128-point FFT (PART_LEN_SHIFT)
MAX_FFT_ORDER = 10   # kMaxFFTOrder (real_fft.h:18-20)

# Q15 sine table (complex_fft.c:28-142), from its closed form.
SIN_TABLE_1024 = np.trunc(np.sin(2.0 * np.pi * np.arange(1024) / 1024.0)
                          * 32767.0).astype(np.int32)


def _bit_reverse_perm(order: int) -> np.ndarray:
    n = 1 << order
    return np.array([int(f"{i:0{order}b}"[::-1], 2) for i in range(n)],
                    np.int64)


@lru_cache(maxsize=None)
def _tables(order: int, device: torch.device):
    """(bitrev, [(wr, ws) per stage]) on `device`.  Stage s has half-length
    l = 2^s and twiddle index j = m << (9 - s): the table stride starts at
    9 whatever the order (complex_fft.c:254-256)."""
    stages = []
    for s in range(order):
        j = np.arange(1 << s) << (9 - s)
        stages.append(tuple(torch.as_tensor(SIN_TABLE_1024[k], device=device)
                            for k in (j + 256, j)))
    return (torch.as_tensor(_bit_reverse_perm(order), device=device),
            stages)


def _view(x, l: int):
    """(..., n) -> (..., n // 2l, 2, l): axis -2 picks top / bottom."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // (2 * l), 2, l))


def _stage(fr, fi, l, wr, wi, mode, shift=None, rnd_inv=None):
    """One butterfly stage (complex_fft.c:257-357 forward, :400-483
    inverse); `shift` (..., 1, 1) selects the inverse with its
    data-dependent down-shift and rounding."""
    r, im = _view(fr, l), _view(fi, l)
    ar, br = r[..., 0, :], r[..., 1, :]
    ai, bi = im[..., 0, :], im[..., 1, :]
    if mode == 1:
        sft, rnd = ((D.CFFTSFT, D.CFFTRND) if shift is None
                    else (D.CIFFTSFT, D.CIFFTRND))
        tr = (wr * br - wi * bi + rnd) >> (15 - sft)
        ti = (wr * bi + wi * br + rnd) >> (15 - sft)
        qr, qi = ar << sft, ai << sft
        if shift is None:
            down, rnd2 = 1 + D.CFFTSFT, D.CFFTRND2
        else:
            down, rnd2 = shift + D.CIFFTSFT, rnd_inv
    else:
        tr = (wr * br - wi * bi) >> 15
        ti = (wr * bi + wi * br) >> 15
        qr, qi = ar, ai
        down, rnd2 = (1 if shift is None else shift), 0
    out_r = torch.stack([spl.to_w16((qr + tr + rnd2) >> down),
                         spl.to_w16((qr - tr + rnd2) >> down)], dim=-2)
    out_i = torch.stack([spl.to_w16((qi + ti + rnd2) >> down),
                         spl.to_w16((qi - ti + rnd2) >> down)], dim=-2)
    return out_r.reshape(fr.shape), out_i.reshape(fi.shape)


def complex_fft(fr, fi, order: int = ORDER, mode: int = 1):
    """WebRtcSpl_ComplexFFT (complex_fft.c:241-359): int32 (..., 2^order),
    already bit-reversed by the caller.  Returns (fr, fi)."""
    fr, fi = fr.to(I32), fi.to(I32)
    _, stages = _tables(order, fr.device)
    for s, (wr, ws) in enumerate(stages):
        fr, fi = _stage(fr, fi, 1 << s, wr, -ws, mode)
    return fr, fi


def complex_ifft(fr, fi, order: int = ORDER, mode: int = 1):
    """WebRtcSpl_ComplexIFFT (complex_fft.c:361-491).  Each stage's shift
    comes from the max-abs over both real and imag parts of each stream.
    Returns (fr, fi, scale (...,) int32)."""
    fr, fi = fr.to(I32), fi.to(I32)
    _, stages = _tables(order, fr.device)
    scale = torch.zeros(fr.shape[:-1], dtype=I32, device=fr.device)
    for s, (wr, ws) in enumerate(stages):
        maxabs = torch.maximum(spl.max_abs_value_w16(fr),
                               spl.max_abs_value_w16(fi))
        shift = ((maxabs > 13573).to(I32) + (maxabs > 27146).to(I32))
        scale = scale + shift
        shift = shift[..., None, None]
        fr, fi = _stage(fr, fi, 1 << s, wr, ws, mode, shift=shift,
                        rnd_inv=torch.full_like(shift, 8192) << shift)
    return fr, fi, scale


@lru_cache(maxsize=None)
def make_real_fft(order: int = ORDER):
    """Real FFT pair for any order <= kMaxFFTOrder: (forward, inverse).
    The complex core always runs mode 1, as in the C wrapper (real_fft.c:66,
    :97)."""
    if not 1 <= order <= MAX_FFT_ORDER:
        raise ValueError(f"order must be in [1, {MAX_FFT_ORDER}]")
    n = 1 << order

    def real_forward_fft(real_in):
        """WebRtcSpl_RealForwardFFT (real_fft.c:47-72): (..., 2^order)
        samples -> (re, im) of shape (..., 2^(order-1) + 1)."""
        bitrev, _ = _tables(order, real_in.device)
        fr = real_in.to(I32)[..., bitrev]
        fr, fi = complex_fft(fr, torch.zeros_like(fr), order)
        return fr[..., :n // 2 + 1], fi[..., :n // 2 + 1]

    def real_inverse_fft(re, im):
        """WebRtcSpl_RealInverseFFT (real_fft.c:74-102): the unique bins
        -> (samples (..., 2^order), scale (...,)).  The conjugate half's
        negation wraps like the C int16 store (-(-32768) stays -32768)."""
        bitrev, _ = _tables(order, re.device)
        re, im = re.to(I32), im.to(I32)
        fr = torch.cat([re, re[..., 1:-1].flip(-1)], dim=-1)
        fi = torch.cat([im, spl.to_w16(-im[..., 1:-1].flip(-1))], dim=-1)
        fr, _, scale = complex_ifft(fr[..., bitrev], fi[..., bitrev], order)
        return fr, scale

    return real_forward_fft, real_inverse_fft


# The AECM hot path: the order-7 (128-point) pair.
real_forward_fft, real_inverse_fft = make_real_fft(ORDER)
