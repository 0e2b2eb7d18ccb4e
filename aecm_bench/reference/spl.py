"""Fixed-point SPL primitives as PyTorch tensor ops.

Port of webrtc_aecm_tpu/ops/spl.py (the reference's signal processing
library, aecm/signal_processing_library.{h,cc} and aecm/spl_inl.h).  Every
op reproduces the exact C integer semantics the JAX package reproduces:
two's-complement wrap, arithmetic shifts of negatives, truncating division.

Conventions:
  * "w16"/"w32" values are int32 tensors; `to_w16` is the C `(int16_t)`
    wrap-around cast.
  * uint32 values are carried in int64 tensors holding [0, 2^32): PyTorch
    has no uint32 `+` or `>>` on the CPU.  `u32` makes such a carrier from
    an int32 bit pattern.
  * Shift counts that the JAX package masks `& 31` are masked here too;
    every shift that can leave the int32 range is done in int64 and wrapped.

The TPU workarounds of the JAX module are not ported: division is native
integer division (`torch.div(..., rounding_mode="trunc")` truncates like C),
`sqrt_floor` is an exact float64 root plus the same +/-1 integer check, and
the count of leading zeros comes from `torch.frexp` (exact on float64).
"""
from __future__ import annotations

import torch

from . import _device, tables

I32 = torch.int32
I64 = torch.int64

WORD16_MAX = 32767
WORD16_MIN = -32768
WORD32_MAX = 0x7FFFFFFF
WORD32_MIN = -0x80000000
MASK32 = 0xFFFFFFFF


def wrap32(x):
    """int64 tensor -> int32 with two's-complement wrap (mod 2^32)."""
    return (((x + 0x80000000) & MASK32) - 0x80000000).to(I32)


def u32(x):
    """int32 bit pattern (or an int64 carrier) -> uint32 carrier (int64)."""
    return x.to(I64) & MASK32


def to_w16(x):
    """C `(int16_t)` cast: keep the low 16 bits, sign-extend."""
    return (((x + 0x8000) & 0xFFFF) - 0x8000).to(I32)


def sat_w16(x):
    """WebRtcSpl_SatW32ToW16 (spl_inl.h:59-68): clamp to the int16 range."""
    return x.clamp(WORD16_MIN, WORD16_MAX).to(I32)


def add_sat_w16(a, b):
    """WebRtcSpl_AddSatW16 (spl_inl.h:84-86)."""
    return sat_w16(a.to(I32) + b.to(I32))


def add_sat_w32(a, b):
    """WebRtcSpl_AddSatW32 (spl_inl.h:70-82): saturating int32 addition."""
    return (a.to(I64) + b.to(I64)).clamp(WORD32_MIN, WORD32_MAX).to(I32)


def clz32(x):
    """Leading zeros of the uint32 value of x (int32 bit pattern or int64
    carrier); clz(0) = 32.  frexp of the exact float64 value gives the bit
    length as its exponent."""
    _, e = torch.frexp(u32(x).to(torch.float64))
    return (32 - e).to(I32)


def norm_w32(a):
    """WebRtcSpl_NormW32 (spl_inl.h:96-98): left-shift headroom of int32."""
    a = a.to(I32)
    masked = torch.where(a < 0, ~a, a)
    return torch.where(a == 0, 0, clz32(masked) - 1).to(I32)


def norm_u32(a):
    """WebRtcSpl_NormU32 (spl_inl.h:102-104)."""
    v = u32(a)
    return torch.where(v == 0, 0, clz32(v)).to(I32)


def norm_w16(a):
    """WebRtcSpl_NormW16 (spl_inl.h:108-111)."""
    a = a.to(I32)
    masked = torch.where(a < 0, ~a, a)
    return torch.where(a == 0, 0, clz32(masked) - 17).to(I32)


def _count(c, like):
    return c if torch.is_tensor(c) else _device.const(c, I32, like.device)


def shift_w32(x, c):
    """WEBRTC_SPL_SHIFT_W32 (signal_processing_library.h:130): c >= 0 is a
    wrapping left shift, c < 0 an arithmetic (int32) or logical (uint32
    carrier) right shift; counts masked `& 31` as in the JAX package."""
    c = _count(c, x).to(I64)
    cpos = c.clamp(min=0) & 31
    cneg = (-c).clamp(min=0) & 31
    if x.dtype == I64:                      # uint32 carrier
        left = (x << cpos) & MASK32
        right = x >> cneg
        return torch.where(c >= 0, left, right)
    x = x.to(I32)
    left = wrap32(x.to(I64) << cpos)
    right = (x.to(I64) >> cneg).to(I32)
    return torch.where(c >= 0, left, right)


def shl_u32(x, c):
    """uint32 left shift (carrier in, carrier out), count `& 31`."""
    return (u32(x) << (_count(c, x).to(I64) & 31)) & MASK32


def shr_u32(x, c):
    """uint32 logical right shift, count `& 31`."""
    return u32(x) >> (_count(c, x).to(I64) & 31)


def sar_i32(x, c):
    """int32 arithmetic right shift, count `& 31`."""
    return (x.to(I64) >> (_count(c, x).to(I64) & 31)).to(I32)


def shl_i32(x, c):
    """int32 wrapping left shift, count `& 31`."""
    return wrap32(x.to(I64) << (_count(c, x).to(I64) & 31))


def popcount_u32(v):
    """Population count of uint32 carriers (int64) -> int32."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & MASK32) >> 24).to(I32)


def mul_i64_shift_right(x, mult: int, shift: int):
    """(int64(x) * mult) >> shift, the echoFilt IIR of aecm_core_c.cc:524
    ((int64{diff} * 50) >> 8); the result always fits int32."""
    return ((x.to(I64) * mult) >> shift).to(I32)


def div_trunc(num, den):
    """C integer division (truncation toward zero).  A zero denominator
    gives num / 1: the callers select such lanes away, as the JAX package's
    callers do."""
    num = num.to(I32)
    den = _count(den, num).to(I32)
    den = torch.where(den == 0, 1, den).to(I32)
    return torch.div(num, den, rounding_mode="trunc").to(I32)


def div_w32_w16(num, den):
    """WebRtcSpl_DivW32W16 (signal_processing_library.cc:116-123):
    trunc(num / den) wrapped to int32; WORD32_MAX on den == 0."""
    num = num.to(I64)
    den = _count(den, num).to(I64)
    safe = torch.where(den == 0, 1, den)
    q = wrap32(torch.div(num, safe, rounding_mode="trunc"))
    return torch.where(den == 0, WORD32_MAX, q).to(I32)


def div_u32_u16(num, den):
    """WebRtcSpl_DivU32U16 (signal_processing_library.cc:107-114): uint32
    carriers in and out; 0xFFFFFFFF on den == 0."""
    num = u32(num)
    den = u32(_count(den, num))
    safe = torch.where(den == 0, 1, den)
    q = torch.div(num, safe, rounding_mode="floor")
    return torch.where(den == 0, MASK32, q)


def sqrt_floor(value):
    """WebRtcSpl_SqrtFloor (signal_processing_library.cc:84-105):
    floor(sqrt(value)) for value >= 0, 0 for negative values."""
    v = value.to(I64).clamp(min=0)
    r = torch.sqrt(v.to(torch.float64)).floor().to(I64)
    r = torch.where((r + 1) * (r + 1) <= v, r + 1, r)
    r = torch.where(r * r > v, r - 1, r)
    return r.to(I32)


def max_abs_value_w16(vector):
    """WebRtcSpl_MaxAbsValueW16C (signal_processing_library.cc:154-174):
    abs(-32768) takes part as 32768, the result is clamped to 32767.
    Reduces over the last axis."""
    return vector.to(I32).abs().amax(dim=-1).clamp(max=WORD16_MAX)


def rand_u_array(seed, n: int):
    """WebRtcSpl_RandUArray: n sequential RandU draws through the LCG's
    affine closure.  seed: uint32 carrier (int64), already 31-bit.
    Returns (values int32 in [0, 32767] of shape (n,), new seed)."""
    a_np, c_np = tables.lcg_tables(n)
    a = torch.as_tensor(a_np.astype("int64"), device=seed.device)
    c = torch.as_tensor(c_np.astype("int64"), device=seed.device)
    seeds = (a * seed.to(I64) + c) & tables.LCG_MASK
    return (seeds >> 16).to(I32), seeds[-1]
