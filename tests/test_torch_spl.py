"""PyTorch port's fixed-point ops == the JAX package's (tolerance 0).

webrtc_aecm_tpu_torch/ops/spl.py against webrtc_aecm_tpu/ops/spl.py on
seeded random values plus the edges of each op's domain (INT16_MIN,
INT32 extremes, negative numerators and denominators, den = 1, 0 and
all-ones uint32), and the quotient-boundary sweep of test_spl.py's
test_div_fast_exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu.ops import spl as jspl
from webrtc_aecm_tpu_torch.ops import spl as tspl

torch.set_num_threads(1)

I32_EDGES = np.array([0, 1, -1, 2, -2, 32767, -32768, 32768, -32769, 65535,
                      2**30, -2**30, 2**31 - 1, -2**31, 0x40000000],
                     np.int64)


def _i32(rng, n=4000):
    return np.concatenate([I32_EDGES, rng.integers(-2**31, 2**31, n),
                           rng.integers(-40000, 40000, n)]).astype(np.int32)


def _u32(rng, n=4000):
    edges = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 65535,
                      65536], np.uint64)
    return np.concatenate([edges, rng.integers(0, 2**32, n).astype(
        np.uint64)]).astype(np.uint32)


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _tu(x):     # uint32 -> the port's int64 carrier
    return torch.as_tensor(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("name", ["to_w16", "sat_w16", "norm_w32",
                                  "norm_w16", "sqrt_floor"])
def test_unary_i32(name):
    x = _i32(np.random.default_rng(0))
    if name == "norm_w16":
        x = np.clip(x, -32768, 32767).astype(np.int32)
    _eq(getattr(tspl, name)(_t(x)), getattr(jspl, name)(jnp.asarray(x)))


def test_norm_u32_and_clz():
    x = _u32(np.random.default_rng(1))
    _eq(tspl.norm_u32(_tu(x)), jspl.norm_u32(jnp.asarray(x)))
    _eq(tspl.clz32(_tu(x)), jspl.clz32(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["add_sat_w16", "add_sat_w32"])
def test_add_sat(name):
    rng = np.random.default_rng(2)
    a, b = _i32(rng), _i32(rng)
    if name == "add_sat_w16":
        a = np.clip(a, -32768, 32767).astype(np.int32)
        b = np.clip(b, -32768, 32767).astype(np.int32)
    _eq(getattr(tspl, name)(_t(a), _t(b)),
        getattr(jspl, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["shl_i32", "sar_i32", "shift_w32"])
def test_shifts_i32(name):
    rng = np.random.default_rng(3)
    x = _i32(rng)
    c = rng.integers(-40, 40, x.shape).astype(np.int32)
    _eq(getattr(tspl, name)(_t(x), _t(c)),
        getattr(jspl, name)(jnp.asarray(x), jnp.asarray(c)))


def test_shifts_u32():
    rng = np.random.default_rng(4)
    x = _u32(rng)
    c = rng.integers(-40, 40, x.shape).astype(np.int32)
    _eq(tspl.shift_w32(_tu(x), _t(c)),
        jspl.shift_w32(jnp.asarray(x), jnp.asarray(c)))
    _eq(tspl.shl_u32(_tu(x), _t(c)),
        jspl.shl_u32(jnp.asarray(x), jnp.asarray(c)))
    _eq(tspl.shr_u32(_tu(x), _t(c)),
        jspl.shr_u32(jnp.asarray(x), jnp.asarray(c)))


def test_div_trunc_and_mul_shift():
    rng = np.random.default_rng(5)
    num = _i32(rng)
    den = rng.integers(-40000, 40000, num.shape).astype(np.int32)
    den[den == 0] = 1
    den[:8] = [1, -1, 3, -3, 7, -32768, 32767, 2]
    ok = ~((num == -2**31) & (den == -1))
    num, den = num[ok], den[ok]
    _eq(tspl.div_trunc(_t(num), _t(den)),
        jspl.div_trunc(jnp.asarray(num), jnp.asarray(den)))
    _eq(tspl.mul_i64_shift_right(_t(num), 50, 8),
        jspl.mul_i64_shift_right(jnp.asarray(num), 50, 8))


def test_div_w32_w16_edges():
    rng = np.random.default_rng(6)
    num = _i32(rng)
    den = rng.integers(-32768, 32768, num.shape).astype(np.int32)
    den[:6] = [0, 1, -1, -32768, 32767, 0]
    _eq(tspl.div_w32_w16(_t(num), _t(den)),
        jspl.div_w32_w16(jnp.asarray(num), jnp.asarray(den)))


def test_div_u32_u16_edges():
    rng = np.random.default_rng(7)
    num = _u32(rng)
    den = rng.integers(0, 65536, num.shape).astype(np.uint32)
    den[:6] = [0, 1, 65535, 2, 0, 1]
    _eq(tspl.div_u32_u16(_tu(num), _tu(den)),
        jspl.div_u32_u16(jnp.asarray(num), jnp.asarray(den)))


def test_div_fast_exact_sweep():
    """test_spl.py's quotient-boundary sweep (every 16-bit den crossed
    with k*den - 1, k*den, k*den + 1 for extreme and random k, plus a
    random sweep), through both packages."""
    rng = np.random.default_rng(7)
    dens = np.arange(1, 65536, dtype=np.uint64)
    n = len(dens)
    numerators, denominators = [], []
    for kind in range(6):
        if kind == 0:
            k = (2**32 - 1) // dens
        elif kind == 1:
            k = rng.integers(0, 2**31, n).astype(np.uint64) % (
                (2**32 - 1) // dens + 1)
        elif kind == 2:
            k = np.minimum((2**32 - 1) // dens, 1)
        elif kind == 3:
            k = np.minimum((2**32 - 1) // dens, 2**16 - 1)
        elif kind == 4:
            k = np.minimum((2**32 - 1) // dens, 2**24 + 1)
        else:
            k = ((2**32 - 1) // dens) // 2
        base = k * dens
        for off in (-1, 0, 1):
            v = base.astype(np.int64) + off
            ok = (v >= 0) & (v <= 2**32 - 1)
            numerators.append(v[ok].astype(np.uint64))
            denominators.append(dens[ok])
    numerators.append(rng.integers(0, 2**32, 10**5).astype(np.uint64))
    denominators.append(rng.integers(1, 2**16, 10**5).astype(np.uint64))
    num = np.concatenate(numerators).astype(np.uint32)
    den = np.concatenate(denominators).astype(np.uint32)
    _eq(tspl.div_u32_u16(_tu(num), _tu(den)),
        jspl.div_u32_u16(jnp.asarray(num), jnp.asarray(den)))

    num_s = rng.integers(-2**31, 2**31, 10**5).astype(np.int32)
    den_s = rng.integers(-32768, 32768, 10**5).astype(np.int32)
    den_s[den_s == 0] = 1
    _eq(tspl.div_w32_w16(_t(num_s), _t(den_s)),
        jspl.div_w32_w16(jnp.asarray(num_s), jnp.asarray(den_s)))
    edge_n = np.array([-2**31, -2**31, -2**31 + 1, 2**31 - 1], np.int32)
    edge_d = np.array([3, -32768, -1, 7], np.int32)
    _eq(tspl.div_w32_w16(_t(edge_n), _t(edge_d)),
        jspl.div_w32_w16(jnp.asarray(edge_n), jnp.asarray(edge_d)))


def test_max_abs_value_w16():
    rng = np.random.default_rng(8)
    x = rng.integers(-32768, 32768, (64, 33)).astype(np.int32)
    x[3, :] = -32768
    _eq(tspl.max_abs_value_w16(_t(x)), jspl.max_abs_value_w16(
        jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 666, 0x7FFFFFFF, 123456789])
def test_rand_u_array(seed):
    vals, new_seed = tspl.rand_u_array(torch.tensor(seed, dtype=torch.int64),
                                       64)
    jv, js = jspl.rand_u_array(jnp.asarray(seed, jnp.uint32), 64)
    _eq(vals, jv)
    _eq(new_seed, js)
