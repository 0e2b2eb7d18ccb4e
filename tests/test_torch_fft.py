"""PyTorch port's lane-major FFT pair == the JAX package's (tolerance 0).

The forward/inverse 128-point int16 FFTs of webrtc_aecm_tpu/fused.py
(`_real_forward_fft`, `_real_inverse_fft`, fused.py:301-371, run on the
CPU as plain jnp) against webrtc_aecm_tpu_torch/fused.py, where the int8
permutation matmuls became index gathers.  Columns are streams.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu import fused as jf
from webrtc_aecm_tpu_torch import fused as tf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    return jf.make_tables(), tf.make_tables(device="cpu")


@pytest.mark.parametrize("hi", [32768, 4096, 64])
def test_real_forward_fft(tables, hi):
    jt, tt = tables
    rng = np.random.default_rng(hi)
    x = rng.integers(-hi, hi, (128, 24)).astype(np.int32)
    x[:, 0] = -32768
    x[:, 1] = 0
    jre, jim = jf._real_forward_fft(jnp.asarray(x), jt)
    tre, tim = tf._real_forward_fft(torch.as_tensor(x), tt)
    np.testing.assert_array_equal(tre.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(tim.numpy(), np.asarray(jim))


@pytest.mark.parametrize("hi", [32768, 1024])
def test_real_inverse_fft_per_stream_scaling(tables, hi):
    """The data-dependent per-stage scaling is chosen per stream: mix
    loud and quiet columns."""
    jt, tt = tables
    rng = np.random.default_rng(hi + 1)
    re = rng.integers(-hi, hi, (65, 24)).astype(np.int32)
    im = rng.integers(-hi, hi, (65, 24)).astype(np.int32)
    re[:, ::3] //= 64
    im[:, ::3] //= 64
    jr, js = jf._real_inverse_fft(jnp.asarray(re), jnp.asarray(im), jt)
    tr, ts = tf._real_inverse_fft(torch.as_tensor(re), torch.as_tensor(im),
                                  tt)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_real_inverse_fft_wraps_negated_int16_min(tables):
    """im = -32768 (reachable through CNG saturation): its negation in the
    conjugate half wraps to -32768, as the int16 reference does."""
    jt, tt = tables
    rng = np.random.default_rng(9)
    re = rng.integers(-2000, 2000, (65, 4)).astype(np.int32)
    im = rng.integers(-2000, 2000, (65, 4)).astype(np.int32)
    im[5] = -32768
    im[33] = -32768
    jr, js = jf._real_inverse_fft(jnp.asarray(re), jnp.asarray(im), jt)
    tr, ts = tf._real_inverse_fft(torch.as_tensor(re), torch.as_tensor(im),
                                  tt)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_time_to_frequency_domain(tables):
    """The windowed analysis around the forward FFT (magnitudes, Q
    scaling, magnitude sum)."""
    jt, tt = tables
    rng = np.random.default_rng(11)
    x = rng.integers(-32768, 32768, (128, 16)).astype(np.int32)
    x[:, 1] //= 1000
    x[:, 2] = 0
    js, (jre, jim), jmag, jsum = jf._time_to_frequency_domain_f(
        jnp.asarray(x), jt)
    ts, (tre, tim), tmag, tsum = tf._time_to_frequency_domain_f(
        torch.as_tensor(x), tt)
    for got, want in ((ts, js), (tre, jre), (tim, jim), (tmag, jmag),
                      (tsum, jsum)):
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))
