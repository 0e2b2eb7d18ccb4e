"""The PyTorch port's batch-major FFTs == the JAX package's (tolerance 0).

webrtc_aecm_tpu_torch/ops/fft.py against webrtc_aecm_tpu/ops/fft.py on the
CPU: the complex pair in both accuracy modes (rows are streams; the
inverse's per-stage scaling is chosen per stream, so loud and quiet rows
are mixed) and the real pair (JAX's vmapped, batched rule), at orders from
1 to kMaxFFTOrder.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu.ops import fft as jfft
from webrtc_aecm_tpu_torch.ops import fft as tfft

torch.set_num_threads(1)

# The smallest orders, a middle one and kMaxFFTOrder; the AECM order (7)
# runs inside every core comparison of tests/test_torch_core.py and
# tests/test_torch_batch.py.
ORDERS = [1, 2, 3, 5, 10]

# The JAX module caches its twiddle and bit-reversal arrays on first use;
# fill the caches outside any jit trace, so that no trace leaves a tracer
# in them.
for _order in ORDERS:
    jfft._stage_twiddles(_order)
    jfft._bitrev(_order)


def _rows(rng, n, width):
    x = rng.integers(-32768, 32768, (n, width)).astype(np.int32)
    x[1] //= 97           # a quiet stream: other inverse shifts
    x[2] = -32768         # int16 extremes
    x[3, ::2] = 32767
    return x


@functools.lru_cache(maxsize=None)
def _case(order):
    """Inputs at `order` and the JAX package's answers, from one jitted
    call: the complex pair in both modes, the real pair."""
    rng = np.random.default_rng(order)
    n = 1 << order
    fr, fi = _rows(rng, 5, n), _rows(rng, 5, n)
    x = _rows(rng, 6, n)
    re, im = _rows(rng, 6, n // 2 + 1), _rows(rng, 6, n // 2 + 1)
    im[4] = -32768        # the conjugate half's negation wraps
    j_fwd, j_inv = jfft.make_real_fft(order)

    def run(fr, fi, x, re, im):
        return ({m: (jfft.complex_fft(fr, fi, order, m),
                     jfft.complex_ifft(fr, fi, order, m)) for m in (0, 1)},
                jax.vmap(j_fwd)(x), jax.vmap(j_inv)(re, im))
    want = jax.jit(run)(*map(jnp.asarray, (fr, fi, x, re, im)))
    return (fr, fi, x, re, im), jax.tree_util.tree_map(np.asarray, want)


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("mode", [0, 1])
def test_complex_pair(order, mode):
    (fr, fi, _, _, _), (want, _, _) = _case(order)
    t = torch.as_tensor
    _equal(tfft.complex_fft(t(fr), t(fi), order, mode), want[mode][0])
    _equal(tfft.complex_ifft(t(fr), t(fi), order, mode), want[mode][1])


@pytest.mark.parametrize("order", ORDERS)
def test_real_pair(order):
    (_, _, x, re, im), (_, want_fwd, want_inv) = _case(order)
    t_fwd, t_inv = tfft.make_real_fft(order)
    _equal(t_fwd(torch.as_tensor(x)), want_fwd)
    _equal(t_inv(torch.as_tensor(re), torch.as_tensor(im)), want_inv)


def test_order_out_of_range_raises():
    with pytest.raises(ValueError):
        tfft.make_real_fft(11)
