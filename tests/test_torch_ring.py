"""PyTorch port's jitter-ring pass == the JAX package's (tolerance 0).

The plain version of the ring kernel (ops/ring_kernels.py, which CPU
tensors take) against webrtc_aecm_tpu/fused.py `_ring_write_gather_multi`
on the CPU, at one and two chunks per pass, with uniform positions and with
per-stream (clamped, divergent) positions and write counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu import fused as jf
from webrtc_aecm_tpu_torch.ops import ring_kernels

torch.set_num_threads(1)

CAP, N = 4000, 160


@pytest.fixture(scope="module")
def jax_pass():
    return jax.jit(jf._ring_write_gather_multi, static_argnums=(5,))


def _case(cps, divergent, b=12, seed=0):
    rng = np.random.default_rng(seed + 10 * cps + divergent)
    data = rng.integers(-32768, 32768, (b, CAP)).astype(np.int16)
    values = rng.integers(-32768, 32768, (b, cps * N)).astype(np.int32)
    w0 = int(rng.integers(0, CAP))
    wpos = np.array([(w0 + c * N) % CAP for c in range(cps)],
                    np.int32)[:, None].repeat(b, 1)
    rpos = ((wpos - 500) % CAP).astype(np.int32)
    n_write = np.full((cps, b), N, np.int32)
    if divergent:
        sel = np.arange(b) % 3 == 0
        k = int(sel.sum())
        wpos[:, sel] = rng.integers(0, CAP + 1, (cps, k))
        rpos[:, sel] = rng.integers(0, CAP + 1, (cps, k))
        n_write[:, sel] = rng.integers(0, N + 1, (cps, k))
        wpos[0, 1] = CAP          # a write position resting at capacity
        rpos[0, 2] = CAP - 5      # a gather that wraps
        wpos[-1, 4] = CAP - 7     # a write that wraps
        n_write[-1, 4] = N
    return data, wpos, values, n_write, rpos


@pytest.mark.parametrize("cps", [1, 2])
@pytest.mark.parametrize("divergent", [False, True])
def test_ring_pass_matches_jax(jax_pass, cps, divergent):
    data, wpos, values, n_write, rpos = _case(cps, divergent)
    jd, jg = jax_pass(jnp.asarray(data), jnp.asarray(wpos),
                      jnp.asarray(values), jnp.asarray(n_write),
                      jnp.asarray(rpos), N)
    t = torch.as_tensor
    td, tg = ring_kernels.ring_multi_pass(t(data), t(wpos), t(values),
                                          t(n_write), t(rpos), N)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    if cps == 1:
        od, og = ring_kernels.ring_pass(t(data), t(wpos[0]), t(values),
                                        t(n_write[0]), t(rpos[0]), N)
        np.testing.assert_array_equal(od.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(og.numpy(), np.asarray(jg))


def test_cpu_path_leaves_input_and_counter_alone():
    """CPU tensors take the plain version: the input ring is not
    modified and no kernel launch is counted."""
    data, wpos, values, n_write, rpos = _case(2, True)
    t = torch.as_tensor
    before = ring_kernels.ring_multi_pass.launches
    ring = t(data)
    ring_kernels.ring_multi_pass(ring, t(wpos), t(values), t(n_write),
                                 t(rpos), N)
    np.testing.assert_array_equal(ring.numpy(), data)
    assert ring_kernels.ring_multi_pass.launches == before


def test_other_devices_raise():
    """Only CPU (plain version) and CUDA (kernel) tensors are served."""
    z = torch.zeros((2, CAP), dtype=torch.int16, device="meta")
    p = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    v = torch.zeros((2, N), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no ring kernel"):
        ring_kernels.ring_multi_pass(z, p, v, p, p, N)
