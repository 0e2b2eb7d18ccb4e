"""The PyTorch port's delay estimator, fixed path == the JAX package's.

webrtc_aecm_tpu_torch/delay_estimator.py `add_far_spectrum_fix` and
`process_fix` on a batch of estimators against `jax.vmap` of
webrtc_aecm_tpu/delay_estimator.py, block by block over a seeded sequence
of spectra in which each stream's near spectrum is its far spectrum some
blocks earlier plus noise, with a delay that jumps halfway.  Robust
validation, a per-stream runtime toggle, is off on half the streams and on
on the other half; a second case adds near-end lookahead.  Compared at
tolerance 0: every state leaf, the delay and the delay quality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu import delay_estimator as jde
from webrtc_aecm_tpu_torch import delay_estimator as tde

torch.set_num_threads(1)

B, N_BLOCKS, JUMP = 8, 240, 150


def _spectra(seed):
    """far (N, B, 65) and near (N, B, 65) uint16-range magnitudes, and
    their Q domains (N, B)."""
    rng = np.random.default_rng(seed)
    far = rng.integers(0, 20000, (N_BLOCKS + 20, B, 65))
    far[:, :, ::7] = 0
    far[40:44, 1] = 0                         # a silent far end
    blocks = np.arange(N_BLOCKS)[:, None]
    delay = np.where(blocks < JUMP, 3 + np.arange(B) % 5,
                     9 + np.arange(B) % 3)
    near = far[20 + blocks - delay, np.arange(B)[None]]
    near = (near // 2 + rng.integers(0, 3000, near.shape)).astype(np.int32)
    q_far = np.repeat(rng.integers(0, 8, (1, B)), N_BLOCKS, 0)
    q_near = q_far + 1
    q_near[JUMP:JUMP + 3] += 4                 # a Q-domain excursion
    return far[20:].astype(np.int32), near, q_far.astype(np.int32), \
        q_near.astype(np.int32)


def _jax_states(max_lookahead):
    far = jax.vmap(lambda _: jde.create_farend())(jnp.arange(B))
    near = jax.vmap(lambda _: jde.create_near(max_lookahead=max_lookahead))(
        jnp.arange(B))
    near, _ = jax.vmap(jde.enable_robust_validation)(
        near, jnp.arange(B, dtype=jnp.int32) % 2)
    if max_lookahead:
        near, _ = jax.vmap(jde.set_lookahead)(near, jnp.full(B, 1, jnp.int32))
    return far, near


def _to_torch(tree, cls):
    return cls(*[torch.as_tensor(np.asarray(x).astype(np.int64)
                                 if np.asarray(x).dtype == np.uint32
                                 else np.array(x)) for x in tree])


def _assert_equal(t_state, j_state, where):
    for f, a, b in zip(t_state._fields, t_state, j_state):
        b = np.asarray(b)
        np.testing.assert_array_equal(
            a.numpy(), b.astype(np.int64) if b.dtype == np.uint32 else b,
            err_msg=f"{where}: {f}")


@pytest.fixture(scope="module")
def jax_block():
    def block(far_st, near_st, xf, qf, xn, qn):
        far_st = jde.add_far_spectrum_fix(far_st, xf, qf)
        near_st, delay = jde.process_fix(near_st, far_st, xn, qn)
        return far_st, near_st, delay, jde.last_delay_quality(near_st)
    return jax.jit(jax.vmap(block))


@pytest.mark.parametrize("max_lookahead", [0, 2])
def test_block_sequence_matches_jax(jax_block, max_lookahead):
    far, near, q_far, q_near = _spectra(max_lookahead)
    j_far, j_near = _jax_states(max_lookahead)
    t_far = _to_torch(j_far, tde.FarendState)
    t_near = _to_torch(j_near, tde.NearState)
    delays = set()
    for k in range(N_BLOCKS):
        j_far, j_near, j_delay, j_q = jax_block(
            j_far, j_near, jnp.asarray(far[k]), jnp.asarray(q_far[k]),
            jnp.asarray(near[k]), jnp.asarray(q_near[k]))
        t_far = tde.add_far_spectrum_fix(t_far, torch.as_tensor(far[k]),
                                         torch.as_tensor(q_far[k]))
        t_near, t_delay = tde.process_fix(t_near, t_far,
                                          torch.as_tensor(near[k]),
                                          torch.as_tensor(q_near[k]))
        _assert_equal(t_far, j_far, f"block {k} far")
        _assert_equal(t_near, j_near, f"block {k} near")
        np.testing.assert_array_equal(t_delay.numpy(), np.asarray(j_delay))
        np.testing.assert_array_equal(tde.last_delay_quality(t_near).numpy(),
                                      np.asarray(j_q))
        delays.update(t_delay.tolist())
    assert len(delays) > 3        # the estimator found and moved delays


def test_creation_and_toggle_match_jax():
    j_far, j_near = _jax_states(0)
    st = tde.create_near(device="cpu")
    batch = tde.NearState(*[x.expand((B,) + x.shape).clone() for x in st])
    batch, res = tde.enable_robust_validation(
        batch, torch.arange(B, dtype=torch.int32) % 2)
    assert not res.any()
    _assert_equal(batch, j_near, "create_near + toggle")
    far = tde.create_farend(device="cpu")
    _assert_equal(tde.FarendState(*[x.expand((B,) + x.shape) for x in far]),
                  j_far, "create_farend")
    _, bad = tde.enable_robust_validation(batch, 2)
    assert (bad == -1).all()
