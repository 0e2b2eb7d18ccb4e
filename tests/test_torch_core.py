"""The PyTorch port's batch-major core == the JAX package's (tolerance 0).

webrtc_aecm_tpu_torch/core.py `process_frame` on a batch of 8 streams
against `jax.jit(jax.vmap(...))` of webrtc_aecm_tpu/core.py's
`process_frame`, frame by frame, at 16 kHz with a single near input and at
8 kHz with a clean near input.  The frames start from the final core state
of the golden file's run (tests/data/torch_golden_batch.npz), so VAD,
NLMS, the delay estimator and comfort noise are live; per-stream controls
vary (a fixed delay inside and outside the history, NLP off, CNG off) and
the run mask holds some streams back.  Compared: the output and every core
leaf after each frame.  Also: the magnitude approximation of
`time_to_frequency_domain` (abs_approx).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu import core as jcore
from webrtc_aecm_tpu_torch import convert, core as tcore
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path

torch.set_num_threads(1)

B, N_FRAMES = 8, 4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_batch.npz")


class _Tree:
    """Attribute access over the golden file's dotted state paths."""

    def __init__(self, g, prefix):
        self._g, self._p = g, prefix

    def __getattr__(self, name):
        key = self._p + name
        return (self._g[key] if key in self._g.files
                else _Tree(self._g, key + "."))


def _start(name):
    """(JAX core state, port core state) from a golden final state, with
    per-stream controls set."""
    g = np.load(GOLDEN)
    port = convert.aecm_state_from_numpy(_Tree(g, f"{name}.state."),
                                         device="cpu").core
    port = tcore.set_control(
        port, torch.tensor([-1, -1, 5, 120, -1, 0, -1, 99]),
        torch.tensor([1, 1, 1, 1, 0, 1, 1, 0]))
    port = port._replace(cng_mode=torch.tensor([1, 1, 1, 0, 1, 1, 0, 1],
                                               dtype=torch.int32))
    leaves = [jnp.asarray(x.numpy().astype(np.uint32) if p in (
        "seed", "de_farend.binary_history", "de_near.binary_history")
        else x.numpy().astype(np.uint16) if p == "far_history"
        else x.numpy()) for p, x in tree_leaves_with_path(port)]
    ref = jax.tree_util.tree_structure(
        jax.vmap(lambda _: jcore.create_core(8000))(jnp.arange(B)))
    return jax.tree_util.tree_unflatten(ref, leaves), port


def _assert_core_equal(t_core, j_core, where):
    for (path, a), b in zip(tree_leaves_with_path(t_core),
                            jax.tree_util.tree_leaves(j_core)):
        b = np.asarray(b)
        np.testing.assert_array_equal(
            a.numpy(), b.astype(a.numpy().dtype), err_msg=f"{where}: {path}")
        assert a.shape == b.shape, path


@pytest.mark.parametrize("name,mult,has_clean", [("16k", 2, False),
                                                 ("8k_clean", 1, True)])
def test_process_frame_matches_jax(name, mult, has_clean):
    j_core, t_core = _start(name)
    fn = jax.jit(jax.vmap(functools.partial(jcore.process_frame,
                                            mult=mult)))
    rng = np.random.default_rng(mult)
    run_mask = np.ones(B, bool)
    for k in range(N_FRAMES):
        far = rng.integers(-20000, 20000, (B, 80)).astype(np.int32)
        noisy = (far // 3 + rng.integers(-500, 500, (B, 80))).astype(
            np.int32)
        clean = (rng.integers(-300, 300, (B, 80)).astype(np.int32)
                 if has_clean else None)
        run_mask[k % B] = k % 2 == 0    # hold some streams back
        j_core, j_out = fn(j_core, jnp.asarray(far), jnp.asarray(noisy),
                           None if clean is None else jnp.asarray(clean),
                           run_mask=jnp.asarray(run_mask))
        t_core, t_out = tcore.process_frame(
            t_core, torch.as_tensor(far), torch.as_tensor(noisy),
            None if clean is None else torch.as_tensor(clean), mult=mult,
            run_mask=torch.as_tensor(run_mask))
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out),
                                      err_msg=f"frame {k}: out")
        _assert_core_equal(t_core, j_core, f"frame {k}")
    assert int(t_core.current_vad_value.sum()) > 0


def test_abs_approx_magnitudes_match_jax():
    rng = np.random.default_rng(7)
    x = rng.integers(-32768, 32768, (16, 128)).astype(np.int32)
    x[1] //= 1000
    x[2] = 0
    want = jax.jit(jax.vmap(functools.partial(
        jcore.time_to_frequency_domain, abs_approx=True)))(jnp.asarray(x))
    got = tcore.time_to_frequency_domain(torch.as_tensor(x), abs_approx=True)
    q, (re, im), mag, mag_sum = got
    for g, w in ((q[:, 0], want[0]), (re, want[1][0]), (im, want[1][1]),
                 (mag, want[2]), (mag_sum[:, 0], want[3])):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def test_debug_option_raises():
    """Options(debug=True) no longer raises in process_frame: it adds the
    taps of both block slots, (B, 2, ...), and leaves the output and state
    as they are without it (the taps' values are held to the JAX package
    in tests/test_torch_debug.py)."""
    _, t_core = _start("16k")
    x = torch.full((B, 80), 1000, dtype=torch.int32)
    core_d, out_d, taps = tcore.process_frame(
        t_core, x, x, mult=2, opts=tcore.Options(debug=True))
    core_p, out_p = tcore.process_frame(t_core, x, x, mult=2)
    assert torch.equal(out_d, out_p)
    assert taps["hnl_q14"].shape == (B, 2, 65)
    assert taps["mu"].shape == (B, 2)
    for (path, a), (_, b) in zip(tree_leaves_with_path(core_d),
                                 tree_leaves_with_path(core_p)):
        assert torch.equal(a, b), path
