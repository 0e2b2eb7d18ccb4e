"""PyTorch port's frames_step == the JAX package's (tolerance 0).

The plain version of the frames kernel (webrtc_aecm_tpu_torch/fused.py
`frames_step`, which CPU tensors take) against webrtc_aecm_tpu/fused.py
`frames_step` (pure path, jitted on the CPU) in circular far-history mode
at 16 kHz, 2 chunks (4 frames) per step, 8 streams.  The inputs of each
compared step come from the port's own serving step on the desync scene,
so the compared steps cover streams that start mid-step and, later, live
VAD, NLMS and comfort noise.  Compared: the output samples, the pending
far blocks, and every core state leaf.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu import fused as jf
from webrtc_aecm_tpu_torch import fused as tf, fused_kernel
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path

torch.set_num_threads(1)

FS, B, N_STEPS = 16000, 8, 20
COMPARED = (1, 3, 5, 9, 14, 19)


def _scene():
    """Desync scene (40-sample offsets per stream, per-(chunk, stream)
    sound-card delays, delay burst at chunk 24)."""
    n_chunks = 2 * N_STEPS
    n = n_chunks * 160
    rng = np.random.default_rng(0)
    t = np.arange(n + 640)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (FS // 3))
    ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far = np.stack([ff[640 - 40 * b:640 - 40 * b + n]
                    for b in range(B)]).astype(np.int16)
    near = (0.4 * far + rng.normal(0, 150, far.shape)
            ).clip(-32000, 32000).astype(np.int16)
    ms = np.full((n_chunks, B), 40, np.int32)
    ms += 15 * (np.arange(B, dtype=np.int32) % 5)[None, :]
    ms[24:30] += 80
    ms[:20] += 23 * (np.arange(B, dtype=np.int32) % 7)[None, :]
    return far, near, ms


@pytest.fixture(scope="module")
def captured(monkeypatch_module):
    """Run the port's serving step over the scene, recording the inputs
    and the result of frames_step at the compared steps."""
    far, near, ms = _scene()
    records = {}
    orig = tf.frames_step
    step_no = [0]

    def recording(core, *args):
        res = orig(core, *args)
        if step_no[0] in COMPARED:
            # copies: the serving step appends to far_history in place
            records[step_no[0]] = (tf.clone_state(core), args,
                                   (tf.clone_state(res[0]),) + res[1:])
        step_no[0] += 1
        return res

    monkeypatch_module.setattr(tf, "frames_step", recording)
    step = tf.FusedAecm(FS, 2, use_kernel=False, device="cpu")
    st = tf.create_fused(B, FS, device="cpu")
    st = st._replace(core=tf._to_circular_far(st.core))
    head = 0
    for s in range(N_STEPS):
        lo = s * 320
        st, head, _, _ = step(st, head,
                              torch.as_tensor(far[:, lo:lo + 320]).int(),
                              torch.as_tensor(near[:, lo:lo + 320]).int().T,
                              torch.as_tensor(ms[2 * s:2 * s + 2]))
    return records


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def jax_frames_step():
    core_def = jax.tree_util.tree_structure(jf.create_fused(B, FS).core)
    run = jax.jit(functools.partial(
        jf.frames_step, mult=2, n_frames=4, has_clean=False,
        abs_approx=False, frames_per_chunk=2))
    tables = jf.make_tables()

    def call(core_t, far, noisy, phase, run_rows, head):
        leaves = [jnp.asarray(x.numpy().astype(np.uint32)
                              if p in ("seed", "de_farend.binary_history",
                                       "de_near.binary_history")
                              else x.numpy())
                  for p, x in tree_leaves_with_path(core_t)]
        core_j = jax.tree_util.tree_unflatten(core_def, leaves)
        head_row = jnp.full((1, B), head, jnp.int32)
        return run(core_j, tables, jnp.asarray(far.numpy()),
                   jnp.asarray(noisy.numpy()), None,
                   jnp.asarray(phase.numpy()), jnp.asarray(run_rows.numpy()),
                   far_head=head_row)
    return call


@pytest.mark.parametrize("step", COMPARED)
def test_frames_step_matches_jax(captured, jax_frames_step, step):
    core_in, args, (core_t, out_t, pend_h, pend_q) = captured[step]
    (t, far, noisy, clean, phase, run_rows, mult, n_frames, has_clean,
     abs_approx, fpc, head) = args
    assert (mult, n_frames, fpc) == (2, 4, 2)
    assert clean is None and not has_clean and not abs_approx
    _assert_matches_jax((core_t, out_t, pend_h, pend_q), jax_frames_step(
        core_in, far, noisy, phase, run_rows, head))


def _assert_matches_jax(torch_result, jax_result):
    """Outputs, pending far blocks and every core leaf, tolerance 0."""
    core_t, out_t, pend_h, pend_q = torch_result
    core_j, out_j, ph_j, pq_j = jax_result
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(pend_h.numpy(), np.asarray(ph_j))
    np.testing.assert_array_equal(pend_q.numpy(), np.asarray(pq_j))
    for (path, a), b in zip(tree_leaves_with_path(core_t),
                            jax.tree_util.tree_leaves(core_j)):
        np.testing.assert_array_equal(
            a.numpy().astype(np.int64) if a.dtype == torch.int64
            else a.numpy(), np.asarray(b).astype(np.int64)
            if a.dtype == torch.int64 else np.asarray(b),
            err_msg=f"core leaf {path}")


def test_compared_steps_cover_startup_and_live_core(captured):
    """The compared steps include a step where some streams start
    mid-step (mixed run rows) and steps with VAD firing and comfort
    noise on."""
    mixed = any(bool((r[1][5].any(0) & ~r[1][5].all(0)).any())
                for r in captured.values())
    assert mixed
    last_core = captured[COMPARED[-1]][2][0]
    assert int(last_core.current_vad_value.sum()) > 0
    assert int(last_core.cng_mode.min()) == 1
    first_core = captured[COMPARED[0]][0]
    assert not torch.equal(last_core.noise_est, first_core.noise_est)


def test_kernel_leaf_order_matches_core_state():
    """csrc/frames.cu takes the core leaves as a pointer array in the order
    of the `enum Leaf` of csrc/frames.cuh; that must be the CoreState field order the wrapper
    passes (nested estimator tuples flattened, FE_/NE_ prefixed)."""
    src = (Path(tf.__file__).parent / "csrc" / "frames.cuh").read_text()
    body = re.search(r"enum Leaf \{(.*?)N_LEAVES", src, re.S).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    core = tf.create_fused(2, FS, device="cpu").core
    paths = [p.replace("de_farend.", "fe_").replace("de_near.", "ne_").upper()
             for p, _ in fused_kernel._core_leaves(core)]
    assert names == paths


def test_frames_wrapper_takes_plain_version_on_cpu(captured):
    """CPU tensors go to the plain frames_step and count no launch."""
    core_in, args, (core_t, out_t, _, _) = captured[COMPARED[-1]]
    before = fused_kernel.frames_kernel_call.launches
    core_w, out_w, _, _ = fused_kernel.frames_kernel_call(
        tf.clone_state(core_in), *args)
    assert fused_kernel.frames_kernel_call.launches == before
    assert torch.equal(out_w, out_t)
    for (p, a), (_, b) in zip(tree_leaves_with_path(core_w),
                              tree_leaves_with_path(core_t)):
        assert torch.equal(a, b), p


# ---------------------------------------------------------------------------
# Planted cases: the semantics a lane-parallel frames kernel is most likely
# to get wrong, pinned on the plain version against the JAX package
# ---------------------------------------------------------------------------

FILLS = torch.tensor([0, 16, 32, 48, 0, 16, 32, 48], dtype=torch.int32)


def _plant(name, core, far, noisy, phase, run_rows):
    """Plants case `name` into copies of a warm captured call (all 8
    streams); returns the new arguments and the circular head to use."""
    core = tf.clone_state(core)
    run_rows = run_rows.clone()
    head = 20
    near = core.de_near
    if name == "two_equal_minima":
        # far-end rows sliding past rows 17 and 60 during the 5 blocks are
        # empty, so the two planted valleys stay equal
        for r in (17, 60):
            near.mean_bit_counts[r] = 0
            core.de_farend.bit_counts[r - 5:r] = 0
            core.de_farend.binary_history[r - 5:r] = 0
    elif name == "no_candidate_under_the_limit":
        near.mean_bit_counts[:] = 20000           # > 32 << 9, every row
    elif name == "fresh_estimator_all_equal":
        fresh = tf.create_fused(B, FS, device="cpu").core
        core = core._replace(de_near=fresh.de_near,
                             de_farend=fresh.de_farend)
    elif name.startswith("run_rows_"):
        rows = {"run_rows_none": [0, 0, 0, 0],
                "run_rows_last_two": [0, 0, 1, 1],
                "run_rows_all_four": [1, 1, 1, 1]}[name]
        run_rows[:] = torch.tensor(rows, dtype=torch.bool)[:, None]
        core.frame_fill[0] = FILLS
        core.out_fill[0] = 48 - FILLS
        core.out_fill[0, 4:] = 0                  # still zero-stuffing
    elif name == "delay_across_the_head_wrap":
        head = 95
        core.fixed_delay[0] = torch.tensor([0, 4, 5, 50, 94, 97, 99, -1],
                                           dtype=torch.int32)
    else:
        raise ValueError(name)
    return core, far, noisy, phase, run_rows, head


PLANTED = ("two_equal_minima", "no_candidate_under_the_limit",
           "fresh_estimator_all_equal", "run_rows_none",
           "run_rows_last_two", "run_rows_all_four",
           "delay_across_the_head_wrap")


@pytest.mark.parametrize("name", PLANTED)
def test_frames_step_planted_case_matches_jax(captured, jax_frames_step,
                                              name):
    core_in, args, _ = captured[COMPARED[-1]]
    t, far, noisy, _, phase, run_rows, mult, n_frames, _, _, fpc, _ = args
    core, far, noisy, phase, run_rows, head = _plant(
        name, core_in, far, noisy, phase, run_rows)
    res = tf.frames_step(tf.clone_state(core), t, far, noisy, None, phase,
                         run_rows, mult, n_frames, False, False, fpc, head)
    _assert_matches_jax(res, jax_frames_step(core, far, noisy, phase,
                                             run_rows, head))
    new = res[0]
    if name == "two_equal_minima":
        # the far end is live, so the search ran: the lower of the two
        # equal valleys is the candidate
        assert int(core_in.de_farend.bit_counts.sum()) > 0
        assert new.de_near.last_candidate_delay[0].tolist() == [17] * B
    elif name == "no_candidate_under_the_limit":
        assert new.de_near.last_candidate_delay[0].tolist() == [-1] * B
    elif name == "run_rows_none":
        for (path, a), (_, b) in zip(tree_leaves_with_path(new),
                                     tree_leaves_with_path(core)):
            assert torch.equal(a, b), path
        assert res[2].abs().sum() > 0             # pending blocks all the same
    elif name == "run_rows_last_two":
        assert new.frame_fill[0].tolist() == ((FILLS + 32) & 63).tolist()
