"""PyTorch port's frames_step == the JAX package's (tolerance 0).

The plain version of the frames kernel (webrtc_aecm_tpu_torch/fused.py
`frames_step`, which CPU tensors take) against webrtc_aecm_tpu/fused.py
`frames_step` (pure path, jitted on the CPU) in circular far-history mode
at 16 kHz, 2 chunks (4 frames) per step, 8 streams.  The inputs of each
compared step come from the port's own serving step on the desync scene,
so the compared steps cover streams that start mid-step and, later, live
VAD, NLMS and comfort noise.  Compared: the output samples, the pending
far blocks, and every core state leaf.

The JAX answers come from tests/data/torch_golden_surface.npz (`frames.*`,
written by tools/make_torch_golden_surface.py, which ran the JAX
frames_step on the same inputs that the port's serving step gives here):
a SHA-256 of each output and core leaf, and one over the inputs, which
must equal the inputs captured here for the answer to apply.  No test here
compiles a JAX function.
"""
import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from webrtc_aecm_tpu_torch import fused as tf, fused_kernel
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_surface.npz")
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden_surface",
    os.path.join(REPO, "tools", "make_torch_golden_surface.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)    # numpy only at import: the scenes

FS, B, N_STEPS = gen.FRAMES_FS, gen.FRAMES_B, gen.FRAMES_STEPS
COMPARED = gen.COMPARED


@pytest.fixture(scope="module")
def captured():
    """Run the port's serving step over the scene, recording the inputs
    and the result of frames_step at the compared steps."""
    return gen.frames_capture()


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files if k.startswith("frames.")}


def _assert_matches_jax(golden, case, inputs, torch_result):
    """The inputs are the golden answer's, and the outputs, pending far
    blocks and every core leaf equal the JAX package's, tolerance 0."""
    p = f"frames.{case}"
    assert gen.frames_input_digest(*inputs) == str(golden[f"{p}.in_sha"]), \
        f"{case}: the inputs are not those of the JAX answer"
    core_t, out_t, pend_h, pend_q = torch_result
    got = gen.frames_outputs(core_t, out_t, pend_h, pend_q)
    names = [str(x) for x in golden["frames.names"]]
    assert [k.replace("core.", "", 1) for k, _ in got] == [
        k.replace("core.", "", 1) for k in names]
    for (name, x), want in zip(got, golden[f"{p}.sha"]):
        assert gen.digest(x) == str(want), f"{case}: {name}"


@pytest.mark.parametrize("step", COMPARED)
def test_frames_step_matches_jax(captured, golden, step):
    core_in, args, (core_t, out_t, pend_h, pend_q) = captured[step]
    (t, far, noisy, clean, phase, run_rows, mult, n_frames, has_clean,
     abs_approx, fpc, head) = args
    assert (mult, n_frames, fpc) == (2, 4, 2)
    assert clean is None and not has_clean and not abs_approx
    _assert_matches_jax(golden, f"step{step}",
                        (core_in, far, noisy, phase, run_rows, head),
                        (core_t, out_t, pend_h, pend_q))


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


def test_frames_wrapper_takes_plain_version_on_cpu(captured, monkeypatch):
    """CPU tensors go to the plain version (the CNG chain, then frames_step)
    and count no launch.  The captured core holds the seed the chain
    advanced, so the chain is made to hand back the captured phase rows and
    that seed."""
    core_in, args, (core_t, out_t, _, _) = captured[COMPARED[-1]]
    t, far, noisy, clean, phase, run_rows, *rest = args
    chained = []
    monkeypatch.setattr(tf, "_precompute_cng_phases",
                        lambda core, *a: chained.append(a) or (phase,
                                                               core.seed))
    before = fused_kernel.frames_kernel_call.launches
    core_w, out_w, _, _ = fused_kernel.frames_kernel_call(
        tf.clone_state(core_in), t, far, noisy, clean, run_rows, *rest)
    assert fused_kernel.frames_kernel_call.launches == before
    assert len(chained) == 1
    assert torch.equal(out_w, out_t)
    for (p, a), (_, b) in zip(tree_leaves_with_path(core_w),
                              tree_leaves_with_path(core_t)):
        assert torch.equal(a, b), p


# ---------------------------------------------------------------------------
# Planted cases: the semantics a lane-parallel frames kernel is most likely
# to get wrong, pinned on the plain version against the JAX package
# ---------------------------------------------------------------------------

FILLS = torch.tensor([0, 16, 32, 48, 0, 16, 32, 48], dtype=torch.int32)
PLANTED = gen.PLANTED


@pytest.mark.parametrize("name", PLANTED)
def test_frames_step_planted_case_matches_jax(captured, golden, name):
    core_in, args, _ = captured[COMPARED[-1]]
    t, far, noisy, _, phase, run_rows, mult, n_frames, _, _, fpc, _ = args
    core, far, noisy, phase, run_rows, head = gen.frames_plant(
        name, core_in, far, noisy, phase, run_rows)
    res = tf.frames_step(tf.clone_state(core), t, far, noisy, None, phase,
                         run_rows, mult, n_frames, False, False, fpc, head)
    _assert_matches_jax(golden, name,
                        (core, far, noisy, phase, run_rows, head), res)
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
