"""The port's debug taps == the JAX package's (tolerance 0), on the CPU.

`AecmInstance.process(..., debug=True)` call by call against the JAX
package's answers in tests/data/torch_golden_surface.npz (`dbg.*`, written
by tools/make_torch_golden_surface.py): outputs, warnings and every tap
(hnl, suppression gain, step size, delay, VAD, log energies, delay quality)
at 8 kHz, 16 kHz and 16 kHz with a clean input, past the startup and until
the delay estimator has an estimate.  The asserts of
tests/test_options.py::test_debug_taps, and `Options(debug=True)` through
`control.process` and `core.process_frame` on a batch of two streams.  No
test here compiles a JAX function.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from webrtc_aecm_tpu_torch import AecmInstance, control, core
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
from webrtc_aecm_tpu_torch.parallel import batch as pbatch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_surface.npz")
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden_surface",
    os.path.join(REPO, "tools", "make_torch_golden_surface.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)    # numpy only at import: the scenes

TAPS = ("hnl_q14", "sup_gain_q8", "mu", "delay_blocks", "vad_far",
        "near_log_energy_q8", "echo_stored_log_energy_q8", "delay_quality")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files if k.startswith("dbg.")}


def _assert_call(golden, name, c, out, warn, taps):
    p = f"dbg.{name}"
    np.testing.assert_array_equal(out, golden[f"{p}.out"][c],
                                  err_msg=f"{name} call {c}: out")
    assert warn == golden[f"{p}.warn"][c], f"{name} call {c}: warn"
    assert set(taps) == set(TAPS)
    for k in TAPS:
        want = golden[f"{p}.tap.{k}"][c]
        assert taps[k].dtype == want.dtype, k
        np.testing.assert_array_equal(taps[k], want,
                                      err_msg=f"{name} call {c}: {k}")


@pytest.mark.parametrize("name", ["8k", "16k", "16k_clean"])
def test_instance_debug_taps_match_jax(golden, name):
    fs, calls, _, _, _ = gen.DBG[name]
    far, near, clean, ms = gen.dbg_inputs(name)
    n = fs // 100
    inst = AecmInstance(fs, device="cpu")
    for c in range(calls):
        cols = slice(c * n, (c + 1) * n)
        inst.buffer_farend(far[cols])
        out, warn, taps = inst.process(
            near[cols], None if clean is None else clean[cols], int(ms[c]),
            debug=True)
        _assert_call(golden, name, c, out, warn, taps)
    # the sequence left the startup and reached a delay estimate
    assert int(inst.state.ec_startup[0]) == 0
    assert taps["delay_blocks"].max() > 0


def test_debug_taps_shapes_and_ranges(golden):
    """tests/test_options.py::test_debug_taps's asserts, on the last call
    of the 8 kHz sequence (its values are held to the golden file above)."""
    taps = {k: golden[f"dbg.8k.tap.{k}"][-1] for k in TAPS}
    assert set(taps) >= {"hnl_q14", "sup_gain_q8", "mu", "delay_blocks",
                         "vad_far", "delay_quality"}
    assert taps["hnl_q14"].shape == (1, 2, 65)
    assert taps["hnl_q14"].min() >= 0 and taps["hnl_q14"].max() <= 16384
    assert 0.0 <= float(taps["delay_quality"][0, 0]) <= 1.0
    assert taps["delay_blocks"].min() >= 0
    all_hnl = golden["dbg.8k.tap.hnl_q14"]
    assert all_hnl.min() >= 0 and all_hnl.max() <= 16384
    q = golden["dbg.16k.tap.delay_quality"]
    assert q.dtype == np.float32 and (q >= 0).all() and (q <= 1).all()


def test_batch_of_two_debug_taps_match_jax(golden):
    """control.process on a batch of two 8 kHz streams (the `8k` and
    `8k_b` sequences side by side): outputs (B, 80), warnings (B,) and taps
    (B, 1, 2, ...), each stream == its single-stream JAX sequence."""
    names = ("8k", "8k_b")
    fs, calls = gen.DBG["8k"][:2]
    inputs = [gen.dbg_inputs(k) for k in names]
    far = torch.as_tensor(np.stack([x[0] for x in inputs])).int()
    near = torch.as_tensor(np.stack([x[1] for x in inputs])).int()
    ms = np.stack([x[3] for x in inputs], axis=1)
    st = pbatch.create_batch(2, fs, device="cpu")
    opts = core.Options(debug=True)
    for c in range(calls):
        cols = slice(c * 80, (c + 1) * 80)
        st = control.buffer_farend(st, far[:, cols])
        st, out, warn, taps = control.process(
            st, near[:, cols], None, 80, torch.as_tensor(ms[c]), fs, opts)
        assert out.shape == (2, 80) and warn.shape == (2,)
        assert taps["hnl_q14"].shape == (2, 1, 2, 65)
        for b, name in enumerate(names):
            _assert_call(golden, name, c, out[b].numpy(), int(warn[b]),
                         {k: v[b].numpy() for k, v in taps.items()})


def test_process_frame_debug_on_a_batch():
    """core.process_frame with Options(debug=True) on a batch of two
    streams: the taps of both block slots, (B, 2, ...), and the same output
    and state as without the taps."""
    rng = np.random.default_rng(5)
    st = pbatch.create_batch(2, 16000, device="cpu").core
    st_plain = st
    for k in range(6):
        far = torch.as_tensor(rng.integers(-8000, 8000, (2, 80))).int()
        near = torch.as_tensor(rng.integers(-8000, 8000, (2, 80))).int()
        st, out, taps = core.process_frame(st, far, near, mult=2,
                                           opts=core.Options(debug=True))
        st_plain, out_plain = core.process_frame(st_plain, far, near,
                                                 mult=2)
        assert torch.equal(out, out_plain)
        assert set(taps) == set(TAPS)
        assert taps["hnl_q14"].shape == (2, 2, 65)
        for name in TAPS[1:]:
            assert taps[name].shape == (2, 2), name
        assert taps["delay_quality"].dtype == torch.float32
    for (path, a), (_, b) in zip(tree_leaves_with_path(st),
                                 tree_leaves_with_path(st_plain)):
        assert torch.equal(a, b), path
