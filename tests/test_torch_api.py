"""The port's public entry points == the JAX package's (tolerance 0).

`api.AecmInstance` against the JAX package's `AecmInstance.run_file_pair`
at 8 kHz (robust validation, `init_echo_path`) and 16 kHz (`set_control`
with a fixed delay and the NLP off), whose answers (output, echo path,
delay quality) are in tests/data/torch_golden_envelope.npz
(tools/make_torch_golden_envelope.py); the error codes 12000-12004 and the
12100 warning; the functional re-exports, and the JAX package's
single-stream functional sequence (`create` -> `set_config` ->
`init_echo_path` -> per 10 ms `buffer_farend` and `process`) at 8 and
16 kHz against its answers in tests/data/torch_golden_reconfig.npz
(tools/make_torch_golden_reconfig.py): output, warnings, echo path and
the final state.

`AecmPipeline` checkpoints cross between the packages in both directions:
a JAX `AecmPipeline.save` file (in the golden file) loads into the port's
pipeline, on either engine, and continues as the JAX pipeline did; the
port's `save` after the same run writes the same names, dtypes and values.
No test here compiles a JAX function.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import webrtc_aecm_tpu_torch as port
from webrtc_aecm_tpu_torch import api, control
from webrtc_aecm_tpu_torch.models import AecmPipeline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_envelope.npz")
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden_envelope",
    os.path.join(REPO, "tools", "make_torch_golden_envelope.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)    # numpy only at import: the scenes


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


@pytest.mark.parametrize("name", list(gen.API))
def test_instance_matches_jax(golden, name):
    fs, n_chunks, seed, robust, delay, nlp, ep_seed = gen.API[name]
    far, near, _ = gen.scene(fs, 1, n_chunks, seed)
    inst = api.AecmInstance(fs, robust_validation=robust, device="cpu")
    if ep_seed >= 0:
        ep = np.random.default_rng(ep_seed).integers(0, 4000, 65)
        inst.init_echo_path(ep.astype(np.int16))
    inst.set_control(delay, nlp)
    out = inst.run_file_pair(far[0], near[0], 40)
    p = f"api.{name}"
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, golden[f"{p}.out"])
    np.testing.assert_array_equal(inst.get_echo_path(),
                                  golden[f"{p}.echo_path"])
    assert np.float32(inst.delay_quality()) == golden[f"{p}.delay_quality"]


def test_instance_with_a_clean_input_matches_the_batch_engine():
    """process() with a clean near input and 160-sample calls at 8 kHz ==
    the batch-major engine it wraps, stream by stream."""
    far, near, clean = gen.scene(8000, 2, 10, seed=5, with_clean=True)
    inst = api.AecmInstance(8000, abs_approx=True, device="cpu")
    st = port.parallel.batch.create_batch(2, 8000, device="cpu")
    opts = port.core.Options(abs_approx=True)
    for c in range(5):
        s = slice(160 * c, 160 * (c + 1))
        inst.buffer_farend(far[0, s][:80])
        inst.buffer_farend(far[0, s][80:])
        out, warn = inst.process(near[0, s], clean[0, s], 40)
        for h in (slice(0, 80), slice(80, 160)):
            st = control.buffer_farend(
                st, torch.as_tensor(far[:, s][:, h]).int(), 1)
        st, ref, _ = control.process(st, torch.as_tensor(near[:, s]).int(),
                                     torch.as_tensor(clean[:, s]).int(), 160,
                                     40, 8000, opts)
        np.testing.assert_array_equal(out, ref[0].numpy().astype(np.int16))
        assert warn == 0


@pytest.mark.parametrize("case", [
    "rate", "cng_mode", "echo_mode", "echo_path_size", "farend_none",
    "farend_length", "near_none", "near_length"])
def test_error_codes(case):
    """The reference's codes: 12003 for a missing buffer, 12004 for a bad
    parameter (echo_control_mobile.h:23-30)."""
    if case == "rate":
        with pytest.raises(api.AecmError) as e:
            api.AecmInstance(32000, device="cpu")
        assert e.value.code == 12004
        return
    inst = api.AecmInstance(16000, device="cpu")
    x = np.zeros(160, np.int16)
    calls = {
        "cng_mode": (lambda: inst.set_config(2, 3), 12004),
        "echo_mode": (lambda: inst.set_config(1, 5), 12004),
        "echo_path_size": (lambda: inst.init_echo_path(np.zeros(64)), 12004),
        "farend_none": (lambda: inst.buffer_farend(None), 12003),
        "farend_length": (lambda: inst.buffer_farend(x[:100]), 12004),
        "near_none": (lambda: inst.process(None, None, 40), 12003),
        "near_length": (lambda: inst.process(x[:81], None, 40), 12004),
    }
    fn, code = calls[case]
    with pytest.raises(api.AecmError) as e:
        fn()
    assert e.value.code == code
    if case.startswith("farend"):
        arg = None if case == "farend_none" else x[:100]
        assert inst.get_buffer_farend_error(arg) == code


def test_error_code_values_and_reexports():
    assert (api.AECM_UNSPECIFIED_ERROR, api.AECM_UNSUPPORTED_FUNCTION_ERROR,
            api.AECM_UNINITIALIZED_ERROR, api.AECM_NULL_POINTER_ERROR,
            api.AECM_BAD_PARAMETER_ERROR, api.AECM_BAD_PARAMETER_WARNING) == (
        12000, 12001, 12002, 12003, 12004, 12100)
    assert api.echo_path_size_bytes() == 130
    assert (api.create, api.buffer_farend, api.process, api.set_config,
            api.get_echo_path, api.init_echo_path, api.AecmState) == (
        control.create, control.buffer_farend, control.process,
        control.set_config, control.get_echo_path, control.init_echo_path,
        control.AecmState)
    assert port.AecmInstance is api.AecmInstance
    assert port.AecmPipeline is AecmPipeline
    assert port.AecmState is control.AecmState
    assert api.AecmInstance(8000, device="cpu").get_buffer_farend_error(
        np.zeros(80)) == 0


_spec_r = importlib.util.spec_from_file_location(
    "make_torch_golden_reconfig",
    os.path.join(REPO, "tools", "make_torch_golden_reconfig.py"))
rgen = importlib.util.module_from_spec(_spec_r)
_spec_r.loader.exec_module(rgen)


@pytest.mark.parametrize("fs", list(rgen.FN))
def test_functional_sequence_matches_jax(fs):
    """One stream's state from api.create, in and out of the functional
    calls as in the JAX package: out (n,) and a 0-d warning per call."""
    from webrtc_aecm_tpu_torch import convert
    from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
    n_chunks, _, echo_mode, _ = rgen.FN[fs]
    far, near, ms, ep = rgen.fn_inputs(fs)
    n = min(160, fs // 100)
    s = api.create(fs, device="cpu")
    assert s.ec_startup.shape == () and s.farend_buf.data.shape == (4000,)
    s = api.set_config(s, 1, echo_mode)
    s = api.init_echo_path(s, torch.as_tensor(ep))
    outs, warns = [], []
    for c in range(n_chunks):
        cols = slice(c * n, (c + 1) * n)
        s = api.buffer_farend(s, far[cols], fs // 8000)
        s, out, warn = api.process(s, near[cols], None, n, int(ms[c]), fs)
        assert out.shape == (n,) and warn.shape == ()
        outs.append(out)
        warns.append(warn)
    with np.load(os.path.join(REPO, "tests", "data",
                              "torch_golden_reconfig.npz")) as g:
        p = f"fn.{fs}"
        np.testing.assert_array_equal(torch.stack(outs).numpy(),
                                      g[f"{p}.out"].astype(np.int32))
        np.testing.assert_array_equal(torch.stack(warns).numpy(),
                                      g[f"{p}.warn"])
        assert set(g[f"{p}.warn"].tolist()) == {
            0, api.AECM_BAD_PARAMETER_WARNING}
        np.testing.assert_array_equal(api.get_echo_path(s).numpy(),
                                      g[f"{p}.echo_path"].astype(np.int32))
        for path, a in tree_leaves_with_path(convert.aecm_state_to_numpy(s)):
            b = g[f"{p}.state.{path}"]
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)


def test_process_warns_on_a_bad_delay():
    inst = api.AecmInstance(8000, device="cpu")
    inst.buffer_farend(np.zeros(80, np.int16))
    _, warn = inst.process(np.zeros(80, np.int16), None, 600)
    assert warn == 12100


def test_process_debug_raises():
    """process(debug=True) no longer raises: it returns the output, the
    warning and the taps (numpy, (n_frames, 2, ...)), and the output and
    state are those of the same call without the taps (the taps' values
    are held to the JAX package in tests/test_torch_debug.py)."""
    inst = api.AecmInstance(8000, device="cpu")
    plain = api.AecmInstance(8000, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(8):
        far = rng.integers(-3000, 3000, 80).astype(np.int16)
        near = rng.integers(-3000, 3000, 80).astype(np.int16)
        inst.buffer_farend(far)
        plain.buffer_farend(far)
        out, warn, taps = inst.process(near, None, 40, debug=True)
        want, want_warn = plain.process(near, None, 40)
        np.testing.assert_array_equal(out, want)
        assert warn == want_warn
        assert taps["hnl_q14"].shape == (1, 2, 65)
        assert isinstance(taps["delay_quality"], np.ndarray)


@pytest.mark.parametrize("make", [
    lambda: api.AecmInstance(8000),
    lambda: AecmPipeline(2, 8000),
], ids=["AecmInstance", "AecmPipeline"])
def test_no_card_and_no_device_raises(monkeypatch, make):
    """Left to their defaults the entry points build on the CUDA card and
    raise without one: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_pipeline_engine_argument():
    assert AecmPipeline(2, 8000, device="cpu").engine == "xla"
    with pytest.raises(ValueError, match="engine"):
        AecmPipeline(2, 8000, engine="mesh", device="cpu")
    with pytest.raises(ValueError, match="sample_rate"):
        AecmPipeline(2, 32000, device="cpu")


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _ckpt_scene():
    c = gen.CKPT
    far, near, _ = gen.scene(c["fs"], c["n_streams"],
                             c["n_first"] + c["n_next"], c["seed"])
    return c, c["n_first"] * (c["fs"] // 100), far, near


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_jax_checkpoint_loads_and_continues(golden, tmp_path, engine):
    c, at, far, near = _ckpt_scene()
    path = str(tmp_path / "jax_ck.npz")
    np.savez(path, **{k[len("ckpt.file."):]: v for k, v in golden.items()
                      if k.startswith("ckpt.file.")})
    pipe = AecmPipeline(c["n_streams"], c["fs"], engine=engine, device="cpu")
    pipe.load(path)
    out = pipe.run(far[:, at:], near[:, at:])
    np.testing.assert_array_equal(out.numpy(),
                                  golden["ckpt.next_out"].astype(np.int32))


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_save_writes_the_jax_checkpoint(golden, tmp_path, engine):
    c, at, far, near = _ckpt_scene()
    pipe = AecmPipeline(c["n_streams"], c["fs"], engine=engine, device="cpu")
    pipe.run(far[:, :at], near[:, :at])
    path = str(tmp_path / "port_ck.npz")
    pipe.save(path)
    want = {k[len("ckpt.file."):]: v for k, v in golden.items()
            if k.startswith("ckpt.file.")}
    with np.load(path) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_refuses_another_pipeline(golden, tmp_path):
    path = str(tmp_path / "jax_ck.npz")
    np.savez(path, **{k[len("ckpt.file."):]: v for k, v in golden.items()
                      if k.startswith("ckpt.file.")})
    with pytest.raises(ValueError, match="streams"):
        AecmPipeline(3, 16000, device="cpu").load(path)
