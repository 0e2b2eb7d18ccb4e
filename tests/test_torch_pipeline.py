"""The PyTorch port's serving slice == the JAX package's (tolerance 0).

The whole fused 16 kHz path: `create_fused`, and `run_streams_fused` (the
port's plain path on the CPU) against the JAX package's pure path on
bench.py's scene and on the desync scene -- 8 streams, 40 chunks of 10 ms,
per-(chunk, stream) sound-card delays with a burst at chunk 24, and every
fourth stream held in startup until its ring writes clamp -- for the output
samples and every leaf of the final state.  The JAX package's answers come
from the committed golden files, made from it by tools/make_torch_golden.py
(the desync scene, torch_golden_16k.npz) and
tools/make_torch_golden_envelope.py (bench.py's scene, under
`rsf.bench16k` in torch_golden_envelope.npz); chip_smoke.py holds the GPU
to them.  State moves between the packages only through
webrtc_aecm_tpu_torch.convert.  The configurations the port once refused
(wide steps, a clean input, lookahead capacity 4) are held to
tests/data/torch_golden_reconfig.npz (tools/make_torch_golden_reconfig.py).
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu import fused as jf
from webrtc_aecm_tpu_torch import convert, fused as tf
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
from webrtc_aecm_tpu_torch.ops import ring_kernels

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_16k.npz")
GOLDEN_ENVELOPE = os.path.join(REPO, "tests", "data",
                               "torch_golden_envelope.npz")
FS, B, N_CHUNKS = 16000, 8, 40


def _scene():
    n = N_CHUNKS * 160
    rng = np.random.default_rng(0)
    t = np.arange(n + 640)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (FS // 3))
    ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far = np.stack([ff[640 - 40 * b:640 - 40 * b + n]
                    for b in range(B)]).astype(np.int16)
    near = (0.4 * far + rng.normal(0, 150, far.shape)
            ).clip(-32000, 32000).astype(np.int16)
    ms = np.full((N_CHUNKS, B), 40, np.int32)
    ms += 15 * (np.arange(B, dtype=np.int32) % 5)[None, :]
    ms[24:30] += 80
    ms[:20] += 23 * (np.arange(B, dtype=np.int32) % 7)[None, :]
    # every fourth stream's delay alternates by 120 ms: it stays in startup
    # while its ring fills, so its jitter-ring writes clamp
    ms[:, 3::4] += 120 * (np.arange(N_CHUNKS) % 2)[:, None]
    return far, near, ms


def _bench_scene():
    """bench.py's scene (bench.py:55-68): one modulated far signal and its
    attenuated echo plus noise, the same for every stream, ms = 40."""
    n = N_CHUNKS * 160
    rng = np.random.default_rng(0)
    t = np.arange(n + 160)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (FS // 3))
    far_full = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far1 = far_full[160:].astype(np.int16)
    near1 = (0.4 * far_full[:n] + rng.normal(0, 200, n)
             ).clip(-32000, 32000).astype(np.int16)
    return (np.repeat(far1[None], B, 0), np.repeat(near1[None], B, 0),
            np.full((N_CHUNKS, B), 40, np.int32))


def _np_leaves(state):
    return tree_leaves_with_path(convert.fused_state_to_numpy(state))


def _golden_answer(path, prefix):
    """(final state as a tree of the JAX package's numpy leaves, out) of a
    golden file's run: `prefix` + "out" and `prefix` + "state.<path>"."""
    with np.load(path) as g:
        def build(tree, at):
            if isinstance(tree, tuple) and hasattr(tree, "_fields"):
                return SimpleNamespace(**{
                    f: build(getattr(tree, f), f"{at}{f}.")
                    for f in tree._fields})
            return g[f"{prefix}state.{at[:-1]}"]
        state = build(tf.create_fused(1, FS, device="cpu"), "")
        return state, g[prefix + "out"].astype(np.int32)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's pure fused path on the desync scene: its answer
    in the golden file (tools/make_torch_golden.py ran it on this scene:
    test_golden_file_is_this_scene_and_the_ports_answer)."""
    return _golden_answer(GOLDEN, "")


@pytest.fixture(scope="module")
def port_run():
    """The port's run, recording each step's jitter-ring write counts."""
    far, near, ms = _scene()
    n_writes = []
    orig = ring_kernels.ring_multi_pass

    def recording(data, wpos, values, n_write, rpos, n_read):
        n_writes.append(n_write.clone())
        return orig(data, wpos, values, n_write, rpos, n_read)

    mp = pytest.MonkeyPatch()
    mp.setattr(ring_kernels, "ring_multi_pass", recording)
    try:
        fin, out = tf.run_streams_fused(tf.create_fused(B, FS, device="cpu"),
                                        far, near, FS, ms)
    finally:
        mp.undo()
    return fin, out.numpy(), n_writes


@pytest.mark.parametrize("fs", [8000, 16000])
def test_create_fused_matches_jax(fs):
    want = convert.fused_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jf.create_fused(B, fs)),
        device="cpu")
    got = tf.create_fused(B, fs, device="cpu")
    for (path, a), (_, b) in zip(_np_leaves(got), _np_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_convert_round_trip_keeps_jax_leaves():
    """JAX state -> port -> numpy gives back every JAX leaf, dtype and
    all (uint32 leaves travel as int64 carriers)."""
    jst = jax.tree_util.tree_map(np.asarray, jf.create_fused(B, FS))
    back = convert.fused_state_to_numpy(
        convert.fused_state_from_numpy(jst, device="cpu"))
    jl = jax.tree_util.tree_leaves(jst)
    bl = [x for _, x in tree_leaves_with_path(back)]
    assert len(jl) == len(bl)
    for a, b in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_from_fused_state_matches_jax():
    """The fused -> batch-leading layout conversion (far history unpacked
    to 65 bins; the port keeps it int32 where JAX has uint16)."""
    jst = jf.from_fused_state(jf.create_fused(B, FS))
    got = tf.from_fused_state(tf.create_fused(B, FS, device="cpu"))
    jl = jax.tree_util.tree_leaves(jst)
    tl = [x for _, x in tree_leaves_with_path(got)]
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(b).astype(np.int64))


def test_run_streams_fused_outputs_match_jax(jax_run, port_run):
    np.testing.assert_array_equal(port_run[1], jax_run[1])


def test_run_streams_fused_state_matches_jax(jax_run, port_run):
    want = convert.fused_state_from_numpy(jax_run[0], device="cpu")
    for (path, a), (_, b) in zip(_np_leaves(port_run[0]), _np_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=f"state leaf {path}")


def test_bench_scene_matches_jax():
    """bench.py's scene (every stream alike, a fixed sound-card delay);
    the JAX package's answer from the envelope golden file."""
    far, near, ms = _bench_scene()
    jfin, jout = _golden_answer(GOLDEN_ENVELOPE, "rsf.bench16k.")
    fin, out = tf.run_streams_fused(tf.create_fused(B, FS, device="cpu"),
                                    far, near, FS, 40)
    np.testing.assert_array_equal(out.numpy(), jout)
    want = convert.fused_state_from_numpy(jfin, device="cpu")
    for (path, a), (_, b) in zip(_np_leaves(fin), _np_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=f"state leaf {path}")


def test_scene_clamps_some_ring_writes(port_run):
    """The scene drives the clamped (per-stream) jitter-ring writes: in
    some step, streams write different sample counts."""
    assert any(bool((nw != nw[:, :1]).any()) for nw in port_run[2])


def test_golden_file_is_this_scene_and_the_ports_answer(port_run):
    g = np.load(GOLDEN)
    far, near, ms = _scene()
    np.testing.assert_array_equal(g["far"], far)
    np.testing.assert_array_equal(g["near"], near)
    np.testing.assert_array_equal(g["ms"], ms)
    np.testing.assert_array_equal(g["out"].astype(np.int32), port_run[1])
    leaves = _np_leaves(port_run[0])
    assert sorted(k for k in g.files if k.startswith("state.")) == sorted(
        "state." + p for p, _ in leaves)
    for path, a in leaves:
        b = g["state." + path]
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_import_leaves_jax_out():
    code = ("import sys; import webrtc_aecm_tpu_torch, "
            "webrtc_aecm_tpu_torch.fused_kernel, webrtc_aecm_tpu_torch.convert,"
            " webrtc_aecm_tpu_torch.ops.ring_kernels, "
            "webrtc_aecm_tpu_torch.ops.fft, "
            "webrtc_aecm_tpu_torch.parallel.batch, "
            "webrtc_aecm_tpu_torch.api, webrtc_aecm_tpu_torch.models; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _reconfig_tool():
    """tools/make_torch_golden_reconfig.py as a module (numpy only at
    import: its scenes and entry table)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden_reconfig",
        os.path.join(REPO, "tools", "make_torch_golden_reconfig.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reconfig_entry(name):
    """run_streams_fused (use_kernel=True: on CPU tensors the plain path)
    on an entry of tests/data/torch_golden_reconfig.npz == the JAX
    package's output and final state."""
    from webrtc_aecm_tpu_torch import delay_estimator as tde
    from webrtc_aecm_tpu_torch.parallel import batch as tbatch
    gen = _reconfig_tool()
    fs, n_chunks, burst, seed, with_clean, history, cap, cps = gen.RSF[name]
    far, near, clean = gen.scene(fs, gen.B, n_chunks, seed, with_clean)
    st = tbatch.create_batch(gen.B, fs, device="cpu")
    dn, df = st.core.de_near, st.core.de_farend
    if history != 100:
        dn, df = tde.set_history_size(dn, df, history)
    if cap > 1:
        dn = dn._replace(
            binary_history=torch.zeros((gen.B, cap), dtype=torch.int64),
            lookahead=torch.arange(gen.B, dtype=torch.int32) % cap)
    st = tf.to_fused_state(st._replace(core=st.core._replace(
        de_near=dn, de_farend=df)))
    fin, out = tf.run_streams_fused(st, far, near, fs,
                                    gen.desync_ms(n_chunks, gen.B, burst),
                                    clean=clean, chunks_per_step=cps)
    with np.load(os.path.join(REPO, "tests", "data",
                              "torch_golden_reconfig.npz")) as g:
        np.testing.assert_array_equal(
            out.numpy(), g[f"rsf.{name}.out"].astype(np.int32))
        leaves = tree_leaves_with_path(convert.fused_state_to_numpy(fin))
        for path, a in leaves:
            b = g[f"rsf.{name}.state." + path]
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name,what", [
    ("8k_cps5", "8 kHz"),
    ("16k_h128_clean", "dual-input"),
    ("16k_cps1_la4", "chunks_per_step=1"),
    ("16k_cps3", "tail"),
])
def test_out_of_scope_raises(name, what):
    """Each configuration the port once refused now runs on the kernel
    path's entry point and gives the JAX package's answer: 5 chunks a step
    at 8 kHz (7 block slots), a clean input (with a delay estimator of 128
    rows), lookahead capacity 4 at one chunk a step, and 3 chunks a step
    with a one-chunk tail."""
    _run_reconfig_entry(name)


def test_lookahead_capacity_above_one_raises():
    """Lookahead capacity 4 with per-stream lookahead 0..3 at the default
    step (2 chunks, the circular history) gives the JAX package's answer."""
    _run_reconfig_entry("16k_la4")
