"""The PyTorch port's serving slice == the JAX package's (tolerance 0).

The whole fused 16 kHz path: `create_fused`, and `run_streams_fused` (the
port's plain path on the CPU against the JAX package's pure path) on
bench.py's scene and on the desync scene -- 8 streams, 40 chunks of 10 ms, per-(chunk, stream)
sound-card delays with a burst at chunk 24, and every fourth stream held
in startup until its ring writes clamp -- for the output samples and
every leaf of the final state.  The committed golden file (made from the
JAX package by tools/make_torch_golden.py; chip_smoke.py holds the GPU to
it) must hold the same scene and the port's answer.  State moves between
the packages only through webrtc_aecm_tpu_torch.convert.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
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


@pytest.fixture(scope="module")
def jax_runner():
    """The JAX package's pure fused path, compiled once for both scenes
    (ms is an argument, not a constant of the trace)."""
    run = jax.jit(lambda s, f, d, m: jf.run_streams_fused(
        s, f, d, FS, m, use_kernel=False))

    def call(far, near, ms):
        fin, out = run(jf.create_fused(B, FS), jnp.asarray(far, jnp.int32),
                       jnp.asarray(near, jnp.int32), jnp.asarray(ms))
        return jax.tree_util.tree_map(np.asarray, fin), np.asarray(out)
    return call


@pytest.fixture(scope="module")
def jax_run(jax_runner):
    return jax_runner(*_scene())


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


def test_bench_scene_matches_jax(jax_runner):
    """bench.py's scene (every stream alike, a fixed sound-card delay)."""
    far, near, ms = _bench_scene()
    jfin, jout = jax_runner(far, near, ms)
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
            "webrtc_aecm_tpu_torch.parallel.batch; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("kwargs,what", [
    (dict(sample_rate=8000), "8 kHz"),
    (dict(clean=np.zeros((2, 640), np.int16)), "dual-input"),
    (dict(chunks_per_step=1), "chunks_per_step=1"),
    (dict(n_samples=480), "tail"),
])
def test_out_of_scope_raises(kwargs, what):
    """The parts of the JAX envelope not ported yet say so."""
    n = kwargs.pop("n_samples", 640)
    fs = kwargs.pop("sample_rate", FS)
    x = np.zeros((2, n), np.int16)
    with pytest.raises(NotImplementedError, match=what):
        tf.run_streams_fused(tf.create_fused(2, fs, device="cpu"), x, x, fs,
                             **kwargs)


def test_lookahead_capacity_above_one_raises():
    st = tf.create_fused(2, FS, device="cpu")
    dn = st.core.de_near
    st = st._replace(core=st.core._replace(de_near=dn._replace(
        binary_history=torch.zeros((4, 2), dtype=torch.int64))))
    x = np.zeros((2, 640), np.int16)
    with pytest.raises(NotImplementedError, match="lookahead"):
        tf.run_streams_fused(st, x, x, FS)
