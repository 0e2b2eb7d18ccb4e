"""The PyTorch port's batch-major engine == the JAX package's (tolerance 0).

`parallel.batch.run_streams` (the port's plain path on the CPU: the ring
wrappers take their plain versions for CPU tensors) against

* the JAX package at 16 kHz with a single near input on the desync scene
  of test_torch_pipeline.py (8 streams, 40 chunks, per-(chunk, stream)
  sound-card delays, every fourth stream held in startup while its
  jitter-ring writes clamp), whose answer the golden file below holds;
* the golden file tests/data/torch_golden_batch.npz (made from the JAX
  package by tools/make_torch_golden_batch.py; chip_smoke.py holds the
  card to it) in all four configurations, 8 and 16 kHz, with and without a
  clean near input;
* the port's own fused engine, `run_streams_fused`, at 16 kHz.

Compared: the output samples and every leaf of the final state.  Also:
the real-time step (`ChunkStep`) chunk by chunk, the state conversion, the
refusals, and the entry points' default device (the CUDA card).
"""
import os

import jax
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu.parallel import batch as jb
from webrtc_aecm_tpu_torch import _device, control, convert, core, fused
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
from webrtc_aecm_tpu_torch.ops import ring_buffer as rbuf, ring_kernels
from webrtc_aecm_tpu_torch.parallel import batch as tb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_batch.npz")
CONFIGS = {"16k": (16000, False), "16k_clean": (16000, True),
           "8k": (8000, False), "8k_clean": (8000, True)}
B, FS = 8, 16000


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    return {k: g[k] for k in g.files}


def _inputs(g, name):
    return (g[f"{name}.far"], g[f"{name}.near"], g[f"{name}.ms"],
            g.get(f"{name}.clean"))


def _np_leaves(state):
    return tree_leaves_with_path(convert.aecm_state_to_numpy(state))


def _assert_state_equal(got_np_leaves, want):
    """want: {path: array} in the JAX package's dtypes."""
    assert sorted(p for p, _ in got_np_leaves) == sorted(want)
    for path, a in got_np_leaves:
        assert a.dtype == want[path].dtype, path
        np.testing.assert_array_equal(a, want[path], err_msg=path)


@pytest.fixture(scope="module")
def port_runs(golden):
    """The port's run_streams on each golden configuration, counting the
    calls of the two ring wrappers."""
    runs = {}
    for name, (fs, _) in CONFIGS.items():
        far, near, ms, clean = _inputs(golden, name)
        calls = {"write": [], "read": []}   # n_write, or the frames read
        mp = pytest.MonkeyPatch()

        def write(*args, _orig=ring_kernels.ring_write):
            calls["write"].append(rbuf.available_write(
                rbuf.RingBuffer(*args[:4])).clamp(max=args[4].shape[1]))
            return _orig(*args)

        def read(*args, _orig=ring_kernels.ring_read):
            calls["read"].append(args[5:7])
            return _orig(*args)

        mp.setattr(ring_kernels, "ring_write", write)
        mp.setattr(ring_kernels, "ring_read", read)
        try:
            fin, out = tb.run_streams(tb.create_batch(B, fs, device="cpu"),
                                      far, near, fs, ms, clean=clean)
        finally:
            mp.undo()
        runs[name] = (fin, out.numpy(), calls)
    return runs


@pytest.fixture(scope="module")
def jax_run(golden):
    """The JAX package's batch-major engine on the 16 kHz desync scene:
    its answer in the golden file (tools/make_torch_golden_batch.py ran
    the JAX run_streams, which scans its make_chunk_step, on this scene:
    test_golden_16k_scene_is_the_pipeline_scene), as (final state leaves
    {path: array}, out)."""
    prefix = "16k.state."
    return ({k[len(prefix):]: v for k, v in golden.items()
             if k.startswith(prefix)}, golden["16k.out"].astype(np.int32))


def test_run_streams_matches_jax_live(jax_run, port_runs):
    jfin, jout = jax_run
    fin, out, _ = port_runs["16k"]
    np.testing.assert_array_equal(out, jout)
    _assert_state_equal(_np_leaves(fin), jfin)


def test_golden_16k_scene_is_the_pipeline_scene(golden):
    """The 16 kHz configuration is the desync scene the fused golden file
    holds, so the two engines' files describe the same input."""
    g16 = np.load(os.path.join(REPO, "tests", "data", "torch_golden_16k.npz"))
    for k in ("far", "near", "ms"):
        np.testing.assert_array_equal(golden[f"16k.{k}"], g16[k])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_streams_matches_golden(golden, port_runs, name):
    fin, out, _ = port_runs[name]
    np.testing.assert_array_equal(out, golden[f"{name}.out"].astype(np.int32))
    prefix = f"{name}.state."
    _assert_state_equal(_np_leaves(fin), {
        k[len(prefix):]: v for k, v in golden.items()
        if k.startswith(prefix)})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ring_passes_per_chunk(port_runs, golden, name):
    """One jitter-ring write per chunk and one read for all of its
    80-sample frames, in startup too (both branches of Process run for
    every stream)."""
    fs = CONFIGS[name][0]
    n_chunks = golden[f"{name}.ms"].shape[0]
    calls = port_runs[name][2]
    assert len(calls["write"]) == n_chunks
    assert calls["read"] == [(80, fs // 8000)] * n_chunks


def test_long_8k_calls_read_around_est_buf_delay(monkeypatch):
    """8 kHz with 160-sample calls: _est_buf_delay moves the read pointer
    between the two frames, so Process reads them in two launches of one
    frame each (the serving sizes read all their frames in one)."""
    reads = []

    def read(*args, _orig=ring_kernels.ring_read):
        reads.append(args[5:7])
        return _orig(*args)

    monkeypatch.setattr(ring_kernels, "ring_read", read)
    x = torch.zeros((2, 160), dtype=torch.int32)
    st = tb.create_batch(2, 8000, device="cpu")
    control.process(st, x, None, 160, 40, 8000)
    assert reads == [(80, 1), (80, 1)]
    del reads[:]
    control.process(tb.create_batch(2, FS, device="cpu"), x, None, 160, 40,
                    FS)
    assert reads == [(80, 2)]


def test_scene_clamps_some_ring_writes(port_runs):
    """The 16 kHz scene drives clamped (per-stream) jitter-ring writes: in
    some chunk, streams write different sample counts."""
    assert any(bool((nw != nw[:1]).any())
               for nw in port_runs["16k"][2]["write"])


def test_engines_agree():
    """The port's two engines give the same output and state at 16 kHz
    (the README's claim that they are bit-identical)."""
    rng = np.random.default_rng(5)
    far = rng.normal(0, 3000, (B, 12 * 160)).clip(-30000, 30000)
    near = (0.4 * np.roll(far, 37, axis=1) + rng.normal(0, 150, far.shape))
    far, near = far.astype(np.int16), near.astype(np.int16)
    ms = 40 + 20 * (np.arange(B) % 3)
    fin, out = tb.run_streams(tb.create_batch(B, FS, device="cpu"), far,
                              near, FS, ms)
    ffin, fout = fused.run_streams_fused(
        fused.create_fused(B, FS, device="cpu"), far, near, FS, ms)
    assert torch.equal(out, fout)
    for (p, a), (_, b) in zip(tree_leaves_with_path(fin),
                              tree_leaves_with_path(
                                  fused.from_fused_state(ffin))):
        assert torch.equal(a, b), p


def test_chunk_step_matches_run_streams(golden):
    """Stepping ChunkStep (with the clean input) chunk by chunk == one
    run_streams call; run_streams leaves its input state alone."""
    far, near, ms, clean = _inputs(golden, "8k_clean")
    n = 12
    far, near, clean, ms = far[:, :80 * n], near[:, :80 * n], \
        clean[:, :80 * n], ms[:n]
    st0 = tb.create_batch(B, 8000, device="cpu")
    before = [x.clone() for _, x in tree_leaves_with_path(st0)]
    fin, out = tb.run_streams(st0, far, near, 8000, ms, clean=clean)
    for (p, x), y in zip(tree_leaves_with_path(st0), before):
        assert torch.equal(x, y), p
    step = tb.make_chunk_step(8000, has_clean=True, device="cpu")
    st, outs = st0, []
    for c in range(n):
        cols = slice(80 * c, 80 * (c + 1))
        st, o, warn = step(st, far[:, cols], near[:, cols], clean[:, cols],
                           ms[c])
        assert not warn.any()
        outs.append(o)
    assert torch.equal(torch.cat(outs, 1), out)
    for (p, a), (_, b) in zip(tree_leaves_with_path(st),
                              tree_leaves_with_path(fin)):
        assert torch.equal(a, b), p


def test_chunk_step_warns_on_bad_delay():
    step = tb.make_chunk_step(8000, device="cpu")
    x = torch.zeros((2, 80), dtype=torch.int32)
    _, _, warn = step(tb.create_batch(2, 8000, device="cpu"), x, x,
                      torch.tensor([40, 600]))
    assert warn.tolist() == [0, 12100]


def test_state_conversion_round_trips():
    """JAX batched state -> port -> numpy gives back every JAX leaf, dtype
    and all (uint32 leaves as int64 carriers, the uint16 far history as
    int32), and creation matches the JAX package's."""
    jst = jax.tree_util.tree_map(np.asarray, jb.create_batch(B, FS))
    port = convert.aecm_state_from_numpy(jst, device="cpu")
    assert port.core.far_history.dtype == torch.int32
    assert port.core.seed.dtype == torch.int64
    back = convert.aecm_state_to_numpy(port)
    jl = jax.tree_util.tree_leaves(jst)
    bl = [x for _, x in tree_leaves_with_path(back)]
    assert len(jl) == len(bl)
    for a, b in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    _assert_state_equal(_np_leaves(tb.create_batch(B, FS, device="cpu")),
                        dict(tree_leaves_with_path(back)))


def test_set_config_batch_matches_jax():
    cng = np.array([0, 1, 1, 0], np.int32)
    mode = np.array([0, 2, 4, 3], np.int32)
    want = jb.set_config_batch(jb.create_batch(4, 8000), cng, mode)
    got = tb.set_config_batch(tb.create_batch(4, 8000, device="cpu"), cng,
                              mode)
    _assert_state_equal(_np_leaves(got), dict(tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, want))))


def test_debug_option_raises():
    """Options(debug=True) no longer raises in control.process: it adds
    the taps, (B, n_frames, 2, ...), and leaves the output, warnings and
    state as they are without it (the taps' values are held to the JAX
    package in tests/test_torch_debug.py)."""
    st = tb.create_batch(2, FS, device="cpu")
    x = torch.zeros((2, 160), dtype=torch.int32)
    st_d, out_d, warn_d, taps = control.process(
        st, x, None, 160, 40, FS, opts=core.Options(debug=True))
    st_p, out_p, warn_p = control.process(st, x, None, 160, 40, FS)
    assert torch.equal(out_d, out_p) and torch.equal(warn_d, warn_p)
    assert taps["hnl_q14"].shape == (2, 2, 2, 65)
    assert taps["delay_blocks"].shape == (2, 2, 2)
    for (path, a), (_, b) in zip(tree_leaves_with_path(st_d),
                                 tree_leaves_with_path(st_p)):
        assert torch.equal(a, b), path


def test_default_device_is_cuda(monkeypatch):
    """Left to their defaults the entry points build on the CUDA card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _device.resolve() == torch.device("cuda")
    assert _device.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("make", [
    lambda: control.create(16000),
    lambda: core.create_core(16000),
    lambda: tb.create_batch(2, 16000),
    lambda: fused.create_fused(2, 16000),
    lambda: fused.make_tables(),
    lambda: fused.FusedAecm(16000),
    lambda: tb.ChunkStep(16000),
    lambda: convert.aecm_state_from_numpy(
        convert.aecm_state_to_numpy(tb.create_batch(1, 8000, device="cpu"))),
], ids=["control.create", "core.create_core", "create_batch",
        "create_fused", "make_tables", "FusedAecm", "ChunkStep",
        "aecm_state_from_numpy"])
def test_no_card_and_no_device_raises(monkeypatch, make):
    """Without a card and without device="cpu", creation raises: nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
