"""The port's stream split over several devices == the unsplit run.

The counterpart of tests/test_batching.py's sharded tests (:88 and :205)
and of __graft_entry__.dryrun_multichip for the port, on meshes of 2 and 4
"cpu" devices at 8 streams (a mesh may name a device more than once: each
entry is one shard): `AecmPipeline(mesh=...)` `run` and `step` on both
engines, with and without a clean input, against the same pipeline
without a mesh (outputs, warnings and every state leaf, tolerance 0); the
seven `parallel` names of the JAX package; a checkpoint from a mesh
pipeline loaded by a plain one and the reverse; a stream count that does
not divide the mesh.  The streams differ (per-stream delays and sound-card
delays), so a split on the wrong axis of a lane-major (rows, B) leaf
shows.  No test here compiles a JAX function.
"""
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu_torch import fused
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
from webrtc_aecm_tpu_torch.models import AecmPipeline
from webrtc_aecm_tpu_torch.parallel import (
    create_batch, fused_state_spec, gather_streams, make_chunk_step,
    make_mesh, make_sharded_step, make_sharded_step_fused, shard_streams,
    shard_streams_fused, stream_sharding)

torch.set_num_threads(1)

FS, B, N_CHUNKS, N_STEPS = 8000, 8, 9, 2


def _scene(seed=2):
    """Per-stream echo delays and gains, per-(chunk, stream) sound-card
    delays (tests/test_batching.py's _batch_scenes, shortened)."""
    rng = np.random.default_rng(seed)
    n = (N_CHUNKS + N_STEPS) * 80
    fars, nears = [], []
    for i in range(B):
        d = 160 + 80 * i
        t = np.arange(n + d)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (FS // 3))
        ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
        fars.append(ff[d:d + n])
        nears.append(((0.2 + 0.1 * i) * ff[:n] + rng.normal(0, 200, n)
                      ).clip(-32000, 32000))
    far = np.stack(fars).astype(np.int16)
    near = np.stack(nears).astype(np.int16)
    clean = (0.05 * far + rng.normal(0, 300, far.shape)).clip(
        -32000, 32000).astype(np.int16)
    ms = 40 + 15 * (np.arange(N_CHUNKS)[:, None] + np.arange(B)[None]) % 70
    return far, near, clean, ms.astype(np.int32)


def _serve(pipe, with_clean):
    """run over N_CHUNKS chunks then N_STEPS 10 ms steps: (outputs,
    warnings, state leaves)."""
    far, near, clean, ms = _scene()
    span = slice(0, N_CHUNKS * 80)
    outs = [pipe.run(far[:, span], near[:, span],
                     clean[:, span] if with_clean else None, ms)]
    warns = []
    for c in range(N_CHUNKS, N_CHUNKS + N_STEPS):
        s = slice(c * 80, (c + 1) * 80)
        o, w = pipe.step(far[:, s], near[:, s],
                         clean[:, s] if with_clean else None,
                         np.arange(B) * 7 + 20)
        outs.append(o)
        warns.append(w)
    return (torch.cat(outs, 1), torch.stack(warns),
            tree_leaves_with_path(pipe._canonical()))


_REF = {}


def _reference(engine, with_clean):
    if (engine, with_clean) not in _REF:
        _REF[engine, with_clean] = _serve(
            AecmPipeline(B, FS, engine=engine, device="cpu"), with_clean)
    return _REF[engine, with_clean]


def _assert_same(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for (path, a), (_, b) in zip(got[2], want[2]):
        assert a.device == torch.device("cpu")
        assert torch.equal(a, b), path


@pytest.mark.parametrize("n_devices", [2, 4])
@pytest.mark.parametrize("with_clean", [False, True],
                         ids=["single", "clean"])
@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_sharded_pipeline_equals_unsharded(engine, with_clean, n_devices):
    mesh = make_mesh(["cpu"] * n_devices)
    pipe = AecmPipeline(B, FS, engine=engine, device="cpu", mesh=mesh)
    assert len(pipe.state) == n_devices
    _assert_same(_serve(pipe, with_clean), _reference(engine, with_clean))


def test_shards_hold_their_slice_in_the_engines_layout():
    """A fused state splits its batch-leading control leaves on axis 0 and
    its lane-major core leaves on axis 1; gathering gives it back."""
    mesh = make_mesh(["cpu"] * 4)
    fst = fused.create_fused(B, FS, device="cpu")
    far, near, _, ms = _scene()
    fst, _ = fused.run_streams_fused(fst, far[:, :640], near[:, :640], FS,
                                     ms[:8])
    shards = shard_streams_fused(fst, mesh)
    assert fused_state_spec() == fused.FusedState(ctrl=0, core=1)
    for k, sh in enumerate(shards):
        assert torch.equal(sh.ctrl.farend_buf.data,
                           fst.ctrl.farend_buf.data[2 * k:2 * k + 2])
        assert torch.equal(sh.core.far_history,
                           fst.core.far_history[:, 2 * k:2 * k + 2])
    back = gather_streams(shards, mesh, fused_state_spec())
    for (path, a), (_, b) in zip(tree_leaves_with_path(back),
                                 tree_leaves_with_path(fst)):
        assert torch.equal(a, b), path
    assert stream_sharding(mesh).axis == 0


@pytest.mark.parametrize("with_clean", [False, True], ids=["single", "clean"])
def test_sharded_steps_equal_unsharded(with_clean):
    """make_sharded_step and make_sharded_step_fused, chunk by chunk, ==
    the unsharded batch-major step (tests/test_batching.py:205)."""
    mesh = make_mesh(["cpu"] * 2)
    far, near, clean, _ = _scene(seed=13)
    ms = torch.full((B,), 40, dtype=torch.int32)
    ref_state = create_batch(B, FS, device="cpu")
    ref_step = make_chunk_step(FS, has_clean=with_clean, device="cpu")
    xla_state = shard_streams(create_batch(B, FS, device="cpu"), mesh)
    xla_step = make_sharded_step(FS, mesh, has_clean=with_clean)
    f_state = shard_streams_fused(fused.create_fused(B, FS, device="cpu"),
                                  mesh)
    f_step = make_sharded_step_fused(FS, mesh, has_clean=with_clean)
    for c in range(N_STEPS * 2):
        s = slice(c * 80, (c + 1) * 80)
        xs = [torch.as_tensor(x[:, s]).int() for x in
              ((far, near, clean) if with_clean else (far, near))]
        ref_state, r_out, r_warn = ref_step(ref_state, *xs, ms)
        xla_state, x_out, x_warn = xla_step(xla_state, *xs, ms)
        f_state, f_out, f_warn = f_step(f_state, *xs, ms)
        assert torch.equal(x_out, r_out) and torch.equal(f_out, r_out), c
        assert torch.equal(x_warn, r_warn) and torch.equal(f_warn, r_warn)
    ref = tree_leaves_with_path(ref_state)
    for got in (gather_streams(xla_state, mesh),
                fused.from_fused_state(gather_streams(f_state, mesh,
                                                      fused_state_spec()))):
        for (path, a), (_, b) in zip(tree_leaves_with_path(got), ref):
            assert torch.equal(a, b), path


def test_checkpoint_moves_between_mesh_and_plain(tmp_path):
    far, near, _, ms = _scene()
    mesh = make_mesh(["cpu"] * 2)
    sharded = AecmPipeline(B, FS, engine="fused", device="cpu", mesh=mesh)
    sharded.run(far[:, :480], near[:, :480], None, ms[:6])
    sharded.save(str(tmp_path / "mesh.npz"))
    plain = AecmPipeline(B, FS, engine="xla", device="cpu")
    plain.load(str(tmp_path / "mesh.npz"))
    rest = slice(480, 880)
    want = sharded.run(far[:, rest], near[:, rest], None, 40)
    assert torch.equal(plain.run(far[:, rest], near[:, rest], None, 40),
                       want)
    plain.save(str(tmp_path / "plain.npz"))
    again = AecmPipeline(B, FS, engine="xla", device="cpu",
                         mesh=make_mesh(["cpu"] * 4))
    again.load(str(tmp_path / "plain.npz"))
    for (path, a), (_, b) in zip(tree_leaves_with_path(again._canonical()),
                                 tree_leaves_with_path(plain._canonical())):
        assert torch.equal(a, b), path


def test_stream_count_must_divide_the_mesh():
    mesh = make_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="divide"):
        AecmPipeline(6, FS, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        shard_streams(create_batch(6, FS, device="cpu"), mesh)
    with pytest.raises(ValueError, match="first device"):
        AecmPipeline(8, FS, device="cuda", mesh=mesh)
