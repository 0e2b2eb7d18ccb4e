"""The port's compiled steps (webrtc_aecm_tpu_torch/compiled.py), on the CPU.

On the card a compiled step is captured once per input signature as a CUDA
graph and replayed; on the CPU `compiled.static_buffers_on_cpu()` runs the
same static-buffer body eagerly (inputs copied into static buffers, the
state written back into them, the outputs cloned out), so these tests
cover every line but the capture and the replay.  Tolerance 0 throughout:

* the static-buffer path of `AecmPipeline.step` on both engines at 8 and
  16 kHz, single and clean, == the JAX package's answers in
  tests/data/torch_golden_batch.npz (the two engines are bit-exact with
  each other), and on a mesh of two devices (fused, 8 kHz);
* `run_streams_fused` with a tail span (tests/data/torch_golden_envelope.npz
  `rsf.8k`), `run_streams` (torch_golden_batch.npz) and `AecmInstance`
  with its debug taps (tests/data/torch_golden_surface.npz `dbg.16k`);
* the static-buffer path == the eager step, leaf for leaf, across
  `load`, `reset_streams` and `set_config` between steps;
* a returned output and state unchanged by the next call, a state passed
  in left unmodified, and one cache entry per signature;
* capture readiness: each warm step run once under a dispatch mode that
  fails on any operation that reads a tensor on the host or makes one from
  host data (what a CUDA graph capture refuses), and that mode shown to
  fail on a `torch.tensor(...)` planted in a copy of a step.

No test here imports JAX.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from webrtc_aecm_tpu_torch import AecmInstance, compiled, convert, fused
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
from webrtc_aecm_tpu_torch.compiled import compile_step
from webrtc_aecm_tpu_torch.models import AecmPipeline
from webrtc_aecm_tpu_torch.parallel import batch as pbatch
from webrtc_aecm_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CONFIGS = {"16k": (16000, False), "16k_clean": (16000, True),
           "8k": (8000, False), "8k_clean": (8000, True)}
B = 8


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)    # numpy only at import: the scenes
    return mod


def _load(name, prefix=""):
    with np.load(os.path.join(DATA, name)) as g:
        return {k: g[k] for k in g.files if k.startswith(prefix)}


@pytest.fixture(scope="module")
def golden_batch():
    return _load("torch_golden_batch.npz")


@pytest.fixture
def static():
    with compiled.static_buffers_on_cpu():
        yield


def _np_leaves(state):
    """Every leaf of a batch-major or fused state as numpy, JAX dtypes."""
    if isinstance(state, fused.FusedState):
        return tree_leaves_with_path(convert.fused_state_to_numpy(state))
    return tree_leaves_with_path(convert.aecm_state_to_numpy(state))


def _assert_golden_state(state, golden, prefix):
    want = {k[len(prefix):]: v for k, v in golden.items()
            if k.startswith(prefix)}
    got = _np_leaves(state)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, a in got:
        assert a.dtype == want[path].dtype, path
        np.testing.assert_array_equal(a, want[path], err_msg=path)


def _assert_trees_equal(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), p


def _golden_inputs(g, name):
    far, near, ms = (torch.as_tensor(g[f"{name}.{k}"]).int()
                     for k in ("far", "near", "ms"))
    clean = g.get(f"{name}.clean")
    return far, near, ms, None if clean is None else torch.as_tensor(
        clean).int()


def _step_through(pipe, far, near, ms, clean, chunks):
    """pipe.step chunk by chunk; returns the outputs joined."""
    n = pipe.chunk
    outs = []
    for c in chunks:
        cols = slice(c * n, (c + 1) * n)
        out, _ = pipe.step(far[:, cols], near[:, cols],
                           None if clean is None else clean[:, cols], ms[c])
        outs.append(out)
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("engine", ["fused", "xla"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_pipeline_step_static_path_matches_golden(golden_batch, static,
                                                  engine, name):
    """AecmPipeline.step through its compiled step's static buffers ==
    the JAX package's run_streams, output and every state leaf; one
    signature, one entry."""
    fs, with_clean = CONFIGS[name]
    far, near, ms, clean = _golden_inputs(golden_batch, name)
    pipe = AecmPipeline(B, fs, engine=engine, device="cpu")
    out = _step_through(pipe, far, near, ms, clean, range(ms.shape[0]))
    np.testing.assert_array_equal(
        out.numpy(), golden_batch[f"{name}.out"].astype(np.int32))
    _assert_golden_state(pipe._canonical(), golden_batch, f"{name}.state.")
    assert pipe._step[with_clean].n_graphs == 1


def test_sharded_step_static_path_matches_golden(golden_batch, static):
    """A mesh of two devices on the fused engine: one compiled step per
    shard, each holding its shard's state in its buffers; == the golden
    answer."""
    far, near, ms, _ = _golden_inputs(golden_batch, "8k")
    pipe = AecmPipeline(B, 8000, engine="fused", device="cpu",
                        mesh=make_mesh(["cpu"] * 2))
    out = _step_through(pipe, far, near, ms, None, range(ms.shape[0]))
    np.testing.assert_array_equal(
        out.numpy(), golden_batch["8k.out"].astype(np.int32))
    _assert_golden_state(pipe._canonical(), golden_batch, "8k.state.")
    assert [s.n_graphs for s in pipe._step[False].steps] == [1, 1]


def test_run_streams_fused_tail_span_matches_golden(static):
    """run_streams_fused at 8 kHz: nine 4-chunk steps (circular history,
    the head a device tensor) and a 1-chunk tail, each span one compiled
    step with one entry; == the JAX answer; the state passed in is left
    as it was."""
    gen = _tool("make_torch_golden_envelope")
    g = _load("torch_golden_envelope.npz", "rsf.8k.")
    fs, n_chunks, burst, seed, _, _ = gen.RSF["8k"]
    far, near, _ = gen.scene(fs, gen.B, n_chunks, seed)
    st = fused.create_fused(gen.B, fs, device="cpu")
    before = fused.clone_state(st)
    fin, out = fused.run_streams_fused(st, far, near, fs,
                                       gen.desync_ms(n_chunks, gen.B, burst))
    np.testing.assert_array_equal(out.numpy(),
                                  g["rsf.8k.out"].astype(np.int32))
    _assert_golden_state(fin, g, "rsf.8k.state.")
    _assert_trees_equal(st, before)
    dev = torch.device("cpu")
    assert fused._span_step(fs, 4, True, dev, False, True).n_graphs == 1
    assert fused._span_step(fs, 1, True, dev, False, False).n_graphs == 1


def test_run_streams_static_path_matches_golden(golden_batch, static):
    far, near, ms, clean = _golden_inputs(golden_batch, "8k_clean")
    fin, out = pbatch.run_streams(pbatch.create_batch(B, 8000, device="cpu"),
                                  far, near, 8000, ms, clean=clean)
    np.testing.assert_array_equal(
        out.numpy(), golden_batch["8k_clean.out"].astype(np.int32))
    _assert_golden_state(fin, golden_batch, "8k_clean.state.")


def test_instance_debug_taps_static_path_match_golden(static):
    """AecmInstance's compiled buffer_farend and process, the debug taps
    among process's outputs, call by call == the JAX package's."""
    gen = _tool("make_torch_golden_surface")
    g = _load("torch_golden_surface.npz", "dbg.16k.")
    fs, _, _, _, _ = gen.DBG["16k"]
    far, near, _, ms = gen.dbg_inputs("16k")
    calls = 20     # of the sequence's 50: past the startup
    n = fs // 100
    inst = AecmInstance(fs, device="cpu")
    for c in range(calls):
        cols = slice(c * n, (c + 1) * n)
        inst.buffer_farend(far[cols])
        out, warn, taps = inst.process(near[cols], None, int(ms[c]),
                                       debug=True)
        np.testing.assert_array_equal(out, g["dbg.16k.out"][c])
        assert warn == g["dbg.16k.warn"][c]
        for k, v in taps.items():
            np.testing.assert_array_equal(v, g[f"dbg.16k.tap.{k}"][c],
                                          err_msg=f"call {c}: {k}")
    assert int(inst.state.ec_startup[0]) == 0
    assert (inst._buffer_farend.n_graphs, inst._process.n_graphs) == (1, 1)


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_static_path_equals_eager_across_load_reset_and_config(
        golden_batch, tmp_path, engine):
    """Two pipelines in lockstep, one through the static buffers, one
    eager: every output and state leaf equal after each step, and what
    load, reset_streams and set_config make between steps is what the next
    step sees."""
    far, near, ms, clean = _golden_inputs(golden_batch, "8k_clean")
    pipes = [AecmPipeline(B, 8000, engine=engine, device="cpu")
             for _ in range(2)]
    ckpt = str(tmp_path / "ck.npz")

    def both(fn):
        with compiled.static_buffers_on_cpu():
            a = fn(pipes[0])
        b = fn(pipes[1])
        if a is not None:
            assert torch.equal(a, b)
        _assert_trees_equal(pipes[0].state, pipes[1].state)

    def steps(lo, hi):
        return lambda p: _step_through(p, far, near, ms, clean, range(lo, hi))

    both(steps(0, 4))
    pipes[1].save(ckpt)
    both(steps(4, 6))
    both(lambda p: p.set_config([0, 1] * 4, [0, 1, 2, 3, 4, 3, 2, 1]))
    both(steps(6, 8))
    both(lambda p: p.reset_streams([1, 4]))
    both(steps(8, 10))
    both(lambda p: p.load(ckpt))
    both(steps(4, 6))     # the checkpoint's next chunks again


def test_outputs_and_states_do_not_change_under_the_next_call(
        golden_batch, static):
    """A functional compiled step leaves the state passed in as it was,
    and what it returned stays as it was through the next call; with
    donation the state returned is the step's own buffers, passed back
    without a copy, and the output still is the caller's."""
    far, near, ms, _ = _golden_inputs(golden_batch, "8k")
    cols = [slice(c * 80, (c + 1) * 80) for c in range(3)]
    step = compile_step(pbatch.make_chunk_step(8000, device="cpu"))
    st0 = pbatch.create_batch(B, 8000, device="cpu")
    keep0 = fused.clone_state(st0)
    st1, out1, warn1 = step(st0, far[:, cols[0]], near[:, cols[0]], ms[0])
    keep1 = (fused.clone_state(st1), out1.clone(), warn1.clone())
    step(st1, far[:, cols[1]], near[:, cols[1]], ms[1])
    _assert_trees_equal(st0, keep0)
    _assert_trees_equal(st1, keep1[0])
    assert torch.equal(out1, keep1[1]) and torch.equal(warn1, keep1[2])

    owned = compile_step(pbatch.make_chunk_step(8000, device="cpu"),
                         donate=True)
    s1, o1, _ = owned(st0, far[:, cols[0]], near[:, cols[0]], ms[0])
    o1_kept = o1.clone()
    s2, _, _ = owned(s1, far[:, cols[1]], near[:, cols[1]], ms[1])
    # the owner's state is the step's buffers, advanced in place
    assert all(x is y for (_, x), (_, y) in zip(tree_leaves_with_path(s1),
                                                tree_leaves_with_path(s2)))
    assert torch.equal(o1, o1_kept)
    _assert_trees_equal(s2, step(st1, far[:, cols[1]], near[:, cols[1]],
                                 ms[1])[0])

    # run_streams_fused's state is its own: a later run leaves it alone
    fst = fused.create_fused(B, 8000, device="cpu")
    fin, out = fused.run_streams_fused(fst, far[:, :640], near[:, :640],
                                       8000)
    kept = (fused.clone_state(fin), out.clone())
    fused.run_streams_fused(fin, far[:, 640:1280], near[:, 640:1280], 8000)
    _assert_trees_equal(fin, kept[0])
    assert torch.equal(out, kept[1])


def test_one_entry_per_signature(static):
    """The cache is keyed by each tensor's shape, dtype and device and by
    the static values; the same signature replays its entry."""
    calls = []

    def fn(state, x, k):
        calls.append(k)
        return state + x * k, x.sum()

    step = compile_step(fn)
    s = torch.zeros(4, dtype=torch.int32)
    for _ in range(3):
        s, _ = step(s, torch.ones(4, dtype=torch.int32), 2)
    assert step.n_graphs == 1 and s.tolist() == [6] * 4
    step(s, torch.ones(4, dtype=torch.int32), 3)            # a static value
    step(s, torch.ones(4, dtype=torch.int64), 2)            # a dtype
    step(torch.zeros(5, dtype=torch.int32),
         torch.ones(5, dtype=torch.int32), 2)               # a shape
    assert step.n_graphs == 4
    with compiled.disable_graphs():
        step(s, torch.ones(4, dtype=torch.int32), 7)        # eager
    assert step.n_graphs == 4 and calls[-1] == 7
    with pytest.raises(TypeError, match="hashable"):
        step(s, torch.ones(4, dtype=torch.int32), np.ones(2))


# ---------------------------------------------------------------------------
# Capture readiness
# ---------------------------------------------------------------------------

class HostDataGuard(TorchDispatchMode):
    """Fails on any operation that reads a tensor on the host (a sync on
    the card) or makes a tensor from host data (a copy from pageable
    memory): what a CUDA graph capture refuses."""
    FORBIDDEN = {"_local_scalar_dense", "is_nonzero", "item", "equal",
                 "lift_fresh", "lift_fresh_copy", "nonzero", "masked_select",
                 "_unique2", "unique_dim", "unique_consecutive"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.FORBIDDEN or (
                name in ("index", "index_put", "index_put_")
                and any(torch.is_tensor(i) and i.dtype == torch.bool
                        for i in args[1] if i is not None)):
            raise AssertionError(f"{func} in a step: it reads a tensor on "
                                 f"the host or copies host data")
        return func(*args, **(kwargs or {}))


def _warm_steps():
    """{name: (compiled step, args)} for every compiled step of the port,
    each warm (called once)."""
    g = _load("torch_golden_batch.npz", "16k_clean.")
    far, near, ms, clean = _golden_inputs(g, "16k_clean")
    steps = {}
    for engine in ("fused", "xla"):
        for fs in (8000, 16000):
            for with_clean in (False, True):
                n = fs // 100
                pipe = AecmPipeline(B, fs, engine=engine, device="cpu")
                audio = (far[:, :n], near[:, :n]) + (
                    (clean[:, :n],) if with_clean else ())
                pipe.step(*audio[:2], audio[2] if with_clean else None,
                          ms[0])
                steps[f"pipeline {engine} {fs} clean={with_clean}"] = (
                    pipe._get_step(with_clean),
                    (pipe.state,) + audio + (
                        torch.full((B,), 40, dtype=torch.int32),))
    span = fused._span_step(16000, 2, True, torch.device("cpu"), False, True)
    fst = fused.to_fused_state(pbatch.create_batch(B, 16000, device="cpu"))
    fst = fst._replace(core=fused._to_circular_far(fst.core))
    steps["run_streams_fused span"] = (span, (
        fst, torch.zeros((), dtype=torch.int32), far[:, :320],
        near[:, :320].T, ms[:2]))
    chunk = pbatch._chunk_step(16000, True, torch.device("cpu"))
    steps["run_streams chunk"] = (chunk, (
        pbatch.create_batch(B, 16000, device="cpu"), far[:, :160],
        near[:, :160], clean[:, :160], ms[0]))
    inst = AecmInstance(16000, device="cpu")
    row = far[:1, :160]
    inst.buffer_farend(row[0].numpy())
    inst.process(near[0, :160].numpy(), None, 40, debug=True)
    steps["AecmInstance.buffer_farend"] = (inst._buffer_farend,
                                           (inst.state, row, 2))
    steps["AecmInstance.process debug"] = (inst._process, (
        inst.state, near[:1, :160], None, 160,
        torch.full((1,), 40, dtype=torch.int32), 16000,
        inst.opts._replace(debug=True)))
    mesh_pipe = AecmPipeline(B, 16000, engine="fused", device="cpu",
                             mesh=make_mesh(["cpu"] * 2))
    mesh_pipe.step(far[:, :160], near[:, :160])
    steps["sharded shard 0"] = (mesh_pipe._get_step(False).steps[0], (
        mesh_pipe.state[0], far[:4, :160], near[:4, :160],
        torch.full((4,), 40, dtype=torch.int32)))
    return steps


WARM_STEPS = ["pipeline fused 8000 clean=False",
              "pipeline fused 8000 clean=True",
              "pipeline fused 16000 clean=False",
              "pipeline fused 16000 clean=True",
              "pipeline xla 8000 clean=False", "pipeline xla 8000 clean=True",
              "pipeline xla 16000 clean=False",
              "pipeline xla 16000 clean=True", "run_streams_fused span",
              "run_streams chunk", "AecmInstance.buffer_farend",
              "AecmInstance.process debug", "sharded shard 0"]


@pytest.fixture(scope="module")
def warm_steps():
    with compiled.static_buffers_on_cpu():
        steps = _warm_steps()
        for step, args in steps.values():
            step(*args)
    assert sorted(steps) == sorted(WARM_STEPS)
    return steps


@pytest.mark.parametrize("name", WARM_STEPS)
def test_warm_step_is_capture_ready(warm_steps, name):
    step, args = warm_steps[name]
    with HostDataGuard():
        step.fn(*args)


def test_the_guard_catches_a_planted_host_copy(warm_steps):
    """A copy of a step with one torch.tensor(...) planted in it fails."""
    step, args = warm_steps["pipeline fused 16000 clean=False"]

    def planted(state, *rest):
        state = state._replace(ctrl=state.ctrl._replace(
            ec_startup=state.ctrl.ec_startup + torch.tensor(0)))
        return step.fn(state, *rest)

    with pytest.raises(AssertionError, match="lift_fresh"):
        with HostDataGuard():
            planted(*args)
    with pytest.raises(AssertionError, match="_local_scalar_dense"):
        with HostDataGuard():
            int(args[0].ctrl.ec_startup[0])
