"""The port's fused envelope == the JAX package's (tolerance 0), on the CPU.

The plain paths of webrtc_aecm_tpu_torch (CPU tensors take them) against
the JAX package's answers in tests/data/torch_golden_envelope.npz (written
by tools/make_torch_golden_envelope.py from the JAX package on the CPU;
chip_smoke.py holds the card's kernel path to the same file):

* `run_streams_fused` at 8 kHz (9 steps of 4 chunks and a 1-chunk tail),
  with a clean input at 8 and 16 kHz, and with per-stream cng/echo modes;
* the 10 ms real-time step (`make_fused_chunk_step`: one chunk, the
  newest-first far history, batch-leading input) at 8 and 16 kHz, and with
  per-stream modes and `abs_approx`;
* single `frames_step` calls in the newest-first mode at 2, 3 and 4 block
  slots (clean, `abs_approx`) and in the circular mode with a clean input,
  and the CNG phase rows before them, on converged states.

A resized or rebuilt delay estimator and wide steps, against
tests/data/torch_golden_reconfig.npz (tools/make_torch_golden_reconfig.py):
`run_streams_fused` on states resized to 37, 64, 128 and 257 history rows
or rebuilt with lookahead capacity 4 (per-stream lookahead 0..3), and at 3,
4, 5 and 8 chunks a step (8 to 10 block slots, each with a tail) through
`use_kernel=True` (on CPU tensors the plain path); the batch-major engine
on the same resized states.

Port against port, live: `AecmPipeline` on the fused engine == on the
batch-major ("xla") engine, for `run` (with a tail) and `step`, at 8 and
16 kHz, single and clean, after `set_config` and after `reset_streams`;
the 10 ms step with lookahead capacity 4 == the batch-major `ChunkStep`.
And the one refusal left: on the kernel path a history size whose stream
does not fit a thread block.  No test here compiles a JAX function.
"""
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from webrtc_aecm_tpu_torch import convert, fused, fused_kernel
from webrtc_aecm_tpu_torch import delay_estimator as de
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
from webrtc_aecm_tpu_torch.models import AecmPipeline
from webrtc_aecm_tpu_torch.parallel import batch as pbatch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_envelope.npz")
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden_envelope",
    os.path.join(REPO, "tools", "make_torch_golden_envelope.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)    # numpy only at import: the scenes
B = gen.B
GOLDEN_RECONFIG = os.path.join(REPO, "tests", "data",
                               "torch_golden_reconfig.npz")
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden_reconfig",
    os.path.join(REPO, "tools", "make_torch_golden_reconfig.py"))
rgen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rgen)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


@pytest.fixture(scope="module")
def golden_reconfig():
    with np.load(GOLDEN_RECONFIG) as g:
        return {k: g[k] for k in g.files}


def reconfigured_batch(fs, b, history, cap):
    """Fresh batch-major streams whose delay estimator is resized to
    `history` rows and, for cap > 1, rebuilt with lookahead capacity cap
    and per-stream lookahead b mod cap (the golden tool's start)."""
    st = pbatch.create_batch(b, fs, device="cpu")
    dn, df = st.core.de_near, st.core.de_farend
    if history != 100:
        dn, df = de.set_history_size(dn, df, history)
    if cap > 1:
        dn = dn._replace(binary_history=torch.zeros((b, cap),
                                                    dtype=torch.int64),
                         lookahead=torch.arange(b, dtype=torch.int32) % cap)
    return st._replace(core=st.core._replace(de_near=dn, de_farend=df))


def check_reconfig_rsf(golden_reconfig, name, use_kernel=True):
    """run_streams_fused on a golden reconfig entry == the JAX answer."""
    fs, n_chunks, burst, seed, with_clean, history, cap, cps = rgen.RSF[name]
    far, near, clean = rgen.scene(fs, rgen.B, n_chunks, seed, with_clean)
    st = fused.to_fused_state(reconfigured_batch(fs, rgen.B, history, cap))
    fin, out = fused.run_streams_fused(
        st, far, near, fs, rgen.desync_ms(n_chunks, rgen.B, burst),
        use_kernel=use_kernel, clean=clean, chunks_per_step=cps)
    np.testing.assert_array_equal(
        out.numpy(), golden_reconfig[f"rsf.{name}.out"].astype(np.int32))
    assert_state(fused_leaves(fin), golden_reconfig, f"rsf.{name}.state.")


def jax_tree(golden, prefix, like):
    """The JAX leaves stored under `prefix` + dotted path, in the tree
    structure of `like` (a port state), for convert.*_from_numpy."""
    def build(tree, path):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return SimpleNamespace(**{
                f: build(getattr(tree, f), f"{path}{f}.")
                for f in tree._fields})
        return golden[prefix + path[:-1]]
    return build(like, "")


def assert_state(got_np_leaves, golden, prefix):
    """Every leaf of a port state (numpy, JAX dtypes) == the golden's."""
    want = {k[len(prefix):]: v for k, v in golden.items()
            if k.startswith(prefix)}
    assert sorted(p for p, _ in got_np_leaves) == sorted(want)
    for path, a in got_np_leaves:
        assert a.dtype == want[path].dtype, path
        np.testing.assert_array_equal(a, want[path], err_msg=path)


def fused_leaves(state):
    return tree_leaves_with_path(convert.fused_state_to_numpy(state))


def core_leaves(core):
    like = fused.create_fused(1, 8000, device="cpu")
    return tree_leaves_with_path(convert.fused_state_to_numpy(
        like._replace(core=core)).core)


def fused_start(fs, config):
    st = pbatch.create_batch(B, fs, device="cpu")
    if config:
        st = pbatch.set_config_batch(st, *gen.stream_modes(B))
    return fused.to_fused_state(st)


@pytest.mark.parametrize("name", list(gen.RSF))
def test_run_streams_fused_matches_jax(golden, name):
    fs, n_chunks, burst, seed, with_clean, config = gen.RSF[name]
    far, near, clean = gen.scene(fs, B, n_chunks, seed, with_clean)
    ms = gen.desync_ms(n_chunks, B, burst) if not config else 40
    fin, out = fused.run_streams_fused(fused_start(fs, config), far, near,
                                       fs, ms, clean=clean)
    np.testing.assert_array_equal(
        out.numpy(), golden[f"rsf.{name}.out"].astype(np.int32))
    assert_state(fused_leaves(fin), golden, f"rsf.{name}.state.")


@pytest.mark.parametrize("name", list(gen.STEP))
def test_fused_chunk_step_matches_jax(golden, name):
    """The 10 ms real-time step: one chunk, newest-first far history,
    batch-leading input and output, warn of shape (B,)."""
    fs, n_chunks, burst, seed, config, absa = gen.STEP[name]
    chunk = min(160, fs // 100)
    far, near, _ = gen.scene(fs, B, n_chunks, seed)
    ms = (gen.desync_ms(n_chunks, B, burst) if not config
          else np.full((n_chunks, B), 40, np.int32))
    step = fused.make_fused_chunk_step(fs, abs_approx=absa, device="cpu")
    assert (step.cps, step.circular_far, step.lane_major_io) == (1, False,
                                                                 False)
    st, outs, warns = fused_start(fs, config), [], []
    for c in range(n_chunks):
        cols = slice(c * chunk, (c + 1) * chunk)
        st, out, warn = step(st, torch.as_tensor(far[:, cols]),
                             torch.as_tensor(near[:, cols]),
                             torch.as_tensor(ms[c]))
        assert out.shape == (B, chunk) and warn.shape == (B,)
        outs.append(out)
        warns.append(warn)
    np.testing.assert_array_equal(
        torch.cat(outs, 1).numpy(),
        golden[f"step.{name}.out"].astype(np.int32))
    np.testing.assert_array_equal(torch.stack(warns).numpy(),
                                  golden[f"step.{name}.warn"])
    assert_state(fused_leaves(st), golden, f"step.{name}.state.")


def frames_case(golden, name):
    """The port's inputs of a golden frames_step call: the core (the final
    state of its rsf entry, in the circular order at `head` if it has
    one), and the sample inputs; plus the JAX phase rows and new seed."""
    src, n_frames, has_clean, absa, head, _ = gen.FRAMES[name]
    fs = gen.RSF[src][0]
    like = fused.create_fused(B, fs, device="cpu")
    st = convert.fused_state_from_numpy(
        jax_tree(golden, f"rsf.{src}.state.", like), device="cpu")
    core = st.core
    if head >= 0:
        core = fused._to_circular_far(core)
        h3 = core.far_history.view(100, 40, B)
        core = core._replace(
            far_history=torch.roll(h3, head, 0).reshape(-1, B).contiguous(),
            far_q_domains=torch.roll(core.far_q_domains, head, 0
                                     ).contiguous())
    p = f"frames.{name}"
    t = lambda k: torch.as_tensor(golden[f"{p}.{k}"])  # noqa: E731
    args = dict(far=t("far"), noisy=t("noisy"),
                clean=t("clean") if has_clean else None,
                run_rows=t("run_rows"), mult=fs // 8000, n_frames=n_frames,
                has_clean=has_clean, abs_approx=absa,
                fpc=min(160, fs // 100) // 80,
                head=None if head < 0 else head)
    return core, args, t("phase"), torch.as_tensor(
        golden[f"{p}.seed_in"].astype(np.int64))


@pytest.mark.parametrize("name", list(gen.FRAMES))
def test_cng_phases_match_jax(golden, name):
    """_precompute_cng_phases and make_tables at this entry's slot count
    (2 to 5): the phase rows and the advanced seed."""
    core, a, phase, seed = frames_case(golden, name)
    t = fused.make_tables("cpu", fused._n_slots_for(a["n_frames"]))
    got_phase, got_seed = fused._precompute_cng_phases(
        core, a["run_rows"], a["n_frames"], t)
    assert torch.equal(got_phase, phase)
    assert torch.equal(got_seed, seed)


@pytest.mark.parametrize("name", list(gen.FRAMES))
def test_frames_step_matches_jax(golden, name):
    core, a, phase, seed = frames_case(golden, name)
    t = fused.make_tables("cpu", fused._n_slots_for(a["n_frames"]))
    res = fused.frames_step(
        core._replace(seed=seed), t, a["far"], a["noisy"], a["clean"],
        phase, a["run_rows"], a["mult"], a["n_frames"], a["has_clean"],
        a["abs_approx"], a["fpc"], a["head"])
    p = f"frames.{name}"
    assert len(res) == (2 if a["head"] is None else 4)
    np.testing.assert_array_equal(res[1].numpy(), golden[f"{p}.out"])
    if a["head"] is not None:
        np.testing.assert_array_equal(res[2].numpy(), golden[f"{p}.pend_hist"])
        np.testing.assert_array_equal(res[3].numpy(), golden[f"{p}.pend_q"])
    assert_state(core_leaves(res[0]), golden, f"{p}.state.")


@pytest.mark.parametrize("name", list(gen.FRAMES))
def test_frames_kernel_call_matches_jax(golden, name):
    """The frames kernel's wrapper on CPU tensors (its plain version: the
    CNG chain, then frames_step) from the entry's seed before the chain:
    the JAX outputs and state, the advanced seed among them."""
    core, a, _, _ = frames_case(golden, name)
    t = fused.make_tables("cpu", fused._n_slots_for(a["n_frames"]))
    res = fused_kernel.frames_kernel_call(
        core, t, a["far"], a["noisy"], a["clean"], a["run_rows"], a["mult"],
        a["n_frames"], a["has_clean"], a["abs_approx"], a["fpc"], a["head"])
    p = f"frames.{name}"
    assert len(res) == (2 if a["head"] is None else 4)
    np.testing.assert_array_equal(res[1].numpy(), golden[f"{p}.out"])
    if a["head"] is not None:
        np.testing.assert_array_equal(res[2].numpy(), golden[f"{p}.pend_hist"])
        np.testing.assert_array_equal(res[3].numpy(), golden[f"{p}.pend_q"])
    assert_state(core_leaves(res[0]), golden, f"{p}.state.")


def kernel_cng_draws(t, seed, cng, n_act, n_slots):
    """The frames kernel's comfort-noise draws (csrc/frames.cuh `cng_seed`,
    `fetch_slot`, the seed's store) in numpy uint32 arithmetic, from the
    tables the kernel is given: the seed of draw k is
    (A * seed + C) & 0x7FFFFFFF on the low words of lcg_a[k], lcg_c[k] and
    the seed leaf, its phase cos360[i] & 0xFFFF | sin360[i] << 16 at
    i = (359 * (seed_k >> 16)) >> 15.  Returns the packed phase of every
    draw (n_slots*64, B), with 0 where the kernel draws nothing (cng off or
    an inactive slot), and the new seed (1, B) int64."""
    n = n_slots * 64
    low = lambda x: x.numpy().astype(np.uint32)  # noqa: E731 (wraps mod 2^32)
    a, c = low(t.lcg_a)[:n], low(t.lcg_c)[:n]
    seeds = (a * low(seed.reshape(-1))[None] + c) & np.uint32(0x7FFFFFFF)
    idx = (359 * (seeds >> np.uint32(16)).astype(np.int32)) >> 15
    packed = ((low(t.sin360) << np.uint32(16))
              | (low(t.cos360) & np.uint32(0xFFFF))).view(np.int32)
    slot = np.arange(n)[:, None] // 64
    phase = np.where(cng & (slot < n_act), packed[idx], 0)
    last = seeds[np.maximum(n_act * 64 - 1, 0), np.arange(seeds.shape[1])]
    new_seed = np.where(cng & (n_act >= 1), last.astype(np.int64),
                        seed.numpy().reshape(-1))
    return phase, new_seed[None]


@pytest.mark.parametrize("n_frames", [1, 2, 3, 4, 5, 6, 8, 20])
def test_kernel_cng_draws_match_the_chain(n_frames):
    """The kernel's 32-bit draws == _precompute_cng_phases' int64 chain:
    every phase an active slot uses and the advanced seed, at 2 to 5 block
    slots and the general instances' 7, 8, 10 and 25; every active-slot
    count from 0 to the step's slots (fills 0 to 48, 0 to n_frames frames
    running), seeds 0, 2^31 - 1, 2^32 - 1 and random ones, cng on and
    off."""
    n_slots = fused._n_slots_for(n_frames)
    fill, k = np.meshgrid([0, 16, 32, 48], np.arange(n_frames + 1))
    fill, k = np.tile(fill.reshape(-1), 6), np.tile(k.reshape(-1), 6)
    b = fill.size
    rng = np.random.default_rng(n_frames)
    seed = rng.integers(0, 2 ** 31, b)
    seed[:3] = 0, 2 ** 31 - 1, 2 ** 32 - 1
    cng = np.arange(b) % 6 != 5
    core = SimpleNamespace(
        seed=torch.as_tensor(seed[None], dtype=torch.int64),
        cng_mode=torch.as_tensor(cng[None].astype(np.int32)),
        frame_fill=torch.as_tensor(fill[None].astype(np.int32)))
    run_rows = torch.as_tensor(np.arange(n_frames)[:, None]
                               >= n_frames - k[None])
    n_act = (fill + 80 * k) >> 6
    assert set(n_act) == set(range(n_slots + 1))
    t = fused.make_tables("cpu", n_slots)
    phase, new_seed = fused._precompute_cng_phases(core, run_rows, n_frames,
                                                   t)
    want_phase, want_seed = kernel_cng_draws(t, core.seed, cng, n_act,
                                             n_slots)
    drawn = want_phase != 0
    assert drawn.any() and (~drawn).any()
    np.testing.assert_array_equal(phase.numpy()[drawn], want_phase[drawn])
    np.testing.assert_array_equal(new_seed.numpy(), want_seed)
    # a stream draws 64 per active slot: where nothing is drawn the seed
    # is the one it came with
    still = ~cng | (n_act == 0)
    np.testing.assert_array_equal(new_seed.numpy()[0, still], seed[still])


def test_frames_cases_cover_the_modes():
    """The golden frames calls span 2 to 5 block slots, both far-history
    orders, the clean input and abs_approx, and streams that start
    mid-step."""
    slots = {fused._n_slots_for(v[1]) for v in gen.FRAMES.values()}
    assert slots == {2, 3, 4, 5}
    assert {v[4] >= 0 for v in gen.FRAMES.values()} == {True, False}
    assert any(v[2] for v in gen.FRAMES.values())
    assert any(v[3] for v in gen.FRAMES.values())
    _, _, _, run_rows = gen.frames_inputs(8000, 4, False, 0)
    assert (run_rows.any(0) & ~run_rows.all(0)).any()


def test_plain_path_serves_wide_steps(golden):
    """use_kernel=False is the plain path and takes any number of chunks
    per step: 3 chunks (6 frames, 8 block slots) at 16 kHz give the JAX
    answer of the default schedule."""
    fs, n_chunks, burst, seed, with_clean, _ = gen.RSF["16k_clean"]
    far, near, clean = gen.scene(fs, B, n_chunks, seed, with_clean)
    fin, out = fused.run_streams_fused(
        fused.create_fused(B, fs, device="cpu"), far, near, fs,
        gen.desync_ms(n_chunks, B, burst), use_kernel=False, clean=clean,
        chunks_per_step=3)
    np.testing.assert_array_equal(
        out.numpy(), golden["rsf.16k_clean.out"].astype(np.int32))
    assert_state(fused_leaves(fin), golden, "rsf.16k_clean.state.")


# the golden reconfig entries not held by the tests that took the place of
# the refusals (below and in tests/test_torch_pipeline.py)
RECONFIG_ONLY_HERE = ("16k_h37", "8k_h64", "16k_h257_la4", "8k_cps5_h257_la4",
                      "16k_cps10")


@pytest.mark.parametrize("name", RECONFIG_ONLY_HERE)
def test_reconfigured_run_streams_fused_matches_jax(golden_reconfig, name):
    """A resized delay estimator (37 to 257 rows; 257 with lookahead
    capacity 4, also at 5 chunks a step), and 10 chunks a step (25 block
    slots) with a one-chunk tail, through the fused engine."""
    check_reconfig_rsf(golden_reconfig, name, use_kernel=False)


@pytest.mark.parametrize("name", [
    n for n, v in rgen.RSF.items() if v[5] != 100 or v[6] > 1])
def test_reconfigured_batch_engine_matches_jax(golden_reconfig, name):
    """The batch-major engine on the same resized or rebuilt states: the
    JAX package's output, and its final state in the fused layout."""
    fs, n_chunks, burst, seed, with_clean, history, cap, _ = rgen.RSF[name]
    far, near, clean = rgen.scene(fs, rgen.B, n_chunks, seed, with_clean)
    fin, out = pbatch.run_streams(
        reconfigured_batch(fs, rgen.B, history, cap), far, near, fs,
        rgen.desync_ms(n_chunks, rgen.B, burst), clean=clean)
    np.testing.assert_array_equal(
        out.numpy(), golden_reconfig[f"rsf.{name}.out"].astype(np.int32))
    assert_state(fused_leaves(fused.to_fused_state(fin)), golden_reconfig,
                 f"rsf.{name}.state.")


def test_reconfig_entries_cover_the_domain():
    """The golden reconfig runs span history sizes 37 to 257, lookahead
    capacity 4 (at 1 and 2 chunks a step), steps of 3 to 10 chunks at both
    rates (7 to 25 block slots, both far-history orders) with tails, and
    a clean input."""
    v = rgen.RSF.values()
    assert {e[5] for e in v} == {37, 64, 100, 128, 257}
    assert {e[6] for e in v} == {1, 4}
    wide = {(e[0], e[7]) for e in v if e[7] and e[7] > 2}
    assert wide == {(16000, 3), (16000, 4), (16000, 10), (8000, 5),
                    (8000, 8)}
    assert all(e[1] % e[7] for e in v if e[7] and e[7] > 1)   # a tail each
    assert any(e[4] and e[5] != 100 for e in v)


# ---------------------------------------------------------------------------
# fused engine == batch-major engine through AecmPipeline (no JAX)
# ---------------------------------------------------------------------------

def _assert_pipes_equal(p1, p2):
    for (path, a), (_, b) in zip(tree_leaves_with_path(p1._canonical()),
                                 tree_leaves_with_path(p2._canonical())):
        assert torch.equal(a, b), path
    np.testing.assert_array_equal(p1.get_echo_paths(), p2.get_echo_paths())


@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("with_clean", [False, True])
def test_pipeline_engines_agree(fs, with_clean):
    """AecmPipeline(engine="fused") == engine="xla": run (a tail of one
    chunk), step, set_config, run, reset_streams, step."""
    n_b, chunk = 4, min(160, fs // 100)
    n_chunks = (4 if fs == 8000 else 2) * 2 + 1
    far, near, clean = gen.scene(fs, n_b, 2 * n_chunks + 4, seed=9,
                                 with_clean=with_clean)
    p1 = AecmPipeline(n_b, fs, engine="xla", device="cpu")
    p2 = AecmPipeline(n_b, fs, engine="fused", device="cpu")
    assert AecmPipeline(n_b, fs, device="cpu").engine == "xla"
    span = slice(0, n_chunks * chunk)
    cl = (lambda s: None if clean is None else clean[:, s])  # noqa: E731
    for p in (p1, p2):
        p.out1 = p.run(far[:, span], near[:, span], cl(span),
                       np.arange(n_b) * 20 + 30)
    assert torch.equal(p1.out1, p2.out1)
    _assert_pipes_equal(p1, p2)
    at = n_chunks * chunk
    for c in range(2):
        s = slice(at + c * chunk, at + (c + 1) * chunk)
        o1, w1 = p1.step(far[:, s], near[:, s], cl(s), 40)
        o2, w2 = p2.step(far[:, s], near[:, s], cl(s), 40)
        assert torch.equal(o1, o2) and torch.equal(w1, w2)
    _assert_pipes_equal(p1, p2)
    at += 2 * chunk
    span = slice(at, at + n_chunks * chunk)
    for p in (p1, p2):
        p.set_config(np.array([1, 0, 1, 1]), np.array([3, 1, 4, 0]))
        p.out2 = p.run(far[:, span], near[:, span], cl(span), 60)
    assert torch.equal(p1.out2, p2.out2)
    _assert_pipes_equal(p1, p2)
    at += n_chunks * chunk
    s = slice(at, at + chunk)
    for p in (p1, p2):
        p.reset_streams([1, 2])
        p.o3, p.w3 = p.step(far[:, s], near[:, s], cl(s), 700)
    assert torch.equal(p1.o3, p2.o3) and torch.equal(p1.w3, p2.w3)
    assert p1.w3.tolist() == [12100] * n_b
    _assert_pipes_equal(p1, p2)


def test_reset_streams_restores_fresh_state():
    fs, n_b = 8000, 3
    far, near, _ = gen.scene(fs, n_b, 8, seed=4)
    p = AecmPipeline(n_b, fs, engine="fused", device="cpu")
    p.set_config(0, 1)
    p.run(far, near)
    p.reset_streams([0])
    fresh = pbatch.create_batch(n_b, fs, device="cpu")
    for (path, a), (_, b) in zip(tree_leaves_with_path(p._canonical()),
                                 tree_leaves_with_path(fresh)):
        assert torch.equal(a[0], b[0]), path
    assert not torch.equal(p._canonical().core.x_buf[1], fresh.core.x_buf[1])


# ---------------------------------------------------------------------------
# what was refused before, and the one refusal left
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fs", [8000, 16000])
def test_lookahead_above_one_raises_in_the_step(fs):
    """Lookahead capacity 4 (per-stream lookahead 0..3) runs in the 10 ms
    step and gives what the batch-major ChunkStep gives on the same state:
    output, warnings and every state leaf."""
    chunk, n_b, n_chunks = fs // 100, 4, 12
    far, near, _ = gen.scene(fs, n_b, n_chunks, 5)
    ms = gen.desync_ms(n_chunks, n_b, 6)
    st_b = reconfigured_batch(fs, n_b, 100, 4)
    st_f = fused.to_fused_state(st_b)
    step = fused.make_fused_chunk_step(fs, device="cpu")
    chunk_step = pbatch.make_chunk_step(fs, device="cpu")
    for c in range(n_chunks):
        cols = slice(c * chunk, (c + 1) * chunk)
        f, d, m = (torch.as_tensor(x) for x in (far[:, cols], near[:, cols],
                                                ms[c]))
        st_f, out_f, warn_f = step(st_f, f, d, m)
        st_b, out_b, warn_b = chunk_step(st_b, f, d, m)
        np.testing.assert_array_equal(out_f.numpy(), out_b.numpy())
        np.testing.assert_array_equal(warn_f.numpy(), warn_b.numpy())
    for (path, a), (_, b) in zip(
            fused_leaves(st_f),
            fused_leaves(fused.to_fused_state(st_b))):
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("fs,cps", [(16000, 3), (16000, 4), (8000, 5),
                                    (8000, 8)])
def test_more_than_five_slots_on_the_kernel_path_raises(fs, cps,
                                                        golden_reconfig):
    """Steps of more than 5 block slots take the kernel path (on CPU
    tensors its plain version) and give the JAX answer, a tail included."""
    step = fused.FusedAecm(fs, cps, use_kernel=True, device="cpu")
    assert step.circular_far == fused._exact_block(cps * (fs // 100))
    check_reconfig_rsf(golden_reconfig, f"{fs // 1000}k_cps{cps}")


def test_history_size_beyond_a_block_raises():
    """The one refusal left on the kernel path: a delay-estimator history
    size whose one stream does not fit a thread block's shared memory.
    The plain path takes it."""
    limit = fused_kernel.max_history_size(1, False)
    assert (limit, fused_kernel.max_history_size(1, True)) == (10703, 10601)
    assert fused_kernel.stream_words(100, 1, False, general=False) == 3140
    assert fused_kernel.stream_words(100, 1, True, general=False) == 3652
    for history, ok in ((limit, True), (limit + 1, False)):
        st = fused.to_fused_state(reconfigured_batch(16000, 2, history, 1))
        step = fused.FusedAecm(16000, 2, use_kernel=True, device="cpu")
        if ok:
            fused._check_envelope(16000, True, st)
            continue
        with pytest.raises(NotImplementedError,
                           match=f"history size {history}"):
            step(st, 0, *(torch.zeros((2, 320), dtype=torch.int32),) * 2,
                 40)
        with pytest.raises(NotImplementedError, match=str(limit)):
            fused.run_streams_fused(st, np.zeros((2, 320), np.int16),
                                    np.zeros((2, 320), np.int16), 16000)
        fused._check_envelope(16000, False, st)     # the plain path


def test_circular_history_needs_whole_blocks():
    with pytest.raises(ValueError, match="exact-block"):
        fused.FusedAecm(16000, 1, device="cpu", circular_far=True)
    assert not fused.FusedAecm(8000, 2, device="cpu").circular_far
    assert fused.FusedAecm(8000, 4, device="cpu").circular_far
