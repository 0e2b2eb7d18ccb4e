"""The port's spans and counters (webrtc_aecm_tpu_torch/tracing.py), on the
CPU.

* With no profiler recording, `tracing.span` returns the one shared no-op
  object.
* Under `torch.profiler.profile`, on the static-buffer path (what the card
  captures, without the capture), `AecmPipeline.step` on both engines
  gives `aecm.step` around its inputs and the compiled step's key, copies,
  replay and outputs, in that order; its first call gives
  `aecm.compiled.capture`; `run` gives `aecm.run` around its inputs, the
  replays' spans and its outputs.
* Outputs and state with a profiler recording == without, bit for bit.
* `tracing.counters()` reads the kernel wrappers' launch counters and the
  live compiled steps' graphs, replays and capture seconds; a replay adds
  the launches its graph holds to the wrappers' counters.

No test here imports JAX.
"""
import gc
from typing import NamedTuple

import pytest
import torch

from webrtc_aecm_tpu_torch import compiled, tracing
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
from webrtc_aecm_tpu_torch.models import AecmPipeline

torch.set_num_threads(1)

B, CHUNK, N_CHUNKS = 8, 160, 4
STEP_SPANS = ["aecm.step.inputs", "aecm.compiled.key",
              "aecm.compiled.copy_in", "aecm.compiled.replay",
              "aecm.compiled.outputs"]


@pytest.fixture(scope="module")
def audio():
    g = torch.Generator().manual_seed(14)
    far, near = (torch.randint(-4000, 4000, (B, N_CHUNKS * CHUNK),
                               generator=g, dtype=torch.int32)
                 for _ in range(2))
    return far, near


@pytest.fixture
def static():
    with compiled.static_buffers_on_cpu():
        yield


class Span(NamedTuple):
    name: str
    start: int    # ns
    end: int


def _profiled(fn):
    """fn() under a CPU profiler; (its result, the aecm.* spans it
    recorded, by start time).  The spans are read from the profiler's raw
    results: building its Python event list takes seconds a step."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = fn()
    spans = [Span(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("aecm.")]
    return res, sorted(spans, key=lambda e: (e.start, -e.end))


def _inside(outer, spans):
    """The spans whose time lies within `outer`'s, in order."""
    return [e for e in spans if e is not outer
            and outer.start <= e.start and e.end <= outer.end]


def _step(pipe, far, near, c):
    cols = slice(c * CHUNK, (c + 1) * CHUNK)
    return pipe.step(far[:, cols], near[:, cols], ms_in_sndcard_buf=40)


def test_span_off_is_the_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = tracing.span("step"), tracing.span("compiled.key")
    assert a is tracing.OFF and b is tracing.OFF
    with a as got:
        assert got is None
    # nothing recorded: a profiler started after the spans finds none
    _, events = _profiled(lambda: torch.zeros(4).add_(1))
    assert events == []


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_step_spans(static, audio, engine):
    """The first call is the capture; the second one's spans nest in
    aecm.step in the order the work runs."""
    far, near = audio
    pipe = AecmPipeline(B, 16000, engine=engine, device="cpu")
    _, first = _profiled(lambda: _step(pipe, far, near, 0))
    assert [e.name for e in first] == [
        "aecm.step", "aecm.step.inputs", "aecm.compiled.key",
        "aecm.compiled.capture", "aecm.compiled.outputs"]
    _, events = _profiled(lambda: _step(pipe, far, near, 1))
    assert [e.name for e in events] == ["aecm.step"] + STEP_SPANS
    assert [e.name for e in _inside(events[0], events)] == STEP_SPANS
    # each ends before the next begins
    for a, b in zip(events[1:], events[2:]):
        assert a.end <= b.start


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_run_spans(static, audio, engine):
    """run: aecm.run around its inputs, one key / copy_in or capture /
    replay / outputs group a step, and its outputs."""
    far, near = audio
    pipe = AecmPipeline(B, 16000, engine=engine, device="cpu")
    pipe.run(far, near)                         # the steps' captures
    _, events = _profiled(lambda: pipe.run(far, near))
    assert events[0].name == "aecm.run"
    inner = _inside(events[0], events)
    assert inner == events[1:]
    steps = N_CHUNKS // 2 if engine == "fused" else N_CHUNKS
    assert [e.name for e in inner] == (
        ["aecm.run.inputs"] + ["aecm.compiled.key", "aecm.compiled.copy_in",
                               "aecm.compiled.replay",
                               "aecm.compiled.outputs"] * steps
        + ["aecm.run.outputs"])


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_tracing_changes_nothing(static, audio, engine):
    """Outputs, warnings and every state leaf with a profiler recording ==
    without one, through steps and a run."""
    far, near = audio
    pipes = [AecmPipeline(B, 16000, engine=engine, device="cpu")
             for _ in range(2)]

    def serve(pipe):
        res = [_step(pipe, far, near, c) for c in range(2)]
        return res, pipe.run(far[:, :2 * CHUNK], near[:, :2 * CHUNK])
    off = serve(pipes[0])
    on, events = _profiled(lambda: serve(pipes[1]))
    assert events
    for (o_off, w_off), (o_on, w_on) in zip(off[0], on[0]):
        assert torch.equal(o_off, o_on) and torch.equal(w_off, w_on)
    assert torch.equal(off[1], on[1])
    la, lb = (tree_leaves_with_path(p.state) for p in pipes)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), path


def test_counters(static, audio):
    """counters() == the wrappers' launch counters, and its graphs,
    replays and capture seconds move by what a new pipeline's step does;
    a replay adds its graph's launches to the wrappers'."""
    far, near = audio
    c = tracing.counters()
    for w in tracing.LAUNCH_COUNTERS:
        assert c[f"{w.__name__}.launches"] == w.launches
    gc.collect()                    # no step of an earlier test dies below
    before = tracing.counters()
    pipe = AecmPipeline(B, 16000, engine="fused", device="cpu")
    for k in range(3):
        _step(pipe, far, near, k)
    step = pipe._step[False]
    assert step in tracing.live_steps
    after = tracing.counters()
    assert (after["graphs"] - before["graphs"], step.n_graphs) == (1, 1)
    assert (after["replays"] - before["replays"], step.replays) == (3, 3)
    assert after["capture_s"] - before["capture_s"] == pytest.approx(
        step.capture_seconds, abs=1e-9)

    # a graph's replay: its launches added in place, the replay counted
    class Graph:
        def replay(self):
            pass
    entry = next(iter(step._entries.values()))
    frames, ring = tracing.LAUNCH_COUNTERS[0], tracing.LAUNCH_COUNTERS[2]
    saved = [w.launches for w in tracing.LAUNCH_COUNTERS]
    entry.graph, entry.launches = Graph(), ((frames, 1), (ring, 2))
    try:
        step._replay(entry, None)
        step._replay(entry, None)
        now = tracing.counters()
        assert now[f"{frames.__name__}.launches"] == saved[0] + 2
        assert now[f"{ring.__name__}.launches"] == saved[2] + 4
        assert now["replays"] - after["replays"] == 2
    finally:
        for w, n in zip(tracing.LAUNCH_COUNTERS, saved):
            w.launches = n
