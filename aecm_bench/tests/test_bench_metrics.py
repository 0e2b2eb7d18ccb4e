"""Each per-layer reader computes its number from a small synthetic trace,
and finds nothing (None) where there is nothing to read."""
import json

import numpy as np
import pytest
import torch

from aecm_bench import trace as T
from aecm_bench.harness import ROOT, load_reader
from aecm_bench.tests.conftest import BENCH

FRAMES = "void aecm::frames_step_kernel<false, false, false>(Ctx)"


def op(name, cat, ts, dur):
    return T.Op(name, cat, float(ts), float(dur))


def synthetic():
    """Two ticks of 1000 us: in each, a copy in (50 us), two glue kernels
    (20 and 30 us), the frames kernel (200 us), a ring pass (10 us) and a
    copy out (40 us); the service spans cover 400 us of each tick."""
    ops, spans = [], []
    for k in range(2):
        t = 1000 * k
        ops += [op("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t, 50),
                op("elementwise_kernel", "kernel", t + 60, 20),
                op("ring_multi_pass_kernel", "kernel", t + 80, 10),
                op(FRAMES, "kernel", t + 100, 200),
                op("index_kernel", "kernel", t + 300, 30),
                op("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", t + 330,
                   40)]
        spans += [op("service", "span", t, 400),
                  op("step_call", "span", t + 50, 100),
                  op("wait_tick", "span", t + 400, 600)]
    return T.TraceData(sorted(ops, key=lambda o: o.ts), spans, 0.0, 2000.0)


class Run:
    def __init__(self, trace, n_streams=4096, counts=None, peaks=None):
        self.trace = trace
        self.host = {"step_host_s": np.array([100e-6, 300e-6])}
        self.counters = {"capture_s": 0.25}
        self.steps_traced = 2
        self.n_streams = n_streams
        self.counts = counts
        self.peaks = peaks


def read(name, run):
    return load_reader(ROOT, name)(run)


def test_readers_on_a_synthetic_trace():
    run = Run(synthetic())
    assert read("step_host_us.rt", run) == pytest.approx(200.0)
    assert read("copy_ms.rt", run) == pytest.approx(0.090)
    assert read("glue_device_ms.rt", run) == pytest.approx(0.050)
    assert read("glue_device_ms.bulk", run) == pytest.approx(0.050)
    # busy in service: 0..50, 60..90, 100..370: 350 of 400 us
    assert read("device_idle.rt", run) == pytest.approx(12.5)
    # busy 2 x 350 of 2000 us
    assert read("device_idle.bulk", run) == pytest.approx(65.0)
    assert read("capture_s", run) == 0.25


def test_frames_roofline_from_frozen_counts():
    counts = json.loads((BENCH / "counts" / "frames_16000_step.json"
                         ).read_text())
    peaks = json.loads((BENCH / "peaks.json").read_text())[
        "NVIDIA H100 80GB HBM3"]
    run = Run(synthetic(), 4096, counts, peaks)
    bound = 53684 * 4096 / 3.35e12
    want = 100 * bound / 200e-6
    assert read("frames_roofline.rt", run) == pytest.approx(want)
    assert read("frames_roofline.bulk", run) == pytest.approx(want)
    assert read("frames_roofline.rt", Run(synthetic(), 4096, counts,
                                          None)) is None


def test_nothing_to_read_gives_nothing():
    run = Run(None)
    for name in ("copy_ms.rt", "glue_device_ms.rt", "glue_device_ms.bulk",
                 "frames_roofline.rt", "frames_roofline.bulk",
                 "device_idle.rt", "device_idle.bulk"):
        assert read(name, run) is None
    empty = T.TraceData([], [], 0.0, 10.0)
    assert read("glue_device_ms.rt", Run(empty)) is None
    assert read("frames_roofline.rt", Run(empty, counts={}, peaks={})) \
        is None


def test_breakdown_and_parse():
    t = synthetic()
    ops = dict(T.device_ops(t))
    assert ops[FRAMES] == pytest.approx(400e-6)
    gaps = T.idle_gaps(t)
    assert gaps[0] == ["wait_tick", pytest.approx(630e-6)]
    events = [{"ph": "X", "cat": "user_annotation", "name": "window",
               "ts": 0, "dur": 2000}]
    events += [{"ph": "X", "cat": o.cat, "name": o.name, "ts": o.ts,
                "dur": o.dur} for o in t.ops]
    events += [{"ph": "X", "cat": "user_annotation", "name": s.name,
                "ts": s.ts, "dur": s.dur} for s in t.spans]
    events.append({"ph": "X", "cat": "kernel", "name": "late", "ts": 1990,
                   "dur": 50})
    parsed = T.parse(events)
    assert [o.name for o in parsed.ops] == [o.name for o in t.ops]
    assert len(parsed.spans) == len(t.spans) and parsed.t1 == 2000


def test_every_per_layer_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(load_reader(ROOT, m["name"]))


def test_capture_s_counts_the_steps_the_cell_calls():
    """capture_s sums CompiledStep.capture_seconds over the steps that the
    warm-up called: the step of AecmPipeline.step, the span steps of run."""
    from webrtc_aecm_tpu_torch.compiled import CompiledStep
    from webrtc_aecm_tpu_torch.models import AecmPipeline
    from aecm_bench.drivers import capture_seconds, steps_called
    pipe = AecmPipeline(2, 8000, engine="fused", device="cpu")
    x = torch.zeros((2, 80), dtype=torch.int16)
    with steps_called() as steps:
        pipe.step(x, x)
    assert len(steps) == 1
    assert all(isinstance(s, CompiledStep) for s in steps.values())
    with steps_called() as steps:
        pipe.run(torch.zeros((2, 800), dtype=torch.int32),
                 torch.zeros((2, 800), dtype=torch.int32))
    assert len(steps) >= 1 and capture_seconds(steps) >= 0.0
    assert CompiledStep.__call__.__name__ == "__call__"
