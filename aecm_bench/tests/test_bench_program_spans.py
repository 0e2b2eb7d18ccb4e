"""The reader of the port's own spans (entry_host_us.rt): its value on a
synthetic trace with `aecm.*` spans inside the harness's `step_call`,
nothing without such spans, a gap inside the compiled step's key named by
that span, and the metric reported by a traced CPU run of a real-time
cell on the static-buffer path."""
import io

import pytest

from aecm_bench import trace as T
from aecm_bench.harness import load_reader, run_cell
from aecm_bench.tests.conftest import ROOT
from aecm_bench.tests.test_bench_metrics import Run, op
from aecm_bench.tests.test_bench_metrics import synthetic as no_program

NAME = "entry_host_us.rt"


def synthetic():
    """Two ticks of 1000 us.  Host: step_call 50..350, inside it aecm.step
    60..340 with its inputs (62..82), key (85..145), copy_in (150..160),
    replay (165..265 in the first tick, 165..305 in the second) and
    outputs.  Device: a copy in 0..50, the frames kernel 200..300, a glue
    kernel 310..330, a copy out 400..440."""
    ops, spans = [], []
    for k, replay in enumerate((100, 140)):
        t = 1000 * k
        ops += [op("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t, 50),
                op("frames_step_kernel", "kernel", t + 200, 100),
                op("elementwise_kernel", "kernel", t + 310, 20),
                op("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", t + 400,
                   40)]
        spans += [op("service", "span", t, 440),
                  op("step_call", "span", t + 50, 300),
                  op("aecm.step", "span", t + 60, 280),
                  op("aecm.step.inputs", "span", t + 62, 20),
                  op("aecm.compiled.key", "span", t + 85, 60),
                  op("aecm.compiled.copy_in", "span", t + 150, 10),
                  op("aecm.compiled.replay", "span", t + 165, replay),
                  op("aecm.compiled.outputs", "span", t + 170 + replay, 25),
                  op("wait_tick", "span", t + 440, 560)]
    return T.TraceData(sorted(ops, key=lambda o: o.ts), spans, 0.0, 2000.0)


def read(run):
    return load_reader(ROOT, NAME)(run)


def test_reader_on_a_synthetic_trace():
    # aecm.step 280 us less its replay (100, 140)
    assert read(Run(synthetic())) == pytest.approx(160.0)


def test_nothing_without_the_programs_spans():
    assert read(Run(None)) is None
    assert read(Run(no_program())) is None
    # the eager step: aecm.step without a replay in it
    t = synthetic()
    eager = t._replace(spans=[s for s in t.spans
                              if s.name != "aecm.compiled.replay"])
    assert read(Run(eager)) is None


def test_a_gap_in_the_key_is_named_by_it():
    """The device idles from the copy in's end (50) to the frames kernel
    (200); the gap's middle, 125, lies in aecm.compiled.key."""
    gaps = T.idle_gaps(synthetic())
    assert ["aecm.compiled.key", pytest.approx(150e-6)] in gaps
    assert all(name != "step_call" for name, _ in gaps)


def test_a_traced_cpu_run_reports_it(tiny):
    """On the static-buffer path the CPU replays the step's body in the
    graph's place, so a traced run of a real-time cell has every span."""
    from webrtc_aecm_tpu_torch import compiled
    with compiled.static_buffers_on_cpu():
        res = run_cell("nb8k.rt", 2**31 + 77, 0.1, True, device="cpu",
                       root=tiny, out=io.StringIO(), err=io.StringIO())
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m[NAME] > 0
