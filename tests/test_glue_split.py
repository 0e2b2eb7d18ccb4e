"""tools/glue_split.py's attribution of device operations to the segments
of FusedAecm.forward, on synthetic traces (the tool itself needs a card):
an operation goes to the segment span around its midpoint, one in an
unnamed stretch of a step to the stretch named by the segment before it,
and one outside every step to none."""
import importlib.util
import os

import pytest

from aecm_bench import trace as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "glue_split", os.path.join(REPO, "tools", "glue_split.py"))
gs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gs)


def span(name, ts, dur):
    return T.Op("seg." + name, "span", float(ts), float(dur))


def kernel(ts, dur):
    return T.Op("k", "kernel", float(ts), float(dur))


def step_trace(t, with_cng):
    """One step at time t: entry 0..10, pointer 10..40, ring 40..50,
    assembly 50..60, cng 60..80, layout 80..90 (without cng: assembly
    50..90), frames 90..190, after 190..200; one kernel in each, 4 us."""
    spans = [span("step", t, 200), span("pointer", t + 10, 30),
             span("ring", t + 40, 10), span("frames", t + 90, 100)]
    ops = [kernel(t + x, 4) for x in (2, 20, 42, 52, 92, 194)]
    if with_cng:
        spans.append(span("cng", t + 60, 20))
        ops += [kernel(t + 64, 4), kernel(t + 82, 4)]
    else:
        ops.append(kernel(t + 82, 4))
    return spans, ops


@pytest.mark.parametrize("with_cng", [True, False])
def test_glue_split_names_each_operation(with_cng):
    spans, ops = [], []
    for t in (1000, 2000):
        s, o = step_trace(t, with_cng)
        spans += s
        ops += o
    ops.append(kernel(500, 4))   # between steps: no segment
    got = gs.split(T.TraceData(sorted(ops, key=lambda o: o.ts), spans, 0.0,
                               3000.0), 2)
    want = {"entry": [1, 0.004], "pointer": [1, 0.004],
            "ring": [1, 0.004], "frames": [1, 0.004], "after": [1, 0.004]}
    if with_cng:
        want.update(assembly=[1, 0.004], cng=[1, 0.004],
                    layout=[1, 0.004])
    else:
        want.update(assembly=[2, 0.008])
    assert got == pytest.approx(want)
