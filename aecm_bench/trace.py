"""The traced run: a torch.profiler window, read back as plain lists.

`Tracer` opens a profiler (CPU and CUDA activities) over the last part of
the measured window and names the harness's own host spans with
`record_function`; `Tracer.read()` exports the trace and returns a
`TraceData`: every device operation (kernels, copies, sets) and every host
span, in microseconds on the profiler's clock.  The per-layer readers in
metrics/ and the breakdown work on that alone.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Op(NamedTuple):
    name: str
    cat: str
    ts: float     # us
    dur: float    # us

    @property
    def end(self) -> float:
        return self.ts + self.dur


class TraceData(NamedTuple):
    ops: list       # device operations in the window, Op
    spans: list     # host spans in the window, Op (cat "span")
    t0: float       # the window, us
    t1: float

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6


class Tracer:
    """Spans are profiler annotations while the profiler runs, nothing
    otherwise; start()/stop() bracket the traced window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.prof = None

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self):
        """Start and stop a profiler once in set-up, so that its one-time
        initialisation stays out of the window."""
        if self.enabled:
            with self._profile():
                torch.zeros(1, device="cuda" if torch.cuda.is_available()
                            else "cpu").add_(1)

    def start(self):
        if not self.enabled or self.active:
            return
        self.prof = self._profile()
        self.prof.__enter__()
        self.active = True
        self._window = torch.profiler.record_function("window")
        self._window.__enter__()

    def stop(self):
        if not self.active:
            return
        self._window.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.active = False

    def read(self) -> TraceData | None:
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return parse(events)


def parse(events) -> TraceData:
    """TraceData from chrome-trace events: the "window" annotation bounds
    it; device operations and host spans inside it are kept."""
    ops, spans, win = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        op = Op(str(e.get("name", "")), e.get("cat", ""), float(e["ts"]),
                float(e["dur"]))
        if op.cat in DEVICE_CATS:
            ops.append(op)
        elif op.cat == "user_annotation":
            if op.name == "window":
                win = op
            else:
                spans.append(op._replace(cat="span"))
    if win is None:
        raise RuntimeError("the trace has no window annotation")
    inside = [o for o in ops if o.ts >= win.ts and o.end <= win.end]
    spans = [s for s in spans if s.ts >= win.ts and s.end <= win.end]
    inside.sort(key=lambda o: o.ts)
    return TraceData(inside, spans, win.ts, win.end)


# --- helpers the readers share -------------------------------------------

def is_frames(name: str) -> bool:
    return "frames_step_kernel" in name


def is_ring(name: str) -> bool:
    return "ring_multi_pass_kernel" in name or "ring_write_kernel" in name \
        or "ring_read_kernel" in name


def busy_intervals(ops) -> list:
    """The union of the operations' intervals, sorted, as [start, end]."""
    out = []
    for o in sorted(ops, key=lambda o: o.ts):
        if out and o.ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end)
        else:
            out.append([o.ts, o.end])
    return out


def overlap(intervals, lo: float, hi: float) -> float:
    """Length of the union `intervals` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in intervals)


def idle_gaps(t: TraceData, top: int = 10) -> list:
    """The longest gaps in which the device ran nothing, each named by the
    innermost host span that covers its middle: [[name, seconds], ...]."""
    busy = busy_intervals(t.ops)
    edges = [t.t0] + [x for iv in busy for x in iv] + [t.t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        cover = [s for s in t.spans if s.ts <= mid <= s.end]
        name = min(cover, key=lambda s: s.dur).name if cover else "none"
        named.append([name, (b - a) / 1e6])
    return named


def device_ops(t: TraceData, top: int = 10) -> list:
    """The device operations that took the most time, summed by name:
    [[name, seconds], ...]."""
    by = {}
    for o in t.ops:
        by[o.name] = by.get(o.name, 0.0) + o.dur
    best = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e6] for k, v in best]


def glue_ms_per_step(t: TraceData | None):
    """Device ms of every kernel but the frames and ring kernels, per
    launch of the frames kernel; None without a trace or a launch."""
    if t is None:
        return None
    kernels = [o for o in t.ops if o.cat == "kernel"]
    steps = sum(1 for o in kernels if is_frames(o.name))
    if not steps:
        return None
    us = sum(o.dur for o in kernels
             if not is_frames(o.name) and not is_ring(o.name))
    return us / 1e3 / steps


def frames_roofline(run):
    """%: the frames kernel's bound over its mean device time a launch; the
    bound is the larger of bytes over the memory rate and integer
    operations over the int32 rate, from the cell's frozen counts and the
    card's peaks.  None where either is missing or nothing was launched."""
    t, counts, peaks = run.trace, run.counts, run.peaks
    if t is None or counts is None or peaks is None:
        return None
    times = [o.dur for o in t.ops if o.cat == "kernel" and is_frames(o.name)]
    if not times:
        return None
    bound = frames_bound_s(counts, peaks, run.n_streams)
    return 100.0 * bound / (sum(times) / len(times) / 1e6)


def frames_bound_s(counts: dict, peaks: dict, n_streams: int) -> float:
    ops_rate = (peaks["sms"] * peaks["int32_lanes_per_sm"]
                * peaks["sm_clock_max_hz"])
    return max(counts["bytes_per_stream"] * n_streams
               / peaks["memory_bytes_per_s"],
               counts["ops_per_stream"] * n_streams / ops_rate)
