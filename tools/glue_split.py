#!/usr/bin/env python3
"""The fused step's glue on the card, split by the segment of
`FusedAecm.forward` that issues it.

The benchmark's `glue_device_ms` reads every kernel of a step but the frames
and ring kernels as one number, from replayed CUDA graphs, which run no
Python.  This runs the same step eagerly instead, with the card
synchronised around each segment, under torch.profiler, and attributes
each device operation to the segment whose host interval holds it:

  entry      before the first control chunk (the int32 conversions, ms)
  pointer    `FusedAecm._ctrl_chunk_ptr`, once per chunk (control pointer
             sequence)
  ring       `FusedAecm._ring_pass` (the ring kernel; not glue)
  assembly   after the ring pass up to the CNG chain or, where the step
             runs none, up to the frames kernel (frame assembly, replay,
             the input layout)
  cng        `fused._precompute_cng_phases` (where the step calls it)
  layout     after the CNG chain up to the frames kernel
  frames     `fused_kernel.frames_kernel_call` (the kernel; not glue)
  after      after the kernel (circular placement, passthrough, output)

Each segment: kernels (device operations) and device ms a step, the mean
over the profiled steps.  The synchronisations change no kernel's device
time; they only keep the segments apart.  Run from the repository root on
the machine with the card (no card: it fails):

  python3 tools/glue_split.py --rate 16000 --streams 59392 --cps 1
  python3 tools/glue_split.py --rate 16000 --streams 65536 --cps 2

--cps 1 is the real-time step as `AecmPipeline.step` runs it (batch-leading
audio, newest-first far history); more chunks a step are
`run_streams_fused`'s span step (lane-major audio, circular history where
the step is whole blocks).  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from aecm_bench import trace as T  # noqa: E402
from webrtc_aecm_tpu_torch import fused, fused_kernel  # noqa: E402

SEGMENTS = {"pointer": (fused.FusedAecm, "_ctrl_chunk_ptr"),
            "ring": (fused.FusedAecm, "_ring_pass"),
            "cng": (fused, "_precompute_cng_phases"),
            "frames": (fused_kernel, "frames_kernel_call")}
# an unnamed stretch is named by the segment before it
AFTER = {None: "entry", "pointer": "pointer", "ring": "assembly",
         "cng": "layout", "frames": "after"}


def synced(name, fn):
    def run(*args, **kw):
        torch.cuda.synchronize()
        with torch.profiler.record_function("seg." + name):
            out = fn(*args, **kw)
            torch.cuda.synchronize()
        return out
    return run


def split(data: T.TraceData, n_steps: int) -> dict:
    """{segment: [kernels, device ms]} a step, from the trace's "seg.*"
    spans: each device operation goes to the innermost span around its
    midpoint, an operation of an unnamed stretch of a step to AFTER of the
    named segment before it."""
    steps = [s for s in data.spans if s.name == "seg.step"]
    segs = sorted((s for s in data.spans
                   if s.name.startswith("seg.") and s.name != "seg.step"),
                  key=lambda s: s.ts)
    out = {}
    for op in data.ops:
        mid = op.ts + op.dur / 2
        if not any(s.ts <= mid <= s.end for s in steps):
            continue
        inside = [s for s in segs if s.ts <= mid <= s.end]
        if inside:
            name = inside[0].name[4:]
        else:
            step = next(s for s in steps if s.ts <= mid <= s.end)
            before = [s for s in segs if step.ts <= s.ts and s.end < mid]
            last = max(before, key=lambda s: s.end) if before else None
            name = AFTER[last.name[4:] if last else None]
        n, us = out.get(name, (0, 0.0))
        out[name] = (n + 1, us + op.dur)
    return {k: [n / n_steps, us / 1e3 / n_steps] for k, (n, us) in
            out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rate", type=int, default=16000)
    ap.add_argument("--streams", type=int, default=4096)
    ap.add_argument("--cps", type=int, default=1)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("glue_split: no CUDA card")
    dev = torch.device("cuda")
    b, chunk = a.streams, a.rate // 100
    width = a.cps * chunk
    lane_major = a.cps > 1
    step = fused.FusedAecm(a.rate, a.cps, True, dev, lane_major_io=lane_major,
                           circular_far=lane_major and fused._exact_block(
                               width))
    st = fused.create_fused(b, a.rate, device=dev)
    if step.circular_far:
        st = st._replace(core=fused._to_circular_far(st.core))
    head = torch.zeros((), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(a.seed)
    n = a.warm + a.steps
    far = torch.as_tensor(rng.integers(-8000, 8000, (b, n * width)),
                          dtype=torch.int16, device=dev)
    near = torch.as_tensor(rng.integers(-8000, 8000, (b, n * width)),
                           dtype=torch.int16, device=dev)
    ms = torch.full((a.cps, b), 40, dtype=torch.int32, device=dev)

    def run_step(s):
        nonlocal st, head
        cols = slice(s * width, (s + 1) * width)
        near_s = near[:, cols].T if lane_major else near[:, cols]
        args = (far[:, cols], near_s, ms if a.cps > 1 else ms[0])
        if step.circular_far:
            st, head, _, _ = step(st, head, *args)
        else:
            st, _, _ = step(st, *args)

    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr in SEGMENTS.values()]
    for (name, (owner, attr)), (_, _, fn) in zip(SEGMENTS.items(), saved):
        setattr(owner, attr, synced(name, fn))
    try:
        for s in range(a.warm):
            run_step(s)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("window"):
                for s in range(a.warm, n):
                    torch.cuda.synchronize()
                    with torch.profiler.record_function("seg.step"):
                        run_step(s)
                        torch.cuda.synchronize()
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = T.parse(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)
    segs = split(data, a.steps)
    glue = {k: v for k, v in segs.items() if k not in ("frames", "ring")}
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "rate": a.rate,
        "streams": b, "cps": a.cps, "circular": step.circular_far,
        "steps": a.steps, "segments": segs,
        "glue_ms": sum(v[1] for v in glue.values()),
        "glue_kernels": sum(v[0] for v in glue.values())}), flush=True)


if __name__ == "__main__":
    main()
