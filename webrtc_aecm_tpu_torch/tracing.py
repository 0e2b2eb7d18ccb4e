"""What the port records about its own work: spans and counters.

`span(name)` names a piece of the serving path's host work.  While no torch
profiler records (the flag `torch.autograd.profiler._is_profiler_enabled`,
which `torch.profiler.profile` and `torch.autograd.profiler.emit_nvtx` both
set) it returns one shared object that does nothing: a flag read, no
allocation and no dispatcher call.  While one records it returns
`torch.profiler.record_function("aecm." + name)`, so the span lands in the
profiler's trace beside the device operations, on the same clock (and
becomes an NVTX range under `emit_nvtx`).  The spans:

  aecm.step               the whole AecmPipeline.step
  aecm.step.inputs        its int32 conversions and the expansion of ms
  aecm.run                the whole run_streams_fused / run_streams
  aecm.run.inputs         their int32 conversions, ms and the state's copy
  aecm.run.outputs        the join and transpose of the outputs, the copy
                          of the state returned
  aecm.compiled.key       a compiled step's flatten of its arguments and
                          the lookup of their signature
  aecm.compiled.capture   a signature's first call: static buffers,
                          warm-up, capture, first replay
  aecm.compiled.copy_in   the copies into the static input buffers
  aecm.compiled.replay    the graph's replay and its launch bookkeeping
                          (on the CPU's static-buffer path: the body)
  aecm.compiled.outputs   the outputs cloned out and rebuilt

A replay runs no Python, so the stages inside a graph cannot be spans.

`counters()` reads the stores the port already keeps, as one flat dict:
each kernel wrapper's `.launches` (under `<wrapper>.launches`) and, over
every live compiled step, the graphs captured, the replays and the capture
seconds.
"""
from __future__ import annotations

import weakref

import torch
from torch.autograd import profiler as _profiler

from . import fused_kernel
from .ops import ring_kernels

# the kernel wrappers whose `.launches` count launches of the CUDA kernels
LAUNCH_COUNTERS = (fused_kernel._FRAMES, ring_kernels._RING,
                   ring_kernels._PASS, ring_kernels._WRITE,
                   ring_kernels._READ)

# every CompiledStep alive (CompiledStep.__init__ adds itself)
live_steps = weakref.WeakSet()


class _Off:
    """The span while no profiler records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def span(name: str):
    """A context manager naming the block `aecm.<name>` in a recording
    profiler's trace; the shared no-op OFF otherwise."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return torch.profiler.record_function("aecm." + name)


def counters() -> dict:
    """The launch counters of the five kernel wrappers, and `graphs`,
    `replays` and `capture_s` summed over the live compiled steps."""
    out = {f"{w.__name__}.launches": w.launches for w in LAUNCH_COUNTERS}
    steps = list(live_steps)
    out["graphs"] = sum(s.n_graphs for s in steps)
    out["replays"] = sum(s.replays for s in steps)
    out["capture_s"] = sum(s.capture_seconds for s in steps)
    return out
