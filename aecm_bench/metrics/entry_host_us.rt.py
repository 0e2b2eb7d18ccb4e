"""entry_host_us.rt: host microseconds a tick in AecmPipeline.step outside
the graph's replay: the audio's int32 conversions, the expansion of ms,
the compiled step's flatten and key, the copies into its static buffers
and the clones of its outputs.  The program's span `aecm.step` less its
`aecm.compiled.replay` children (webrtc_aecm_tpu_torch/tracing.py), mean
over the traced window's steps.

The profiler's record of every host operation inside the span makes it
read above the host's own clock (PERF.md section 5).  Nothing where the
window has no `aecm.step` (a program without the spans) or no replay: the
eager step launches each kernel from inside `aecm.step`, so the step less
its replay would be the whole step's launches, not the entry's time."""


def read(run):
    t = run.trace
    if t is None or not any(s.name == "aecm.compiled.replay"
                            for s in t.spans):
        return None
    steps = [s for s in t.spans if s.name == "aecm.step"]
    if not steps:
        return None
    return sum(s.dur - sum(r.dur for r in t.spans
                           if r.name == "aecm.compiled.replay"
                           and s.ts <= r.ts and r.end <= s.end)
               for s in steps) / len(steps)
