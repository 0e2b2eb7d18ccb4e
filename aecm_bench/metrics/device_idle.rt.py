"""device_idle.rt: %, the share of the ticks' service (from the copy in to
the output on the host, the pacing wait left out) in which the device runs
nothing, over the traced window's ticks."""
from aecm_bench import trace as T


def read(run):
    t = run.trace
    if t is None:
        return None
    service = [s for s in t.spans if s.name == "service"]
    total = sum(s.dur for s in service)
    if total <= 0:
        return None
    busy = T.busy_intervals(t.ops)
    used = sum(T.overlap(busy, s.ts, s.end) for s in service)
    return 100.0 * (1.0 - used / total)
