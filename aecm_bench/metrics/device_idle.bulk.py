"""device_idle.bulk: %, the share of the traced window in which the device
runs nothing."""
from aecm_bench import trace as T


def read(run):
    t = run.trace
    if t is None or t.t1 <= t.t0:
        return None
    busy = T.busy_intervals(t.ops)
    return 100.0 * (1.0 - T.overlap(busy, t.t0, t.t1) / (t.t1 - t.t0))
