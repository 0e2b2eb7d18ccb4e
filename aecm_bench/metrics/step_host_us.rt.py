"""step_host_us.rt: host microseconds from the call into AecmPipeline.step
to its return (before any wait for the card), mean over the window's ticks:
the harness's span around the call (entry and compiled-step layers)."""
import numpy as np


def read(run):
    host = run.host.get("step_host_s")
    if host is None or len(host) == 0:
        return None
    return float(np.mean(host) * 1e6)
