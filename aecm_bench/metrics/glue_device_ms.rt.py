"""glue_device_ms.rt: device milliseconds a step of every kernel but the
frames kernel and the ring kernels (the fused runner's glue: control
pointer sequence, frame assembly, CNG phases, the entry's conversions),
from the profiler; a step is one launch of the frames kernel."""
from aecm_bench import trace as T


def read(run):
    return T.glue_ms_per_step(run.trace)
