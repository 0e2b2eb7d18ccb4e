"""copy_ms.rt: device milliseconds a tick of host-to-device and
device-to-host copies (the transfers layer), from the profiler's copy
records in the traced window."""


def read(run):
    t = run.trace
    if t is None or not run.steps_traced:
        return None
    us = sum(o.dur for o in t.ops if o.cat == "gpu_memcpy"
             and ("HtoD" in o.name or "DtoH" in o.name))
    return us / 1e3 / run.steps_traced
