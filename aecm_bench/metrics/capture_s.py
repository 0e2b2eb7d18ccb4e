"""capture_s: seconds the compiled steps spent on warm-up and CUDA-graph
capture in set-up (CompiledStep.capture_seconds, summed over the steps the
cell's entry replays), read after set-up."""


def read(run):
    v = run.counters.get("capture_s")
    return None if v is None else float(v)
