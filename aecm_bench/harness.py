"""The benchmark of webrtc_aecm_tpu_torch: one cell, one run.

    python3 -m aecm_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in BENCHMARK.json; its configuration
(configs/<config>.json), its traffic mix (traffic/<mix>.json, which names
the generator and the drive: drivers/<drive>.py) and its per-layer
metrics' readers (metrics/<metric>.py) are files of their own, found by
name.  A run sets the cell up (scenes from the seed, the pipeline, its
graphs captured, a warm-up), measures for `--seconds`, then frees the
program, works the compared streams out again with the plain reference
(reference/) and compares every output sample (and warning flag) of
theirs.  With `--trace 1` a profiler covers the last `trace_s` seconds of
the window and the result carries the per-layer metrics instead of the
end-to-end ones.

The last line of standard output is the result, one JSON object; the
checks, each with its number and its limit, are the last lines of
standard error and the result's last key.  No card, or a module of JAX or
of the JAX package loaded in this process: an error and no result.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import trace as trace_mod

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "webrtc_aecm_tpu")


class NoResult(Exception):
    """The run cannot give a result; the message says why."""


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port's run must not
    load, compared whole (webrtc_aecm_tpu_torch is another name)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_modules(when: str):
    found = forbidden_modules()
    if found:
        raise NoResult(f"{when}: loaded {', '.join(found)}")


class Cell:
    """One entry of BENCHMARK.json's workloads with its files."""

    def __init__(self, root: Path, name: str, overrides: dict | None = None):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise NoResult(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        self.name = name
        self.chips = w["chips"]
        self.root = root
        here = root / "aecm_bench"
        self.config = json.loads((here / "configs" / f"{w['config']}.json"
                                  ).read_text())
        self.traffic = json.loads((here / "traffic" / f"{w['traffic']}.json"
                                   ).read_text())
        for part, values in (overrides or {}).items():
            getattr(self, part).update(values)

        def mine(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def compared_streams(self, seed: int) -> np.ndarray:
        """The streams whose every output is compared, drawn from the seed:
        the first and the last stream and the rest at random."""
        n, s = self.traffic["n_streams"], self.traffic["compared_streams"]
        rng = np.random.default_rng([seed, 0xC0A4])
        rest = rng.choice(np.arange(1, n - 1), size=max(0, min(s, n) - 2),
                          replace=False)
        return np.unique(np.concatenate([[0, n - 1], rest])).astype(np.int64)

    def driver(self, seed: int, seconds: float, device, tracer):
        mod = importlib.import_module(
            f"aecm_bench.drivers.{self.traffic['drive']}")
        return mod.Driver(self, seed, seconds, device, tracer)

    def counts(self) -> dict | None:
        """The frozen operation and byte counts of the frames kernel in the
        mode this cell's drive runs, if the benchmark has them:
        counts/frames_<rate>_<drive>.json, frames_<rate>_clean_<drive>.json
        where the configuration has two near inputs."""
        clean = "clean_" if self.config["near_inputs"] == 2 else ""
        path = (self.root / "aecm_bench" / "counts" /
                f"frames_{self.config['sample_rate']}_{clean}"
                f"{self.traffic['drive']}.json")
        return json.loads(path.read_text()) if path.exists() else None


def load_reader(root: Path, metric: str):
    path = root / "aecm_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"aecm_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class RunData:
    """What a per-layer reader reads: the trace (None untraced), the
    harness's host spans, the program's counters, and the cell's sizes,
    frozen counts and the card's peaks."""

    def __init__(self, cell, trace, host, counters, steps_traced, peaks):
        self.cell = cell
        self.trace = trace
        self.host = host
        self.counters = counters
        self.steps_traced = steps_traced
        self.n_streams = cell.traffic["n_streams"]
        self.counts = cell.counts()
        self.peaks = peaks


def compare(prog_out, prog_warn, ref_out, ref_warn, chunk: int,
            per_call: int | None):
    """The checks: samples and warning flags that differ from the
    reference, and outputs that never came; and how many answers (a stream's
    tick, or a stream's call of per_call chunks) are wrong or missing."""
    k = ref_out.shape[0]
    got = prog_out.shape[0]
    missing = max(0, k - got)
    ref_out = np.asarray(ref_out)
    bad = np.zeros(ref_out.shape, bool)
    bad[:got] = prog_out[:k] != ref_out[:got]
    bad[got:] = True
    wrong = bad.any(axis=2)                       # (K, S)
    bad_warn = 0
    if prog_warn is not None:
        wb = np.asarray(prog_warn)[:min(k, got)] != np.asarray(ref_warn)[:got]
        bad_warn = int(wb.sum())
        wrong[:got] |= wb
    if per_call:
        wrong = wrong.reshape(-1, per_call, wrong.shape[1]).any(axis=1)
    checks = {"bad_samples": [int(bad[:got].sum()), 0],
              "bad_warnings": [bad_warn, 0],
              "missing_chunks": [missing * ref_out.shape[1], 0]}
    return checks, int(wrong.sum())


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = ROOT, t_proc0: float | None = None,
             program_patch=None, out=sys.stdout, err=sys.stderr) -> dict:
    """One run of one cell; returns the result (and prints it as the last
    line of `out`).  program_patch(driver), if given, is called once the
    pipeline exists (tests and the control use it to change the program)."""
    t0 = time.perf_counter() if t_proc0 is None else t_proc0
    device = torch.device(device)
    cell = Cell(root, workload)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device: torch.cuda.is_available() is "
                           "false")
        if torch.cuda.device_count() < cell.chips:
            raise NoResult(f"the cell asks for {cell.chips} cards, "
                           f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    peaks = json.loads((root / "aecm_bench" / "peaks.json").read_text())
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    tracer = trace_mod.Tracer(trace)
    drv = cell.driver(seed, seconds, device, tracer)
    drv.program_patch = program_patch
    pre_setup_s = time.perf_counter() - t0
    counters = drv.setup()
    tracer.warm()
    if device.type == "cuda":
        torch.cuda.synchronize()
        # the window's own peak: set-up's scenes are freed or on the host
        torch.cuda.reset_peak_memory_stats(device)
    check_modules("after set-up")
    gc.collect()
    gc.freeze()
    gc.disable()
    setup_s = time.perf_counter() - t0
    try:
        win = drv.window()
    finally:
        gc.enable()
        gc.unfreeze()
    check_modules("after the window")
    tdata = tracer.read()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        data = RunData(cell, tdata, drv.host_spans(), counters,
                       win["steps_traced"], peaks.get(kind))
        for m in cell.per_layer:
            v = load_reader(root, m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    drv.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prog_out, prog_warn, (far, near, ms, clean) = drv.compared()
    from .reference import Reference
    t_ref = time.perf_counter()
    cfg = cell.config
    ref_out, ref_warn = Reference(far.shape[1], cfg["sample_rate"], device,
                                  cfg["cng_mode"], cfg["echo_mode"]
                                  ).run(far, near, ms, clean)
    ref_s = time.perf_counter() - t_ref
    chunk = cell.config["chunk_samples"]
    per_call = (None if prog_warn is not None else
                int(round(cell.config["bulk_call_s"] *
                          cell.config["sample_rate"])) // chunk)
    checks, wrong = compare(prog_out, prog_warn, ref_out.numpy(),
                            None if ref_warn is None else ref_warn.numpy(),
                            chunk, per_call)
    correct = all(v <= lim for v, lim in checks.values())

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    if trace and tdata is not None:
        busy = trace_mod.busy_intervals(tdata.ops)
        dev["busy_s"] = sum(b - a for a, b in busy) / 1e6
        dev["window_s"] = tdata.window_s
    notes = dict(win["notes"], setup_s=setup_s, pre_setup_s=pre_setup_s,
                 reference_s=ref_s,
                 compared_streams=int(far.shape[1]),
                 compared_chunks=int(far.shape[0]),
                 capture_s=counters.get("capture_s"), seed=seed)
    print("notes " + json.dumps(notes), file=out, flush=True)
    result = {"correct": correct, "attempted": int(win["attempted"]),
              "failed": wrong, "metrics": metrics, "device": dev}
    if trace and tdata is not None:
        result["breakdown"] = {"device_ops": trace_mod.device_ops(tdata),
                               "idle_gaps": trace_mod.idle_gaps(tdata)}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv=None, t_proc0: float | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m aecm_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                 t_proc0=t_proc0)
    except NoResult as e:
        print(f"aecm_bench: {e}", file=sys.stderr, flush=True)
        return 2
    return 0
