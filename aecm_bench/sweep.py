"""Sweeps that fix a traffic file's stream count (run once, by hand, on
the card; never by the benchmark's runs).

    python3 -m aecm_bench.sweep --workload wb16k.rt --streams 8192,16384 \\
        --seconds 5 [--seed 1]

For each stream count the cell is set up and measured as a run would be,
with the count (and a 1 s scene period for the real-time drive, whose
pool is pinned host memory) overridden, the garbage collector held off
over the window as in a run, and nothing compared.  One line
per count: the end-to-end metrics and the run's notes (for the real-time
drive the p99, the ticks over the deadline and the mean latency of the
first and last tenth of the window, which shows a growing backlog).
"""
from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from .harness import ROOT, Cell
from .trace import Tracer


def sweep_one(workload: str, n: int, seconds: float, seed: int) -> dict:
    over = {"traffic": {"n_streams": n}}
    cell = Cell(ROOT, workload, over)
    if cell.traffic["drive"] == "step":
        over["config"] = {"scene_period_s": 1}
        cell = Cell(ROOT, workload, over)
    device = torch.device("cuda", 0)
    drv = cell.driver(seed, seconds, device, Tracer(False))
    t0 = time.perf_counter()
    row = {"workload": workload, "n_streams": n}
    try:
        drv.setup()
        torch.cuda.synchronize()
        row["setup_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        gc.collect()
        gc.freeze()
        gc.disable()       # as the harness's window runs
        try:
            win = drv.window()
        finally:
            gc.enable()
            gc.unfreeze()
        row.update(win["metrics"])
        row.update(win["notes"])
        row["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError as e:
        row["error"] = f"out of memory: {str(e)[:120]}"
    finally:
        for name in ("pipe", "pool", "in_d", "kept"):
            if hasattr(drv, name):
                delattr(drv, name)
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m aecm_bench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--streams", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    for n in (int(x) for x in args.streams.split(",")):
        print("sweep " + json.dumps(sweep_one(args.workload, n, args.seconds,
                                              args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
