"""The control: the program with its lower-precision path switched on.

The configurations state bit-exact fixed-point AECM.  The step below it
that would tempt a later change is AECM_WITH_ABS_APPROX
(aecm_core_c.cc:316-341): the bins' magnitudes by an alpha-max-plus-beta-min
estimate instead of the square root of their power.  The port has that
path of its own (the frames kernel's abs_approx mode), so the control is
the cell run as it stands with the program's step built with
abs_approx=True; its checks have to come out failing.

    python3 -m aecm_bench.control --workload <name> --seeds 1,2,3 \\
        --seconds <s> [--sound]

runs the control on each seed (and with --sound a sound run of the same
seed first) in one process, and prints one summary line of the checks.
The program keeps each compiled step's buffers for the life of the
process, so at `nb8k.bulk`'s size (70 GB a run) give one seed, without
--sound, to a process.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

from .harness import NoResult, run_cell


def abs_approx(driver):
    """program_patch: the driver's pipeline with its steps built in the
    abs_approx mode (on the fused engine; a pipeline of another engine is
    rebuilt on the fused one first)."""
    from webrtc_aecm_tpu_torch import fused
    from webrtc_aecm_tpu_torch.compiled import compile_step
    from webrtc_aecm_tpu_torch.models import AecmPipeline
    pipe = driver.pipe
    if pipe.engine != "fused":
        cfg = driver.cell.config
        pipe = driver.pipe = AecmPipeline(
            pipe.n_streams, pipe.sample_rate, cfg["cng_mode"],
            cfg["echo_mode"], engine="fused", device=pipe.device)
    has_clean = driver.cell.config["near_inputs"] == 2
    pipe._step[has_clean] = compile_step(
        fused.make_fused_chunk_step(pipe.sample_rate, has_clean=has_clean,
                                    abs_approx=True, device=pipe.device),
        donate=True, name="AecmPipeline.step (fused, abs_approx)")
    steps = {}

    def span_step(sample_rate, cps, use_kernel, device, has_clean,
                  circular):
        key = (sample_rate, cps, use_kernel, device, has_clean, circular)
        if key not in steps:
            step = fused.FusedAecm(sample_rate, cps, use_kernel, device,
                                   has_clean, abs_approx=True,
                                   lane_major_io=True, circular_far=circular)
            steps[key] = compile_step(
                step, carry=((0, 0), (1, 1)) if circular else ((0, 0),),
                donate=True, name="fused run step, abs_approx")
        return steps[key]
    driver.restore = _swap(fused, "_span_step", span_step)


def _swap(mod, name, value):
    old = getattr(mod, name)
    setattr(mod, name, value)
    return lambda: setattr(mod, name, old)


@contextlib.contextmanager
def patched(patch):
    """A program_patch whose module-level swap is undone afterwards."""
    drivers = []

    def apply(driver):
        drivers.append(driver)
        patch(driver)
    try:
        yield apply
    finally:
        for d in drivers:
            getattr(d, "restore", lambda: None)()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m aecm_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    summary = []
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            row = {"seed": seed}
            if args.sound:
                r = run_cell(args.workload, seed, args.seconds, False)
                row["sound"] = {k: v["value"] for k, v in r["checks"].items()}
            with patched(abs_approx) as patch:
                r = run_cell(args.workload, seed, args.seconds, False,
                             program_patch=patch)
            row["control"] = {k: v["value"] for k, v in r["checks"].items()}
            row["control_failed"] = r["failed"]
            summary.append(row)
    except NoResult as e:
        print(f"aecm_bench.control: {e}", file=sys.stderr, flush=True)
        return 2
    print("control " + json.dumps({"workload": args.workload,
                                   "runs": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
