"""What decides `correct`: the reference agrees with the port's plain
path; a sound run is correct; the control (the lower-precision abs_approx
path) and each fault a cell can have, planted under the timed path, make
`correct` false.  All on the CPU at a few streams."""
import io

import numpy as np
import pytest
import torch

from aecm_bench import control
from aecm_bench.harness import run_cell
from aecm_bench.reference import Reference


def test_reference_is_the_ports_plain_path():
    from webrtc_aecm_tpu_torch.parallel import batch
    rng = np.random.default_rng(4)
    for rate in (8000, 16000):
        ch = rate // 100
        far = rng.integers(-6000, 6000, (24, 3, ch)).astype(np.int16)
        near = (0.4 * np.roll(far, 2, axis=0)
                + rng.integers(-200, 200, far.shape)).astype(np.int16)
        ms = np.array([30, 70, 110], np.int32)
        ref = Reference(3, rate, "cpu")
        o1, w1 = ref.run(far[:10], near[:10], ms)
        o2, w2 = ref.run(far[10:], near[10:], ms)
        st = batch.create_batch(3, rate, device="cpu")
        step = batch.make_chunk_step(rate, device="cpu")
        for i in range(24):
            st, out, warn = step(st, torch.as_tensor(far[i]),
                                 torch.as_tensor(near[i]),
                                 torch.as_tensor(ms))
            got = (o1[i], w1[i]) if i < 10 else (o2[i - 10], w2[i - 10])
            assert torch.equal(out, got[0]) and torch.equal(warn, got[1])


def _run(root, workload, patch=None, seconds=0.1, seed=9):
    return run_cell(workload, seed, seconds, False, device="cpu", root=root,
                    program_patch=patch, out=io.StringIO(),
                    err=io.StringIO())


def _wrap(driver, fault):
    """The pipeline's step or run with `fault` planted under it: the fault
    sees each call's output (and the state before it); a fault marked
    `drops_clean` has the program called without its clean near input."""
    pipe = driver.pipe
    drive = "step" if driver.cell.traffic["drive"] == "step" else "run"
    orig = getattr(pipe, drive)
    drop = getattr(fault, "drops_clean", False)

    def call(far, near, clean=None, ms_in_sndcard_buf=40):
        before = pipe.state
        res = orig(far, near, None if drop else clean,
                   ms_in_sndcard_buf=ms_in_sndcard_buf)
        if drive == "step":
            out, warn = res
            return fault(pipe, before, out), warn
        return fault(pipe, before, res)
    setattr(pipe, drive, call)


def state_unchanged(pipe, before, out):
    """The step returns its state unchanged."""
    pipe.state = before
    return out


def half_batch(pipe, before, out):
    """Half of the streams left out: their outputs never computed."""
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def answer_altered(pipe, before, out):
    """One sample of every stream's answer altered where it is produced."""
    out = out.clone()
    out[:, 3] += 1
    return out


def clean_dropped(pipe, before, out):
    """The program called without its clean near input: a dual-input cell
    served as a single-input one."""
    return out


clean_dropped.drops_clean = True


@pytest.mark.parametrize("workload", ["wb16k.rt", "nb8k.bulk", "wb16k_ns.rt",
                                      "wb16k_ns.bulk"])
def test_sound_run_is_correct(tiny, workload):
    res = _run(tiny, workload)
    assert res["correct"] and res["failed"] == 0


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered])
@pytest.mark.parametrize("workload", ["wb16k.rt", "nb8k.bulk", "wb16k_ns.rt"])
def test_faults_make_it_incorrect(tiny, workload, fault):
    if fault is state_unchanged and workload.endswith(".rt"):
        seconds = 0.8       # past the startup, where the state matters
    else:
        seconds = 0.1
    res = _run(tiny, workload, lambda d: _wrap(d, fault), seconds)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["bad_samples"]["value"] > 0


@pytest.mark.parametrize("workload", ["wb16k_ns.rt", "wb16k_ns.bulk"])
def test_clean_dropped_makes_it_incorrect(tiny, workload):
    res = _run(tiny, workload, lambda d: _wrap(d, clean_dropped))
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["bad_samples"]["value"] > 0


@pytest.mark.parametrize("workload", ["nb8k.rt", "wb16k.bulk", "wb16k_ns.rt"])
def test_control_is_incorrect(tiny, workload):
    with control.patched(control.abs_approx) as patch:
        res = _run(tiny, workload, patch, seconds=1.0)
    assert not res["correct"]
    assert res["checks"]["bad_samples"]["value"] > 0
    # the program's own path is back afterwards
    assert _run(tiny, workload)["correct"]
