"""The frozen counts of the frames kernel's roofline match their
derivation: the totals are the sums of their parts, and the state bytes are
those of the port's lane-major core layout (history 100, capacity 1); a
cell with two near inputs reads the clean mode's file."""
import json

import pytest

from aecm_bench.harness import Cell
from aecm_bench.tests.conftest import BENCH

FILES = sorted((BENCH / "counts").glob("frames_*.json"))


@pytest.mark.parametrize("path", FILES, ids=[p.stem for p in FILES])
def test_totals_are_their_parts(path):
    c = json.loads(path.read_text())
    ops = (c["active_blocks_per_launch"] * sum(c["ops_per_active_block"].values())
           + c["frames_per_launch"] * sum(c["ops_per_frame"].values())
           + sum(c["ops_per_launch"].values()))
    assert c["ops_per_stream"] == ops
    assert c["bytes_per_stream"] == sum(c["bytes_per_launch"].values())
    rate = int(path.stem.split("_")[1])
    hnl = any(k.startswith("hnl squared") for k in c["ops_per_active_block"])
    assert hnl == (rate == 16000)


def test_state_bytes_are_the_ports_layout():
    from webrtc_aecm_tpu_torch import fused_kernel
    state = sum(shape[0] * dtype.itemsize for path, shape, dtype
                in fused_kernel._leaf_layout(1, 100, 1)
                if path not in ("far_history", "far_q_domains"))
    history = sum(shape[0] * dtype.itemsize for path, shape, dtype
                  in fused_kernel._leaf_layout(1, 100, 1)
                  if path in ("far_history", "far_q_domains"))
    assert history == 100 * 41 * 4
    for path in FILES:
        c = json.loads(path.read_text())
        assert c["bytes_per_launch"]["state leaves read and written"] \
            == 2 * state


def test_bound_binds_as_documented():
    from aecm_bench import trace
    peaks = json.loads((BENCH / "peaks.json").read_text())[
        "NVIDIA H100 80GB HBM3"]
    rate = peaks["sms"] * peaks["int32_lanes_per_sm"] * peaks["sm_clock_max_hz"]
    for path in FILES:
        c = json.loads(path.read_text())
        by_bytes = c["bytes_per_stream"] / peaks["memory_bytes_per_s"]
        by_ops = c["ops_per_stream"] / rate
        assert trace.frames_bound_s(c, peaks, 1) == max(by_bytes, by_ops)
        assert (by_bytes > by_ops) == path.stem.endswith("_step")


def test_clean_step_counts_the_clean_input():
    """frames_16000_clean_step.json is the single-input 10 ms file's
    derivation with the clean near input's work added part by part: the
    third forward transform and its magnitudes, its samples placed and
    carried, its input bytes, and the clean state leaves (which the port's
    layout holds: d_buf_clean, in_carry_clean); the comfort-noise draws
    counted and no phase rows read, as the kernel now does."""
    from webrtc_aecm_tpu_torch import fused_kernel
    one = json.loads((BENCH / "counts" / "frames_16000_step.json").read_text())
    two = json.loads((BENCH / "counts" / "frames_16000_clean_step.json"
                      ).read_text())
    layout = {path: shape[0] * dtype.itemsize for path, shape, dtype
              in fused_kernel._leaf_layout(1, 100, 1)}
    assert layout["d_buf_clean"] == 128 * 4
    assert layout["in_carry_clean"] == 64 * 4
    clean_state = sum(v for k, v in layout.items()
                      if k not in ("far_history", "far_q_domains"))
    assert two["bytes_per_launch"]["state leaves read and written"] \
        == 2 * clean_state
    third = 448 * 20 + 261 + 640 + 1767       # butterflies, scaling, window,
    draws = 64 * 7                            # magnitudes; the CNG draws
    assert sum(two["ops_per_active_block"].values()) \
        == sum(one["ops_per_active_block"].values()) + third + 64 * 5 + draws
    assert sum(two["ops_per_launch"].values()) \
        == sum(one["ops_per_launch"].values()) + 64 * 5
    assert two["ops_per_frame"] == one["ops_per_frame"]
    # inputs: a clean 160 samples more, the 3 slots' 64 phase rows fewer
    assert two["bytes_per_stream"] == one["bytes_per_stream"] \
        + 4 * (160 - 3 * 64)
    for k in ("active_blocks_per_launch", "frames_per_launch",
              "kernel_match"):
        assert two[k] == one[k]


@pytest.mark.parametrize("workload,name", [
    ("wb16k.rt", "frames_16000_step.json"),
    ("wb16k_ns.rt", "frames_16000_clean_step.json"),
    ("wb16k_ns.bulk", None)])
def test_cell_picks_its_counts(tiny, workload, name):
    counts = Cell(tiny, workload).counts()
    if name is None:
        assert counts is None       # no dual-input bulk counts yet
    else:
        assert counts == json.loads((BENCH / "counts" / name).read_text())
