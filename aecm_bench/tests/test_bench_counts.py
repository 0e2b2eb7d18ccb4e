"""The frozen counts of the frames kernel's roofline match their
derivation: the totals are the sums of their parts, and the state bytes are
those of the port's lane-major core layout (history 100, capacity 1)."""
import json

import pytest

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
