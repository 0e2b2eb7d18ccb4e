"""The harness: cells found by name, a cell added as files alone runs,
the result line's keys, the JAX-import check, BENCHMARK.json's names."""
import io
import json
import re
import sys
import types

import pytest

from aecm_bench import harness
from aecm_bench.harness import Cell, NoResult, run_cell
from aecm_bench.tests.conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_cell_files_found_by_name():
    cell = Cell(ROOT, "nb8k.bulk")
    assert cell.config["sample_rate"] == 8000
    assert cell.traffic["drive"] == "run"
    assert cell.counts()["mode"].startswith("run's step at 8 kHz")
    assert {m["name"] for m in cell.end_to_end} == {"streams_rt", "setup_s"}
    assert "frames_roofline.bulk" in {m["name"] for m in cell.per_layer}
    assert "frames_roofline.rt" not in {m["name"] for m in cell.per_layer}
    with pytest.raises(NoResult):
        Cell(ROOT, "no.such")


def test_compared_streams_from_the_seed():
    cell = Cell(ROOT, "wb16k.rt")
    a, b = cell.compared_streams(2**33 + 1), cell.compared_streams(2**33 + 1)
    n = cell.traffic["n_streams"]
    assert (a == b).all() and a[0] == 0 and a[-1] == n - 1
    assert len(a) == cell.traffic["compared_streams"]
    assert not (a == cell.compared_streams(2)).all()


def _last_line(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tiny, trace):
    out, err = io.StringIO(), io.StringIO()
    run_cell("nb8k.rt", 77, 0.1, bool(trace), device="cpu", root=tiny,
             out=out, err=err)
    res = _last_line(out.getvalue())
    want = KEYS[:5] + (["breakdown"] if trace else []) + KEYS[5:]
    assert list(res) == want
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 10 * 6
    names = set(res["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert names <= {"step_host_us.rt", "copy_ms.rt", "device_idle.rt",
                         "capture_s", "glue_device_ms.rt",
                         "frames_roofline.rt"}
        assert "step_host_us.rt" in names
    else:
        assert names == {"rt_p50_ms", "rt_p95_ms", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    lines = err.getvalue().strip().splitlines()[-3:]
    assert all(re.fullmatch(r"check \w+ \d+ limit \d+", x) for x in lines)


def test_a_cell_added_as_files_runs(tiny):
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny / "aecm_bench/configs/nb8k.json").read_text())
    cfg["echo_mode"] = 4
    (tiny / "aecm_bench/configs/nb8k_loud.json").write_text(json.dumps(cfg))
    tr = json.loads((tiny / "aecm_bench/traffic/bulk8k.json").read_text())
    tr["scene"]["echo_gain"] = [0.6, 0.9]
    (tiny / "aecm_bench/traffic/bulk8k_loud.json").write_text(json.dumps(tr))
    bench["configs"].append(dict(bench["configs"][1], name="nb8k_loud",
                                 file="aecm_bench/configs/nb8k_loud.json"))
    bench["workloads"].append({"name": "nb8k_loud.bulk", "config":
                               "nb8k_loud", "traffic": "bulk8k_loud",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][2]["workloads"].append("nb8k_loud.bulk")
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    out = io.StringIO()
    res = run_cell("nb8k_loud.bulk", 5, 0.1, False, device="cpu", root=tiny,
                   out=out, err=io.StringIO())
    assert res["correct"] and set(res["metrics"]) == {"streams_rt",
                                                      "setup_s"}


def test_jax_check(monkeypatch):
    assert harness.forbidden_modules() == []
    import webrtc_aecm_tpu_torch  # noqa: F401  another top-level name
    harness.check_modules("now")
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(NoResult, match="jax"):
        harness.check_modules("now")
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "webrtc_aecm_tpu.core",
                        types.ModuleType("webrtc_aecm_tpu.core"))
    assert harness.forbidden_modules() == ["webrtc_aecm_tpu"]


def test_no_card_no_result(capsys):
    if harness.torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.main(["--workload", "wb16k.rt", "--seed", "1",
                         "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_benchmark_json_names():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] == 1
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        want = e2e[m["moves"]].get("workloads",
                                   [w["name"] for w in bench["workloads"]])
        assert set(m["workloads"]) <= set(want)
