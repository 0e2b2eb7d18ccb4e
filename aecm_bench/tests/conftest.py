"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
with every cell cut to a few streams and a short scene, in which the
harness runs on the CPU against the port's plain versions."""
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


NS_GAIN_DB = -12      # kModerate's floor (ns_core.c, denoiseBound 0.25)


def add_dual_input_cells(dest: Path) -> None:
    """A dual-input configuration (wb16k with two near inputs, the clean
    one after a stand-in noise suppressor) and its real-time and bulk cells,
    added to the copy under dest as files alone."""
    here = dest / "aecm_bench"
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "wb16k.json").read_text())
    cfg["near_inputs"] = 2
    (here / "configs" / "wb16k_ns.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name="wb16k_ns",
                                 file="aecm_bench/configs/wb16k_ns.json"))
    for drive, traffic in (("rt", "rt16k"), ("bulk", "bulk16k")):
        t = json.loads((here / "traffic" / f"{traffic}.json").read_text())
        t["scene"]["ns_noise_gain_db"] = NS_GAIN_DB
        t["scene_sources"]["ns_noise_gain_db"] = "the benchmark's own"
        (here / "traffic" / f"{traffic}_ns.json").write_text(json.dumps(t))
        name = f"wb16k_ns.{drive}"
        bench["workloads"].append({"name": name, "config": "wb16k_ns",
                                   "traffic": f"{traffic}_ns", "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"wb16k.{drive}" in m.get("workloads", []):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))


def tiny_root(dest: Path, n_streams: int = 6, compared: int = 4) -> Path:
    """BENCHMARK.json and the benchmark's data files under dest, with the
    dual-input cells wb16k_ns.rt and wb16k_ns.bulk added, the cells cut to
    n_streams streams, a 1 s scene period and 0.25 s bulk calls."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(BENCH, dest / "aecm_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_dual_input_cells(dest)
    for f in (dest / "aecm_bench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(n_streams=n_streams, compared_streams=compared, trace_s=0.05)
        if "warmup_ticks" in t:
            t["warmup_ticks"] = 3
        f.write_text(json.dumps(t))
    for f in (dest / "aecm_bench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c.update(scene_period_s=1, bulk_call_s=0.25)
        f.write_text(json.dumps(c))
    return dest


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
