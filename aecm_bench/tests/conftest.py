"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
with every cell cut to a few streams and a short scene, in which the
harness runs on the CPU against the port's plain versions."""
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def tiny_root(dest: Path, n_streams: int = 6, compared: int = 4) -> Path:
    """BENCHMARK.json and the benchmark's data files under dest, the cells
    cut to n_streams streams, a 1 s scene period and 0.25 s bulk calls."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(BENCH, dest / "aecm_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
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
