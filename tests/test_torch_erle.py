"""The port's ERLE battery against the JAX package (tolerance 0), on the CPU.

tools/erle_report_torch.py runs tools/erle_report.py's 10 scenes through
the port; here its scene generator (a copy of that tool's) is held to the
JAX-side generator's hashes in tests/data/torch_golden_surface.npz (`erle.*`,
from tools/make_torch_golden_surface.py) for every scene, and one 8 kHz
scene runs through the port's AecmPipeline and its output hash is held to
the JAX package's.  No test here compiles a JAX function.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "erle_report_torch", os.path.join(REPO, "tools", "erle_report_torch.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)    # numpy only at import


@pytest.fixture(scope="module")
def golden():
    with np.load(tool.GOLDEN) as g:
        return {k: g[k] for k in g.files if k.startswith("erle.")}


def test_scene_generator_matches_jax_tools(golden):
    """All 10 scenes, grouped as tools/erle_report.py groups them, come
    out of the port's generator as out of the JAX tool's."""
    names = [s[0] for _, scenes in tool.GROUPS for s in scenes]
    assert len(names) == 10
    assert {k.split(".")[1] for k in golden} == set(names)
    for name in names:
        far, near, clean, ms = tool.build(name)
        p = f"erle.{name}"
        assert tool.sha(far) == str(golden[f"{p}.sha_far"]), name
        assert tool.sha(near) == str(golden[f"{p}.sha_near"]), name
        assert (clean is None) == (f"{p}.sha_clean" not in golden), name
        if clean is not None:
            assert tool.sha(clean) == str(golden[f"{p}.sha_clean"]), name


def test_8k_scene_matches_jax(golden):
    """The 8 kHz demo path's scene (echoMode 1, 6 s) through the port's
    fused engine on the CPU: the output is the JAX package's, bit for bit,
    and so is its ERLE."""
    name = "8k_demo_mode1"
    res = tool.run([name], device="cpu", engine="fused")[name]
    r = tool.check(name, *res, golden)
    assert r["scene_matches"] and r["bit_exact"], r
    assert r["erle_db"] == r["erle_jax_db"]
    assert r["erle_db"] > 5.0
