"""Long-call behaviour of the port: the state stays O(1) and the pipeline
survives delay drift over an extended call (tests/test_long_call.py).

The state bytes of `create_batch` and `create_fused` are exactly linear in
the streams and modest, and tests/test_long_call.py's drift sequence (five
2 s segments in repeated run() calls, a drifting sound-card delay) is held
to the JAX package's answer in tests/data/torch_golden_surface.npz
(`long.*`: each segment's output hash and the final state, tolerance 0).
The sequence runs on the fused engine, the quicker of the two on the CPU
(the engines are bit-exact with each other).  No test here compiles a JAX
function.
"""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from webrtc_aecm_tpu_torch import convert, fused
from webrtc_aecm_tpu_torch._tree import tree_leaves, tree_leaves_with_path
from webrtc_aecm_tpu_torch.models import AecmPipeline
from webrtc_aecm_tpu_torch.parallel import create_batch
from webrtc_aecm_tpu_torch.utils import erle_db

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_surface.npz")
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden_surface",
    os.path.join(REPO, "tools", "make_torch_golden_surface.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)    # numpy only at import: the scenes


def _state_bytes(state) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(state))


@pytest.mark.parametrize("create", [create_batch, fused.create_fused],
                         ids=["create_batch", "create_fused"])
def test_state_is_o1_and_modest(create):
    """Per-stream state is fixed-shape and small enough for ~10k streams
    per card."""
    one = _state_bytes(create(1, 16000, device="cpu"))
    thousand = _state_bytes(create(1000, 16000, device="cpu"))
    # exactly linear in streams: no per-call growth anywhere
    assert thousand == 1000 * one
    assert one < 128 * 1024, f"per-stream state {one} bytes"


def test_long_call_with_delay_drift():
    """Minutes-long call in repeated run() segments: state threads through
    (no reset), each segment's output and the final state equal the JAX
    package's, and the canceller suppresses echo late in the call."""
    pipe = AecmPipeline(2, gen.LONG_FS, engine="fused", device="cpu")
    base = _state_bytes(pipe.state)
    with np.load(GOLDEN) as g:
        seg_sha = g["long.seg_sha"]
        state = {k[len("long.state."):]: g[k] for k in g.files
                 if k.startswith("long.state.")}
    for k, (far, near, ms) in enumerate(gen.long_segments()):
        out = pipe.run(far, near, ms_in_sndcard_buf=ms).numpy()
        assert np.abs(out).max() <= 32767
        assert _state_bytes(pipe.state) == base  # O(1) state
        assert hashlib.sha256(out.astype("<i2").tobytes()).hexdigest() \
            == seg_sha[k], f"segment {k}"
    got = dict(tree_leaves_with_path(convert.aecm_state_to_numpy(
        pipe._canonical())))
    assert set(got) == set(state)
    for path, want in state.items():
        assert got[path].dtype == want.dtype, path
        np.testing.assert_array_equal(got[path], want, err_msg=path)
    # after convergence the canceller must be suppressing echo
    e = erle_db(near[0], out[0], far[0])
    assert e > 3.0, f"late-call ERLE {e:.2f} dB"
