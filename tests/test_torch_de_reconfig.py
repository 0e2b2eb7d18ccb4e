"""The port's delay-estimator reconfiguration surface == the JAX package's.

The setters and queries of webrtc_aecm_tpu_torch.delay_estimator (soft
resets, lookahead, allowed offset, robust validation, history size) and
the float path, held at tolerance 0 to the JAX package's answers in
tests/data/torch_golden_reconfig.npz (tools/make_torch_golden_reconfig.py:
the six scenarios of tests/test_de_reconfig.py replayed on the JAX
package, whose C oracle is absent here, and the float stream of
tests/test_delay_estimator.py): the delay of every block, what every setter
and query returned, and the final states.  Each scenario runs on one
estimator and on a batch of two (a leading stream axis, the second stream
the same as the first).  No test here compiles a JAX function.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from webrtc_aecm_tpu_torch import delay_estimator as de
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_reconfig.npz")
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden_reconfig",
    os.path.join(REPO, "tools", "make_torch_golden_reconfig.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)    # numpy only at import: the scenes


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def assert_states(golden, prefix, near, farend, stream=None):
    """The final near / far-end states (of `stream` of a batch) == the
    golden's, leaf by leaf, in the JAX dtypes."""
    for part, st in (("near", near), ("farend", farend)):
        for path, x in tree_leaves_with_path(st):
            a = x.numpy() if stream is None else x[stream].numpy()
            if path == "binary_history":
                a = a.astype(np.uint32)
            want = golden[f"{prefix}.{part}.{path}"]
            assert a.dtype == want.dtype, (part, path)
            np.testing.assert_array_equal(a, want, err_msg=f"{part}.{path}")


def replay(name, batch):
    """The scenario's ops on the port: one estimator, or a batch of two.
    Returns (delays (blocks,) or (blocks, 2), rets, near, farend)."""
    _, n_blocks, _, hist, la, robust, ops = gen.DE[name]
    far_s, near_s = (torch.as_tensor(x.astype(np.int32))
                     for x in gen.de_spectra(name))
    farend = de.create_farend(hist, device="cpu")
    near = de.create_near(hist, max_lookahead=la, robust_validation=robust,
                          device="cpu")
    if batch:
        farend, near = (type(s)(*[x.expand((2,) + x.shape).contiguous()
                                  for x in s]) for s in (farend, near))
    q = torch.full((2,) if batch else (), 8, dtype=torch.int32)
    delays, rets, at = [], [], 0

    def ret(v):
        v = torch.as_tensor(v)
        if batch:
            assert v.shape == (2,) and v[0] == v[1], v
            v = v[0]
        return int(v)

    for op, arg in ops:
        if op == "run":
            for i in range(at, at + arg):
                f, n = far_s[i], near_s[i]
                if batch:
                    f, n = f.expand(2, -1), n.expand(2, -1)
                farend = de.add_far_spectrum_fix(farend, f, q)
                near, d = de.process_fix(near, farend, n, q)
                delays.append(d.clone())
            at += arg
        elif op == "soft_reset":
            near, applied = de.soft_reset_near(near, arg)
            farend = de.soft_reset_farend(farend, arg)
            rets.append(ret(applied))
        elif op == "set_history_size":
            near, farend = de.set_history_size(near, farend, arg)
            rets.append(arg)
        elif op == "history_size":
            rets.append(de.history_size(near, farend))
        elif arg is None:
            rets.append(ret(getattr(de, op)(near)))
        else:
            near, r = getattr(de, op)(near, arg)
            rets.append(ret(r))
    assert at == n_blocks
    return torch.stack(delays).numpy(), rets, near, farend


@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("name", list(gen.DE))
def test_reconfiguration_matches_jax(golden, name, batch):
    delays, rets, near, farend = replay(name, batch)
    want = golden[f"de.{name}.delays"]
    if batch:
        np.testing.assert_array_equal(delays[:, 0], want)
        np.testing.assert_array_equal(delays[:, 1], want)
    else:
        np.testing.assert_array_equal(delays, want)
    np.testing.assert_array_equal(rets, golden[f"de.{name}.rets"])
    for stream in ((0, 1) if batch else (None,)):
        assert_states(golden, f"de.{name}", near, farend, stream)


@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch"])
def test_float_path_matches_jax(golden, batch):
    far_f, near_f = (torch.as_tensor(x) for x in gen.float_spectra())
    farend = de.create_farend(float_spectrum=True, device="cpu")
    near = de.create_near(float_spectrum=True, device="cpu")
    assert farend.mean_spectrum.dtype == torch.float32
    if batch:
        farend, near = (type(s)(*[x.expand((2,) + x.shape).contiguous()
                                  for x in s]) for s in (farend, near))
    delays = []
    for f, n in zip(far_f, near_f):
        if batch:
            f, n = f.expand(2, -1), n.expand(2, -1)
        farend = de.add_far_spectrum_float(farend, f)
        near, d = de.process_float(near, farend, n)
        delays.append(d.clone())
    delays = torch.stack(delays).numpy()
    for col in ((0, 1) if batch else (None,)):
        got = delays if col is None else delays[:, col]
        np.testing.assert_array_equal(got, golden["float.delays"])
        assert_states(golden, "float", near, farend, col)


def test_setters_per_stream_values():
    """On a batch each stream takes its own value; an invalid one leaves
    its stream unchanged and returns -1 there."""
    near = de.create_near(max_lookahead=3, device="cpu")
    near = type(near)(*[x.expand((4,) + x.shape).contiguous() for x in near])
    near, r = de.set_lookahead(near, torch.tensor([0, 3, 4, -1]))
    assert r.tolist() == [0, 3, -1, -1]
    assert de.lookahead(near).tolist() == [0, 3, 3, 3]
    near, applied = de.soft_reset_near(near, torch.tensor([2, -5, 1, 0]))
    assert applied.tolist() == [0, 0, 1, 0]
    assert de.lookahead(near).tolist() == [0, 3, 2, 3]
    near, r = de.set_allowed_offset(near, torch.tensor([5, -2, 0, 1]))
    assert r.tolist() == [0, -1, 0, 0]
    assert de.get_allowed_offset(near).tolist() == [5, 0, 0, 1]
    near, r = de.enable_robust_validation(near, torch.tensor([1, 2, 0, -1]))
    assert r.tolist() == [0, -1, 0, -1]
    assert de.is_robust_validation_enabled(near).tolist() == [1, 0, 0, 0]


def test_set_history_size_realloc():
    """Shrinking keeps the prefix (the new dummy slot included); growing
    zero-fills from the old size, the new dummy slot 0; a size of 1 or less
    raises; mismatched halves report -1."""
    near = de.create_near(10, device="cpu")
    farend = de.create_farend(10, device="cpu")
    near = near._replace(mean_bit_counts=torch.arange(11, dtype=torch.int32),
                         histogram=torch.arange(11, dtype=torch.float32))
    small, fe_small = de.set_history_size(near, farend, 4)
    assert small.mean_bit_counts.tolist() == [0, 1, 2, 3, 4]
    assert de.history_size(small, fe_small) == 4
    big, fe_big = de.set_history_size(small, fe_small, 7)
    assert big.mean_bit_counts.tolist() == [0, 1, 2, 3, 0, 0, 0, 0]
    assert big.histogram.tolist() == [0, 1, 2, 3, 0, 0, 0, 0]
    assert fe_big.binary_history.shape == (7,)
    assert de.history_size(big, fe_small) == -1
    with pytest.raises(ValueError, match="history_size"):
        de.set_history_size(near, farend, 1)
