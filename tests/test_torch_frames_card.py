"""The frames kernel against its plain version on the card (marker `card`).

Every test here needs an NVIDIA card and the CUDA toolkit (the kernels are
built with nvcc at first use, and a CUDA kernel has no CPU mode); without
a card each skips.  Run them on the machine with the card:

    python3 -m pytest tests/test_torch_frames_card.py -m card -q

The kernel draws the step's comfort-noise phases itself and advances the
CNG seed in place; the plain version (fused.frames_step_cng) runs the
int64 chain (_precompute_cng_phases) and then frames_step.  Compared bit
for bit, outputs, pending blocks and every core leaf, on warm states in
each kind of mode: the 16 and 8 kHz newest-first 10 ms modes, the 5-slot
circular mode, a clean input, abs_approx, the general instances (more than
5 slots, a resized delay estimator, lookahead capacity 4), streams that
start mid-step or do not run, cng_mode off, and seeds at the edges of the
leaf's range.  And the captured fused step on the card never calls the
chain.  No JAX here.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from webrtc_aecm_tpu_torch import delay_estimator as de
from webrtc_aecm_tpu_torch import fused, fused_kernel
from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
from webrtc_aecm_tpu_torch.models import AecmPipeline
from webrtc_aecm_tpu_torch.parallel import batch as pbatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden_envelope",
    os.path.join(REPO, "tools", "make_torch_golden_envelope.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)    # numpy only at import: the scenes

B = 1027    # a ragged last thread block
# name: (rate, frames a step, clean input, abs_approx, circular history,
#        history size, lookahead capacity)
MODES = {
    "16k 10 ms": (16000, 2, False, False, False, 100, 1),
    "8k 10 ms": (8000, 1, False, False, False, 100, 1),
    "16k 5 slots circular": (16000, 4, False, False, True, 100, 1),
    "8k 5 slots circular": (8000, 4, False, False, True, 100, 1),
    "8k 3 slots clean": (8000, 2, True, False, False, 100, 1),
    "16k 10 ms abs_approx": (16000, 2, False, True, False, 100, 1),
    "16k 8 slots": (16000, 6, False, False, False, 100, 1),
    "16k 10 slots circular, H 128 lookahead 4": (16000, 8, False, False,
                                                 True, 128, 4),
    "8k 3 slots clean, H 257 lookahead 4": (8000, 2, True, False, False, 257,
                                            4),
}


def scene(fs, n_chunks, seed, with_clean=False):
    """The golden tool's scene for B streams: modulated far-end noise, the
    streams offset by 40 samples in 16 groups; near = 0.4 far + noise,
    clean = 0.35 far + noise; int16 (B, n_chunks * chunk)."""
    n = n_chunks * min(160, fs // 100)
    rng = np.random.default_rng(seed)
    t = np.arange(n + 640)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
    ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far = np.stack([ff[640 - o:640 - o + n]
                    for o in 40 * (np.arange(B) % 16)]).astype(np.int16)

    def mix(gain, sd):
        return (gain * far + rng.normal(0, sd, far.shape)
                ).clip(-32000, 32000).astype(np.int16)
    return far, mix(0.4, 150), mix(0.35, 120) if with_clean else None


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the frames kernel is CUDA only")
    return torch.device("cuda", torch.cuda.current_device())


def warm_core(dev, fs, history, cap, has_clean, n_chunks=24):
    """The core of B streams after n_chunks of the desync scene on the
    plain path, the delay estimator resized to `history` rows and, for
    cap > 1, rebuilt with lookahead capacity cap."""
    st = pbatch.create_batch(B, fs, device=dev)
    dn, df = st.core.de_near, st.core.de_farend
    if history != 100:
        dn, df = de.set_history_size(dn, df, history)
    if cap > 1:
        dn = dn._replace(
            binary_history=torch.zeros((B, cap), dtype=torch.int64,
                                       device=dev),
            lookahead=torch.arange(B, dtype=torch.int32, device=dev) % cap)
    st = fused.to_fused_state(st._replace(core=st.core._replace(
        de_near=dn, de_farend=df)))
    far, near, clean = scene(fs, n_chunks, 7, has_clean)
    fin, _ = fused.run_streams_fused(st, far, near, fs,
                                     gen.desync_ms(n_chunks, B, 10),
                                     use_kernel=False, clean=clean)
    return fin.core


@pytest.mark.card
@pytest.mark.parametrize("name", list(MODES))
def test_frames_kernel_matches_plain(card, name):
    fs, n_frames, has_clean, absa, circular, history, cap = MODES[name]
    core = warm_core(card, fs, history, cap, has_clean)
    head = None
    if circular:
        core, head = fused._to_circular_far(core), 37
    i = torch.arange(B, device=card)
    core.frame_fill[0] = torch.tensor([0, 16, 32, 48], dtype=torch.int32,
                                      device=card)[i % 4]
    core.cng_mode[0, i % 5 == 3] = 0
    for cls, seed in ((7, 0), (8, 2 ** 31 - 1), (9, 2 ** 32 - 1)):
        core.seed[0, i % 43 == cls] = seed
    seed_in = core.seed.clone()
    dv = lambda x: None if x is None else torch.as_tensor(  # noqa: E731
        x, device=card).contiguous()
    far, noisy, clean, run_rows = map(dv, gen.frames_inputs(
        fs, n_frames, has_clean, 11, B))
    t = fused.make_tables(card, fused._n_slots_for(n_frames))
    args = (t, far, noisy, clean, run_rows, fs // 8000, n_frames, has_clean,
            absa, min(160, fs // 100) // 80, head)
    ref = fused.frames_step_cng(fused.clone_state(core), *args)
    launches = fused_kernel.frames_kernel_call.launches
    got = fused_kernel.frames_kernel_call(fused.clone_state(core), *args)
    torch.cuda.synchronize()
    assert fused_kernel.frames_kernel_call.launches == launches + 1
    assert len(got) == len(ref)
    for x, y in zip(got[1:], ref[1:]):
        assert torch.equal(x, y)
    for (path, x), (_, y) in zip(tree_leaves_with_path(got[0]),
                                 tree_leaves_with_path(ref[0])):
        assert torch.equal(x, y), path
    # the cases are there: streams that start mid-step (steps of more than
    # one chunk) or do not run, and cng off, whose seed stays
    mid_step = run_rows.any(0) & ~run_rows.all(0)
    assert bool(mid_step.any()) == (n_frames > args[9])
    assert bool((~run_rows.any(0)).any())
    off = core.cng_mode[0] == 0
    assert torch.equal(got[0].seed[0, off], seed_in[0, off])
    assert not torch.equal(got[0].seed, seed_in)


@pytest.mark.card
def test_captured_fused_step_draws_in_the_kernel(card, monkeypatch):
    """The fused engine's compiled steps (AecmPipeline.step at 16 kHz, the
    8 kHz run's spans) capture the frames kernel and no CNG chain, and
    give the plain path's answer."""
    calls = []
    chain = fused._precompute_cng_phases
    monkeypatch.setattr(fused, "_precompute_cng_phases",
                        lambda *a: calls.append(1) or chain(*a))
    far, near, _ = scene(16000, 6, 1)
    pipe = AecmPipeline(B, 16000, engine="fused", device=card)
    launches = fused_kernel.frames_kernel_call.launches
    outs = [pipe.step(far[:, c * 160:(c + 1) * 160],
                      near[:, c * 160:(c + 1) * 160])[0] for c in range(6)]
    far8, near8, _ = scene(8000, 12, 2)
    _, out8 = fused.run_streams_fused(fused.create_fused(B, 8000, device=card),
                                      far8, near8, 8000, 40)
    torch.cuda.synchronize()
    assert calls == []
    assert fused_kernel.frames_kernel_call.launches > launches
    # the plain path runs the chain, and gives the same samples
    st = fused.create_fused(B, 16000, device=card)
    _, ref = fused.run_streams_fused(st, far, near, 16000, 40,
                                     use_kernel=False, chunks_per_step=1)
    _, ref8 = fused.run_streams_fused(fused.create_fused(B, 8000,
                                                         device=card),
                                      far8, near8, 8000, 40,
                                      use_kernel=False)
    assert calls
    assert torch.equal(torch.cat(outs, 1), ref)
    assert torch.equal(out8, ref8)
