"""The scene generator: deterministic per seed, one distinct scene per
stream, the near end holding that stream's own far end."""
import json

import numpy as np
import pytest
import torch

from aecm_bench import scenes
from aecm_bench.harness import NoResult
from aecm_bench.tests.conftest import BENCH, NS_GAIN_DB

PARAMS = scenes.SceneParams.from_traffic(
    json.loads((BENCH / "traffic" / "rt16k.json").read_text()))


def _make(seed, n=5, rate=8000, period=1):
    return scenes.make_scenes(PARAMS, n, rate, period, seed, "cpu")


def test_same_seed_same_scenes_and_large_seeds():
    seed = 2**31 + 987654321
    a, b = _make(seed), _make(seed)
    assert a.clean is None and b.clean is None
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    c = _make(seed + 1)
    assert not torch.equal(a.far, c.far)


def test_streams_are_distinct_scenes():
    sc = _make(11, n=8)
    assert sc.far.dtype == torch.int16 and sc.far.shape == (8, 8000)
    assert len({row.tobytes() for row in sc.near.numpy()}) == 8
    talking = [row.tobytes() for row in sc.far.numpy() if row.any()]
    assert len(talking) >= 2 and len(set(talking)) == len(talking)
    p = scenes.stream_params(PARAMS, 8, 11)
    assert len(set(np.round(p["echo_ms"], 3))) == 8
    assert len(set(np.round(p["far_f0"], 3))) == 8
    lo, hi = PARAMS.ms_in_sndcard_buf
    assert ((sc.ms.numpy() >= lo) & (sc.ms.numpy() <= hi)).all()


def test_near_holds_its_own_far_delayed():
    """The near end's circular cross-correlation with its own far end peaks
    at that stream's echo delay."""
    n, rate = 6, 8000
    sc = _make(5, n=n, rate=rate)
    p = scenes.stream_params(PARAMS, n, 5)
    far = sc.far.double().numpy()
    near = sc.near.double().numpy()
    for s in range(n):
        if not far[s].any():
            continue
        xc = np.fft.irfft(np.conj(np.fft.rfft(far[s])) * np.fft.rfft(near[s]),
                          n=far.shape[1])
        d = int(round(p["echo_ms"][s] * rate / 1000))
        assert abs(int(np.argmax(xc)) - d) <= 1


def test_conversation_follows_p59():
    """The chain keeps ITU-T P.59's shares and mean durations of mutual
    silence, single talk and double talk, as the traffic file gives them."""
    gen = torch.Generator()
    gen.manual_seed(3)
    st = scenes.conversation(PARAMS, 2000, 3000, gen, "cpu").numpy()
    step_s = PARAMS.step_ms / 1000
    for state, (share, mean_s) in (
            (scenes.SILENCE, PARAMS.mutual_silence),
            (scenes.FAR, PARAMS.single_talk),
            (scenes.LOCAL, PARAMS.single_talk),
            (scenes.DOUBLE, PARAMS.double_talk)):
        on = (st == state).astype(np.int8)
        assert abs(on.mean() - share) < 0.01
        edges = np.diff(on, axis=1)
        starts, ends = (edges == 1).sum(), (edges == -1).sum()
        # time in the state over the runs that end in the window
        assert abs(on.sum() * step_s / max(starts, ends) - mean_s) < 0.05 * mean_s


def test_talk_and_levels_follow_the_traffic():
    sc = scenes.make_scenes(PARAMS, 64, 8000, 4, 3, "cpu")
    frames = sc.far.double().view(64, -1, 80)
    talking = frames.abs().amax(dim=2) > 0
    share = talking.double().mean().item()
    want = PARAMS.single_talk[0] + PARAMS.double_talk[0]
    assert abs(share - want) < 0.08
    rms = (frames ** 2).mean(dim=2)[talking].mean().sqrt().item()
    dbov = 20 * np.log10(rms / scenes.FULL_SCALE)
    lo, hi = PARAMS.speech_dbov
    assert lo <= dbov <= hi


def test_traffic_without_ns_gain_reads_as_before():
    assert PARAMS.ns_noise_gain_db is None
    tr = json.loads((BENCH / "traffic" / "rt16k.json").read_text())
    tr["scene"]["ns_noise_gain_db"] = NS_GAIN_DB
    assert scenes.SceneParams.from_traffic(tr) == PARAMS._replace(
        ns_noise_gain_db=NS_GAIN_DB)


@pytest.mark.parametrize("rate", [8000, 16000])
def test_clean_near_leaves_the_single_input_scene_as_it_was(rate):
    """Two near inputs draw nothing new: far, near and ms are the
    single-input scene's, bit for bit; the clean near end is the near end
    with its noise scaled by ns_noise_gain_db (0 dB: the near end itself)."""
    seed = 2**32 + 12345
    one = scenes.make_scenes(PARAMS, 5, rate, 1, seed, "cpu")
    ns = PARAMS._replace(ns_noise_gain_db=NS_GAIN_DB)
    two = scenes.make_scenes(ns, 5, rate, 1, seed, "cpu", near_inputs=2)
    for x, y in zip(one[:3], two[:3]):
        assert torch.equal(x, y)
    assert two.clean.dtype == torch.int16 and two.clean.shape == one.near.shape
    diff = (two.near.double() - two.clean.double()).numpy()
    assert diff.any()
    # what the clean end lacks is 1 - 10^(-12/20) of the noise: a weaker
    # signal than the near end's noise, and the speech and echo are kept
    noise = scenes.stream_params(PARAMS, 5, seed)["noise_rms"]
    rms = np.sqrt((diff ** 2).mean(axis=1))
    want = (1 - 10 ** (NS_GAIN_DB / 20)) * noise
    assert (np.abs(rms - want) <= 0.1 * want + 0.5).all()
    flat = PARAMS._replace(ns_noise_gain_db=0)
    same = scenes.make_scenes(flat, 5, rate, 1, seed, "cpu", near_inputs=2)
    assert torch.equal(same.clean, same.near)
    assert torch.equal(same.near, one.near)


def test_two_near_inputs_need_the_ns_gain():
    with pytest.raises(NoResult, match="ns_noise_gain_db"):
        scenes.make_scenes(PARAMS, 2, 8000, 1, 1, "cpu", near_inputs=2)
    with pytest.raises(NoResult, match="near_inputs 3"):
        scenes.make_scenes(PARAMS, 2, 8000, 1, 1, "cpu", near_inputs=3)
