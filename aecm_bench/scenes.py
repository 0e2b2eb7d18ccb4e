"""The benchmark's traffic generator: one distinct echo scene per stream.

Every stream gets, from the seed, its own conversation, its own far-end
talker and local talker (voiced harmonics under a syllabic envelope), its
own echo path (a delay and a loss: the near end holds that stream's own
far end delayed), its own noise level and its own `ms_in_sndcard_buf`.
The parameters, each with its source, come from a traffic file (see
`SceneParams`).

The conversation is ITU-T P.59's four states (mutual silence, far end
alone, local end alone, double talk) as a Markov chain in steps of
`step_ms`: each state is left with the probability that gives it its
mean duration, and the transitions are those that give each state its
share of the time.  The far talker talks in "far alone" and "double
talk", the local talker in "local alone" and "double talk".  The streams'
scalars are drawn on the host (numpy, from the seed); the chains and the
signals on the device (torch.Generator, from the seed), the signals in
blocks of streams, in float32, then rounded and saturated to int16.

With two near inputs (a configuration's `near_inputs: 2`: WebRTC's audio
processing module with noise suppression on, which hands AECM the capture
before the suppressor and after it) every stream also gets a clean near
end: its echo and local talker as they are, its noise scaled by the
traffic's `ns_noise_gain_db`, the stand-in for a suppressor that takes the
noise down to its floor and leaves speech and echo alone.  It is made from
the same draws, so far, near and ms are the same with it or without it.

The scenes are periodic: `period_s` seconds that repeat.  The echo is the
far end rolled by its delay around the period, so the near end stays
consistent with the far end across the wrap.  The same seed gives the same
scenes on the same device type.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .harness import NoResult

BLOCK_STREAMS = 2048
FULL_SCALE = 32768.0
# The conversation's states.
SILENCE, FAR, LOCAL, DOUBLE = 0, 1, 2, 3
# rms of `_voice` over a talk spurt, per unit of level: harmonics 1..8 of
# weight 1/k at 0.45 and noise at 0.08, under an envelope sin^2 (mean
# square 3/8).
VOICE_RMS = float(np.sqrt((0.45 ** 2 * sum(0.5 / k ** 2 for k in range(1, 9))
                           + 0.08 ** 2) * 3 / 8))


class SceneParams(NamedTuple):
    """A traffic file's scene parameters (its "scene" object)."""
    step_ms: int                  # the conversation chain's time step
    mutual_silence: tuple         # (share of the time, mean duration s)
    single_talk: tuple            # each end alone: (share, mean s)
    double_talk: tuple            # (share, mean s)
    speech_dbov: tuple            # active speech level range, dBov
    f0_hz: tuple                  # voice pitch range
    syllable_hz: tuple            # syllabic envelope rate range
    echo_erl_db: tuple            # echo return loss range, dB
    echo_extra_ms: tuple          # echo delay beyond ms_in_sndcard_buf
    noise_dbov: tuple             # near-end noise rms range, dBov
    ms_in_sndcard_buf: tuple      # whole ms, uniform range (inclusive)
    ns_noise_gain_db: float | None = None   # the clean near end's noise
    #                                         gain (two near inputs only)

    @classmethod
    def from_traffic(cls, traffic: dict) -> "SceneParams":
        s = traffic["scene"]
        return cls(**{f: (tuple(s[f]) if isinstance(s[f], list) else s[f])
                      for f in cls._fields
                      if f in s or f not in cls._field_defaults})


class Scenes(NamedTuple):
    far: torch.Tensor     # (n_streams, n_samples) int16
    near: torch.Tensor    # (n_streams, n_samples) int16
    ms: torch.Tensor      # (n_streams,) int32
    clean: torch.Tensor | None = None   # (n_streams, n_samples) int16, the
    #                                     clean near end of two near inputs


def _uniform(rng, lo_hi, n):
    lo, hi = lo_hi
    return rng.uniform(lo, hi, n)


def _amplitude(dbov):
    return FULL_SCALE * 10.0 ** (np.asarray(dbov) / 20)


def chain(p: SceneParams):
    """The conversation chain: (shares (4,), leave (4,): the probability of
    leaving each state in a step, jump (4, 4): where a state goes when it
    is left).  The flows in and out of every state balance, so each state
    keeps its share; what single talk leaves to, beyond what the other
    states' shares fix, is a turn handed straight to the other end."""
    sil, one, dbl = p.mutual_silence, p.single_talk, p.double_talk
    shares = np.array([sil[0], one[0], one[0], dbl[0]])
    means = np.array([sil[1], one[1], one[1], dbl[1]])
    visits = shares / means                  # entries a second
    to_silence = visits[SILENCE] / 2         # a second, from each end
    to_double = visits[DOUBLE] / 2
    handover = visits[FAR] - to_silence - to_double
    if handover < 0:
        raise ValueError("the states' shares and durations do not balance")
    jump = np.zeros((4, 4))
    jump[SILENCE, [FAR, LOCAL]] = 0.5
    jump[DOUBLE, [FAR, LOCAL]] = 0.5
    for me, other in ((FAR, LOCAL), (LOCAL, FAR)):
        jump[me, [SILENCE, DOUBLE, other]] = np.array(
            [to_silence, to_double, handover]) / visits[me]
    leave = 1 - np.exp(-p.step_ms / 1000 / means)
    return shares / shares.sum(), leave, jump


def conversation(p: SceneParams, n_streams: int, n_steps: int, gen,
                 device) -> torch.Tensor:
    """(n_streams, n_steps) int8 states on the device, each stream's chain
    started from the states' shares."""
    shares, leave, jump = chain(p)
    f32 = dict(dtype=torch.float32, device=device)
    cum = torch.as_tensor(np.cumsum(jump, axis=1), **f32)
    leave = torch.as_tensor(leave, **f32)
    s = torch.multinomial(torch.as_tensor(shares, **f32), n_streams,
                          replacement=True, generator=gen)
    out = torch.empty((n_streams, n_steps), dtype=torch.int8, device=device)
    for k in range(n_steps):
        out[:, k] = s
        u = torch.rand((2, n_streams), generator=gen, device=device)
        nxt = (u[1, :, None] > cum[s]).sum(dim=1).clamp(max=3)
        s = torch.where(u[0] < leave[s], nxt, s)
    return out


def stream_params(p: SceneParams, n_streams: int, seed: int) -> dict:
    """Each stream's scalars, (n_streams,) arrays."""
    rng = np.random.default_rng([seed, 0x5CE7E])
    n = n_streams
    ms = rng.integers(p.ms_in_sndcard_buf[0], p.ms_in_sndcard_buf[1] + 1, n)
    return {
        "far_level": _amplitude(_uniform(rng, p.speech_dbov, n)) / VOICE_RMS,
        "near_level": _amplitude(_uniform(rng, p.speech_dbov, n)) / VOICE_RMS,
        "far_f0": _uniform(rng, p.f0_hz, n),
        "near_f0": _uniform(rng, p.f0_hz, n),
        "far_syl": _uniform(rng, p.syllable_hz, n),
        "near_syl": _uniform(rng, p.syllable_hz, n),
        "echo_gain": 10.0 ** (-_uniform(rng, p.echo_erl_db, n) / 20),
        "echo_ms": ms + _uniform(rng, p.echo_extra_ms, n),
        "noise_rms": _amplitude(_uniform(rng, p.noise_dbov, n)),
        "ms": ms.astype(np.int32),
    }


def _voice(t, f0, syl, phase, gen):
    """Voiced harmonics under a syllabic envelope, rms VOICE_RMS: t (S,)
    seconds, f0 / syl / phase (B, 1).  Returns (B, S) float32."""
    w = 2 * np.pi * f0 * t
    v = torch.zeros_like(w)
    for k in range(1, 9):
        v += torch.sin(k * w + phase * k) / k
    env = torch.sin(np.pi * syl * t + phase) ** 2
    noise = torch.randn(v.shape, generator=gen, device=v.device)
    return (0.45 * v + 0.08 * noise) * env


def _int16(x):
    return x.round().clamp(-32768, 32767).to(torch.int16)


def make_scenes(p: SceneParams, n_streams: int, sample_rate: int,
                period_s: float, seed: int, device,
                near_inputs: int = 1) -> Scenes:
    """n_streams scenes of period_s seconds at sample_rate, with a clean
    near end when near_inputs is 2 (see the module docstring)."""
    if near_inputs not in (1, 2):
        raise NoResult(f"near_inputs {near_inputs}: AECM takes one near "
                       f"input or two (noisy and clean)")
    if near_inputs == 2 and p.ns_noise_gain_db is None:
        raise NoResult("the configuration has two near inputs and the "
                       "traffic's scene gives no ns_noise_gain_db for the "
                       "clean one")
    device = torch.device(device)
    step = sample_rate * p.step_ms // 1000
    n_steps = int(round(period_s * 1000 / p.step_ms))
    n = n_steps * step
    sp = stream_params(p, n_streams, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    talk = conversation(p, n_streams, n_steps, gen, device)
    far = torch.empty((n_streams, n), dtype=torch.int16, device=device)
    near = torch.empty_like(far)
    clean = torch.empty_like(far) if near_inputs == 2 else None
    if clean is not None:
        ns_gain = 10.0 ** (p.ns_noise_gain_db / 20)
    t = torch.arange(n, device=device, dtype=torch.float32) / sample_rate
    idx = torch.arange(n, device=device)
    for lo in range(0, n_streams, BLOCK_STREAMS):
        hi = min(n_streams, lo + BLOCK_STREAMS)
        b = hi - lo

        def col(name, dtype=torch.float32):
            return torch.as_tensor(sp[name][lo:hi], dtype=dtype,
                                   device=device)[:, None]
        ph = torch.rand((b, 2), generator=gen, device=device) * 2 * np.pi
        states = talk[lo:hi]
        f_mask = ((states == FAR) | (states == DOUBLE)
                  ).repeat_interleave(step, dim=1)
        n_mask = ((states == LOCAL) | (states == DOUBLE)
                  ).repeat_interleave(step, dim=1)
        tt = t[None, :]
        far_sig = (_voice(tt, col("far_f0"), col("far_syl"), ph[:, :1], gen)
                   * f_mask * col("far_level"))
        local = (_voice(tt, col("near_f0"), col("near_syl"), ph[:, 1:], gen)
                 * n_mask * col("near_level"))
        delay = (col("echo_ms", torch.float64) * sample_rate / 1000
                 ).round().long()
        echo = torch.gather(far_sig, 1, torch.remainder(idx[None, :] - delay,
                                                        n))
        noise = torch.randn((b, n), generator=gen, device=device
                            ) * col("noise_rms")
        speech = col("echo_gain") * echo + local
        far[lo:hi] = _int16(far_sig)
        near[lo:hi] = _int16(speech + noise)
        if clean is not None:
            clean[lo:hi] = _int16(speech + ns_gain * noise)
        del far_sig, local, echo, noise, speech
    ms = torch.as_tensor(sp["ms"], dtype=torch.int32, device=device)
    return Scenes(far, near, ms, clean)
