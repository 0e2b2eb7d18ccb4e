"""WAV reader/writer covering the dr_wav input surface the demo CLI uses.

The reference bundles a 6.4 kLoC single-header WAV library (dr_wav.h) whose
demo-facing job is `drwav_open_file_and_read_pcm_frames_s16` (main.cc:41-42):
read ANY common WAV format and hand back int16 PCM.  This module parses the
RIFF container directly (the stdlib `wave` module rejects non-PCM files) and
reproduces dr_wav's sample conversions exactly:

  * PCM  8-bit unsigned -> (x << 8) - 32768         (dr_wav.h:4563-4572)
  * PCM 16-bit          -> as-is
  * PCM 24-bit          -> sign-extended >> 8       (dr_wav.h:4574-4584)
  * PCM 32-bit          -> x >> 16                  (dr_wav.h:4586-4594)
  * IEEE float 32/64    -> (clip(x,-1,1)+1)*32767.5 - 32768, truncated
                                                    (dr_wav.h:4596-4622)
  * A-law / mu-law      -> G.711 decode             (dr_wav.h:4237-4305)
  * WAVE_FORMAT_EXTENSIBLE resolves via the SubFormat GUID's leading tag
                                                    (dr_wav.h:274-280)

The reference CLI rejects multi-channel files (main.cc:46-52); we downmix
to mono by averaging instead — a strict superset kept from earlier rounds.

A copy of webrtc_aecm_tpu/utils/wav.py (the port imports nothing of the
JAX package); keep the two alike.  Its float decode runs in float64, as
the JAX package's does (dr_wav multiplies in float32, so some float WAV
inputs land 1 LSB apart from dr_wav; the port is held to the JAX package).
"""
from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np


def _alaw_to_s16(a: np.ndarray) -> np.ndarray:
    """G.711 A-law decode; equals dr_wav's g_drwavAlawTable
    (dr_wav.h:4237-4270; spot-verified against the table)."""
    a = a.astype(np.int32)
    t = (a ^ 0x55) & 0x7F
    seg = (t & 0x70) >> 4
    mant = t & 0x0F
    val = np.where(seg == 0, (mant << 4) + 8,
                   ((mant << 4) + 0x108) << np.maximum(seg - 1, 0))
    return np.where(a & 0x80, val, -val)


def _mulaw_to_s16(u: np.ndarray) -> np.ndarray:
    """G.711 mu-law decode; equals dr_wav's g_drwavMulawTable
    (dr_wav.h:4272-4305; spot-verified against the table)."""
    u = (~u.astype(np.int32)) & 0xFF
    exp = (u & 0x70) >> 4
    mant = u & 0x0F
    val = (((mant << 3) + 0x84) << exp) - 0x84
    return np.where(u & 0x80, -val, val)


def _decode_to_s16(raw: bytes, fmt: int, bits: int) -> np.ndarray:
    """Decode one data payload to int16-range int32 samples, matching
    drwav_read_pcm_frames_s16's per-format conversions."""
    if fmt == 1:            # PCM
        if bits == 8:
            return (np.frombuffer(raw, np.uint8).astype(np.int32) << 8) - 32768
        if bits == 16:
            return np.frombuffer(raw, "<i2").astype(np.int32)
        if bits == 24:
            b = np.frombuffer(raw, np.uint8)[: (len(raw) // 3) * 3]
            b = b.reshape(-1, 3).astype(np.uint32)
            x = (b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)
            return (x.astype(np.int32) >> 8) >> 8
        if bits == 32:
            return np.frombuffer(raw, "<i4") >> 16
        raise ValueError(f"unsupported PCM bit depth: {bits}")
    if fmt == 3:            # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, "<f4").astype(np.float64)
        elif bits == 64:
            x = np.frombuffer(raw, "<f8")
        else:
            raise ValueError(f"unsupported float bit depth: {bits}")
        # trunc() reproduces the C (int) cast; the operand is >= 0
        return (np.trunc((np.clip(x, -1.0, 1.0) + 1.0) * 32767.5)
                .astype(np.int32) - 32768)
    if fmt == 6:            # A-law
        return _alaw_to_s16(np.frombuffer(raw, np.uint8))
    if fmt == 7:            # mu-law
        return _mulaw_to_s16(np.frombuffer(raw, np.uint8))
    raise ValueError(f"unsupported WAV format tag: 0x{fmt:X}")


def read_wav_int16(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file as mono int16 PCM.  Returns (samples, sample_rate)."""
    with open(path, "rb") as f:
        hdr = f.read(12)
        if len(hdr) < 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = bits = n_channels = rate = None
        data = None
        while True:
            ck = f.read(8)
            if len(ck) < 8:
                break
            cid, size = ck[:4], struct.unpack("<I", ck[4:])[0]
            if cid == b"fmt ":
                body = f.read(size)
                (fmt, n_channels, rate, _, _,
                 bits) = struct.unpack("<HHIIHH", body[:16])
                if fmt == 0xFFFE and size >= 40:   # EXTENSIBLE
                    fmt = struct.unpack("<H", body[24:26])[0]
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size, 1)
            if size % 2:                            # RIFF word padding
                f.seek(1, 1)
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    samples = _decode_to_s16(data, fmt, bits)
    if n_channels > 1:
        samples = (samples[: (len(samples) // n_channels) * n_channels]
                   .reshape(-1, n_channels).mean(axis=1).astype(np.int64))
    return np.clip(samples, -32768, 32767).astype(np.int16), rate


def write_wav_int16(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono int16 PCM to a WAV file."""
    samples = np.asarray(samples)
    if samples.ndim != 1:
        raise ValueError("write_wav_int16 expects a 1-D mono signal")
    samples = np.clip(samples, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(samples.tobytes())
