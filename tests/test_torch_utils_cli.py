"""The port's WAV I/O, metrics and demo CLI (reference: main.cc, dr_wav.h).

The 13 tests of tests/test_utils_cli.py against webrtc_aecm_tpu_torch.utils
(the CLI on device="cpu", where it takes the plain PyTorch versions), and
the CLI's output samples against the JAX CLI's in
tests/data/torch_golden_surface.npz (`cli.*`, written by
tools/make_torch_golden_surface.py), tolerance 0: single pairs at 8 and
16 kHz whose length is not a whole number of chunks, the `--batch` list
and the float32 pair.  `python -m webrtc_aecm_tpu_torch` runs the same
main.  No test here compiles a JAX function.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from webrtc_aecm_tpu_torch.utils import (erle_db, read_wav_int16,
                                         segment_erle_db, write_wav_int16)
from webrtc_aecm_tpu_torch.utils import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_surface.npz")
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden_surface",
    os.path.join(REPO, "tools", "make_torch_golden_surface.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)    # numpy only at import: the scenes


def cli_main(argv):
    """The port's CLI on the CPU (its default is the CUDA card)."""
    return cli.main(list(argv) + ["--device", "cpu"])


def _golden(key):
    with np.load(GOLDEN) as g:
        return g[key]


def test_wav_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    pcm = rng.integers(-32768, 32768, 4000).astype(np.int16)
    path = str(tmp_path / "x.wav")
    write_wav_int16(path, pcm, 8000)
    back, rate = read_wav_int16(path)
    assert rate == 8000
    np.testing.assert_array_equal(back, pcm)


def test_wav_stereo_downmix(tmp_path):
    import wave
    pcm = np.stack([np.arange(100, dtype=np.int16),
                    np.arange(100, dtype=np.int16) + 100], axis=1)
    path = str(tmp_path / "st.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype("<i2").tobytes())
    mono, rate = read_wav_int16(path)
    assert rate == 16000
    np.testing.assert_array_equal(mono, np.arange(100) + 50)


def _write_raw_wav(path, fmt, bits, payload, rate=8000, channels=1,
                   extensible=False):
    """Hand-rolled RIFF writer for formats stdlib `wave` cannot produce."""
    import struct
    if extensible:
        ext = struct.pack("<HHI", 22, bits, 1) + struct.pack("<H", fmt) + \
            b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt_body = struct.pack("<HHIIHH", 0xFFFE, channels, rate,
                               rate * channels * bits // 8,
                               channels * bits // 8, bits) + ext
    else:
        fmt_body = struct.pack("<HHIIHH", fmt, channels, rate,
                               rate * channels * bits // 8,
                               channels * bits // 8, bits)
    chunks = (b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
              + b"data" + struct.pack("<I", len(payload)) + payload
              + (b"\x00" if len(payload) % 2 else b""))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE"
                + chunks)


def test_wav_float32_reads_like_int16(tmp_path):
    """An IEEE-float WAV decodes to the int16 samples dr_wav would produce
    (dr_wav.h:4596-4608: (clip+1)*32767.5 - 32768, truncated)."""
    rng = np.random.default_rng(3)
    pcm = rng.integers(-32768, 32768, 1000).astype(np.int16)
    f32 = (pcm.astype(np.float64) + 32768.0) / 32767.5 - 1.0
    path = str(tmp_path / "f32.wav")
    _write_raw_wav(path, 3, 32, f32.astype("<f4").tobytes())
    back, rate = read_wav_int16(path)
    assert rate == 8000
    # float32 storage of the exact grid point can land one LSB low
    assert np.max(np.abs(back.astype(np.int32) - pcm)) <= 1
    # exact values: representable grid points round-trip exactly
    exact = np.asarray([-1.0, 0.0, 1.0, 0.5, -0.5, 2.0, -3.0], "<f4")
    _write_raw_wav(path, 3, 32, exact.tobytes())
    back, _ = read_wav_int16(path)
    np.testing.assert_array_equal(
        back, [-32768, -1, 32767, 16383, -16385, 32767, -32768])


def test_wav_float64_and_extensible(tmp_path):
    x = np.asarray([-1.0, 0.25, 1.0], "<f8")
    path = str(tmp_path / "f64.wav")
    _write_raw_wav(path, 3, 64, x.tobytes())
    back, _ = read_wav_int16(path)
    np.testing.assert_array_equal(back, [-32768, 8191, 32767])
    # WAVE_FORMAT_EXTENSIBLE wrapping IEEE float (dr_wav.h:274-280)
    _write_raw_wav(path, 3, 64, x.tobytes(), extensible=True)
    back, _ = read_wav_int16(path)
    np.testing.assert_array_equal(back, [-32768, 8191, 32767])


def test_wav_pcm24_and_pcm32(tmp_path):
    vals = np.asarray([-(1 << 23), -1, 0, 1, (1 << 23) - 1], np.int32)
    b = np.zeros((len(vals), 3), np.uint8)
    u = vals.astype(np.uint32)
    b[:, 0], b[:, 1], b[:, 2] = u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF
    path = str(tmp_path / "p24.wav")
    _write_raw_wav(path, 1, 24, b.tobytes())
    back, _ = read_wav_int16(path)
    np.testing.assert_array_equal(back, vals >> 8)   # dr_wav.h:4574-4584

    v32 = np.asarray([-(1 << 31), -65536, 0, 65536, (1 << 31) - 1], "<i4")
    _write_raw_wav(path, 1, 32, v32.tobytes())
    back, _ = read_wav_int16(path)
    np.testing.assert_array_equal(back, np.asarray(v32) >> 16)


def test_wav_g711(tmp_path):
    """A-law/mu-law payloads decode to dr_wav's table values (spot values
    from g_drwavAlawTable/g_drwavMulawTable, dr_wav.h:4237-4305)."""
    path = str(tmp_path / "g711.wav")
    _write_raw_wav(path, 6, 8, bytes([0, 1, 2, 3, 128, 255]))
    back, _ = read_wav_int16(path)
    np.testing.assert_array_equal(
        back, [-5504, -5248, -6016, -5760, 5504, 848])
    _write_raw_wav(path, 7, 8, bytes([0, 1, 2, 3, 128, 255]))
    back, _ = read_wav_int16(path)
    np.testing.assert_array_equal(
        back, [-32124, -31100, -30076, -29052, 32124, 0])


def test_cli_accepts_float_wav(tmp_path):
    """A float32 WAV pair runs the demo CLI and produces the same output
    as the int16-converted equivalent (main.cc:40-54 via dr_wav)."""
    fs = 8000
    rng = np.random.default_rng(4)
    n = fs // 2
    t = np.arange(n + 320)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
    ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far = ff[320:320 + n].astype(np.int16)
    near = (0.4 * ff[:n]).clip(-32000, 32000).astype(np.int16)

    to_f32 = lambda p: ((p.astype(np.float64) + 32768.0) / 32767.5
                        - 1.0).astype("<f4")
    _write_raw_wav(str(tmp_path / "far.wav"), 3, 32, to_f32(far).tobytes(),
                   rate=fs)
    _write_raw_wav(str(tmp_path / "near.wav"), 3, 32, to_f32(near).tobytes(),
                   rate=fs)
    far_i, _ = read_wav_int16(str(tmp_path / "far.wav"))
    near_i, _ = read_wav_int16(str(tmp_path / "near.wav"))
    write_wav_int16(str(tmp_path / "far_i.wav"), far_i, fs)
    write_wav_int16(str(tmp_path / "near_i.wav"), near_i, fs)

    assert cli_main([str(tmp_path / "far.wav"),
                     str(tmp_path / "near.wav")]) == 0
    assert cli_main([str(tmp_path / "far_i.wav"),
                     str(tmp_path / "near_i.wav")]) == 0
    a, _ = read_wav_int16(str(tmp_path / "near_out.wav"))
    b, _ = read_wav_int16(str(tmp_path / "near_i_out.wav"))
    np.testing.assert_array_equal(a, b)
    # and it is the JAX CLI's output on the same float32 pair
    g_far, g_near, _ = gen.cli_float_pair()
    np.testing.assert_array_equal(far, g_far)
    np.testing.assert_array_equal(near, g_near)
    np.testing.assert_array_equal(a, _golden("cli.f32.out"))


def test_erle_basic():
    rng = np.random.default_rng(1)
    near = rng.normal(0, 1000, 8000)
    out = near * 0.1  # 20 dB suppression
    assert abs(erle_db(near, out) - 20.0) < 0.01
    seg = segment_erle_db(near, out, frame=80)
    assert seg.shape == (100,)
    np.testing.assert_allclose(seg, 20.0, atol=0.01)


def test_erle_far_gating():
    near = np.ones(1600) * 1000.0
    out = near * 0.1
    far = np.zeros(1600)
    far[:800] = 5000.0  # far active only in the first half
    e = erle_db(near, out, far)
    assert abs(e - 20.0) < 0.01


def test_cli_end_to_end(tmp_path):
    fs = 8000
    rng = np.random.default_rng(2)
    n = fs  # 1 s
    t = np.arange(n + 320)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
    far_full = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far = far_full[320:320 + n].astype(np.int16)
    near = (0.4 * far_full[:n] + rng.normal(0, 100, n)).clip(
        -32000, 32000).astype(np.int16)

    far_path = str(tmp_path / "far.wav")
    near_path = str(tmp_path / "near.wav")
    write_wav_int16(far_path, far, fs)
    write_wav_int16(near_path, near, fs)

    rc = cli_main([far_path, near_path, "--erle"])
    assert rc == 0
    out_path = str(tmp_path / "near_out.wav")
    assert os.path.exists(out_path)
    out, rate = read_wav_int16(out_path)
    assert rate == fs and len(out) == n


def test_cli_rejects_rate_mismatch(tmp_path):
    write_wav_int16(str(tmp_path / "a.wav"), np.zeros(100, np.int16), 8000)
    write_wav_int16(str(tmp_path / "b.wav"), np.zeros(100, np.int16), 16000)
    rc = cli_main([str(tmp_path / "a.wav"), str(tmp_path / "b.wav")])
    assert rc == 2


def test_cli_rejects_unsupported_rate(tmp_path):
    write_wav_int16(str(tmp_path / "a.wav"), np.zeros(100, np.int16), 44100)
    write_wav_int16(str(tmp_path / "b.wav"), np.zeros(100, np.int16), 44100)
    rc = cli_main([str(tmp_path / "a.wav"), str(tmp_path / "b.wav")])
    assert rc == 2


def test_cli_batch_mode(tmp_path):
    fs = 8000
    rng = np.random.default_rng(7)
    lines = []
    scenes = []
    for k in range(3):
        n = fs // 2 + 80 * k
        t = np.arange(n + 240)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
        ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
        far = ff[240:240 + n].astype(np.int16)
        near = (0.4 * ff[:n]).clip(-32000, 32000).astype(np.int16)
        fp, np_ = str(tmp_path / f"far{k}.wav"), str(tmp_path / f"near{k}.wav")
        write_wav_int16(fp, far, fs)
        write_wav_int16(np_, near, fs)
        lines.append(f"{fp} {np_}")
        scenes.append((far, near, n))
    lst = str(tmp_path / "list.txt")
    open(lst, "w").write("\n".join(lines) + "\n")
    rc = cli_main(["--batch", lst, "--erle"])
    assert rc == 0
    for k, (far, near, n) in enumerate(scenes):
        out, rate = read_wav_int16(str(tmp_path / f"near{k}_out.wav"))
        assert rate == fs and len(out) == n
        # the JAX CLI's output on the same list
        np.testing.assert_array_equal(near, gen.cli_batch_pairs()[0][k][1])
        np.testing.assert_array_equal(out, _golden(f"cli.batch{k}.out"))

    # batch output must equal the single-pair CLI output, pair by pair
    rc = cli_main([lines[0].split()[0], lines[0].split()[1],
                   "-o", str(tmp_path / "single0.wav")])
    assert rc == 0
    single, _ = read_wav_int16(str(tmp_path / "single0.wav"))
    batch_out, _ = read_wav_int16(str(tmp_path / "near0_out.wav"))
    np.testing.assert_array_equal(batch_out, single)


@pytest.mark.parametrize("name", list(gen.CLI))
def test_cli_output_matches_jax(tmp_path, name):
    """A single pair through the CLI with --erle --echo-mode 3 == the JAX
    CLI's output file, the tail past the last whole chunk included."""
    far, near, fs = gen.cli_pair(name)
    assert len(near) % (fs // 100) != 0
    write_wav_int16(str(tmp_path / "far.wav"), far, fs)
    write_wav_int16(str(tmp_path / "near.wav"), near, fs)
    assert cli_main([str(tmp_path / "far.wav"), str(tmp_path / "near.wav")]
                    + gen.CLI_FLAGS) == 0
    out, rate = read_wav_int16(str(tmp_path / "near_out.wav"))
    assert rate == fs
    np.testing.assert_array_equal(out, _golden(f"cli.{name}.out"))
    tail = len(near) % (fs // 100)
    np.testing.assert_array_equal(out[-tail:], near[-tail:])


def test_python_dash_m_runs_the_cli(tmp_path):
    """`python -m webrtc_aecm_tpu_torch far.wav near.wav --device cpu`
    writes near_out.wav and exits 0; a rate mismatch exits 2."""
    write_wav_int16(str(tmp_path / "far.wav"), np.zeros(800, np.int16), 8000)
    write_wav_int16(str(tmp_path / "near.wav"),
                    np.full(800, 100, np.int16), 8000)
    write_wav_int16(str(tmp_path / "wide.wav"), np.zeros(800, np.int16),
                    16000)
    env = dict(os.environ, PYTHONPATH=REPO)
    run = [sys.executable, "-m", "webrtc_aecm_tpu_torch"]
    r = subprocess.run(run + [str(tmp_path / "far.wav"),
                              str(tmp_path / "near.wav"), "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    out, rate = read_wav_int16(str(tmp_path / "near_out.wav"))
    assert rate == 8000 and len(out) == 800
    r = subprocess.run(run + [str(tmp_path / "far.wav"),
                              str(tmp_path / "wide.wav"), "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 2


def test_cli_empty_batch_list_exits_2(tmp_path):
    lst = tmp_path / "list.txt"
    lst.write_text("# nothing\n\n")
    assert cli_main(["--batch", str(lst)]) == 2
