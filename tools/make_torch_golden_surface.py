"""Write the golden file of the port's outer surface.

The PyTorch port (webrtc_aecm_tpu_torch) runs on a machine without JAX, so
the JAX package's answers travel as data.  This tool runs the JAX package on
the CPU and writes

    tests/data/torch_golden_surface.npz   (compressed)

with the JAX answers; the inputs are rebuilt from the seeds below with
numpy.  One group of keys per entry:

* `dbg.<name>.*`: `api.AecmInstance.process(..., debug=True)` call by call
  (BufferFarend then Process per 10 ms) at 8 kHz, at 16 kHz and at 16 kHz
  with a clean input, past the startup and until the delay estimator has
  an estimate, one call with an out-of-range sound-card delay: `out`
  (calls, n) int16, `warn` (calls,) and every tap, `tap.<tap>` (calls,
  n_frames, 2, ...).  `8k_b` is a second 8 kHz stream (another seed and
  echo delay): the port runs it beside `8k` as a batch of two;
* `cli.<name>.out`: the JAX CLI's output WAV samples (`utils.cli.main`):
  `8k` and `16k` (seeded pairs whose length is not a whole number of
  chunks, `--erle --echo-mode 3`), `batch0..2` (tests/test_utils_cli.py's
  `--batch` list of 3 pairs) and `f32` (its float32 WAV pair);
* `erle.<scene>.*`: tools/erle_report.py's 10 scenes through the JAX
  batch-major engine, as that tool runs them: `sha_out` (SHA-256 of the
  output's int16 bytes), `erle` (dB, the tool's 2 s skip), and the scene
  generator's own `sha_far`, `sha_near` (and `sha_clean`), so that a
  changed generator shows;
* `long.*`: tests/test_long_call.py's drift sequence (AecmPipeline(2,
  8000), five 2 s segments): `seg_sha` (5,) of the outputs and the final
  state under `state.<dotted field path>`;
* `frames.<case>.*`: `fused.frames_step` (jitted, the pure path) in the
  circular mode at 16 kHz, 4 frames, 8 streams, on the inputs that the
  port's serving step gives on the desync scene of
  tests/test_torch_frames.py (`frames_capture`: the steps of COMPARED) and
  on the planted cases made from the last of them (`frames_plant`):
  `in_sha` over the inputs, and `sha`, the digests (`digest`) of the
  outputs and core leaves in the order of `frames.names`
  (`frames_outputs`).  This entry alone runs the port (on the CPU, plain
  path) to make the inputs.

tests/test_torch_debug.py, test_torch_utils_cli.py, test_torch_erle.py,
test_torch_long_call.py and test_torch_frames.py hold the port's plain
paths to it; chip_smoke.py holds the kernel paths to it on the card.
Regenerate after a change to the JAX package or to a scene (a few minutes
of JAX compiles):

    JAX_PLATFORMS=cpu python tools/make_torch_golden_surface.py
"""
from __future__ import annotations

import hashlib
import io
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_golden_surface.npz")

# (a) name: (sample rate, calls, seed, echo delay in samples, clean input)
DBG = {
    "8k": (8000, 100, 11, 640, False),
    "8k_b": (8000, 100, 15, 760, False),
    "16k": (16000, 50, 12, 1120, False),
    "16k_clean": (16000, 50, 13, 1280, True),
}
BAD_MS_CALL, BAD_MS = 7, 520      # one call with an out-of-range delay


def dbg_inputs(name):
    """far, near, clean (None without) int16 (n_samples,) and the per-call
    sound-card delays of debug entry `name`."""
    fs, calls, seed, delay, with_clean = DBG[name]
    n = calls * (fs // 100)
    rng = np.random.default_rng(seed)
    t = np.arange(n + delay)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
    ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far = ff[delay:delay + n].astype(np.int16)
    near = (0.4 * ff[:n] + rng.normal(0, 100, n)).clip(
        -32000, 32000).astype(np.int16)
    clean = None
    if with_clean:
        clean = (0.05 * near + rng.normal(0, 300, n)).clip(
            -32000, 32000).astype(np.int16)
    ms = np.full(calls, 40, np.int32)
    ms[BAD_MS_CALL] = BAD_MS
    ms[calls // 2:calls // 2 + 4] += 60
    return far, near, clean, ms


# (b) name: (sample rate, seconds of audio, extra samples, seed); run with
# CLI_FLAGS
CLI = {"8k": (8000, 0.5, 37, 21), "16k": (16000, 0.5, 53, 22)}
CLI_FLAGS = ["--erle", "--echo-mode", "3"]


def cli_pair(name):
    """(far, near, rate) int16 of CLI entry `name`: modulated noise and its
    echo 40 ms late plus noise."""
    fs, secs, extra, seed = CLI[name]
    n = int(fs * secs) + extra
    rng = np.random.default_rng(seed)
    d = fs // 25
    t = np.arange(n + d)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
    ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far = ff[d:d + n].astype(np.int16)
    near = (0.4 * ff[:n] + rng.normal(0, 100, n)).clip(
        -32000, 32000).astype(np.int16)
    return far, near, fs


def cli_batch_pairs():
    """tests/test_utils_cli.py::test_cli_batch_mode's 3 pairs at 8 kHz."""
    fs = 8000
    rng = np.random.default_rng(7)
    pairs = []
    for k in range(3):
        n = fs // 2 + 80 * k
        t = np.arange(n + 240)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
        ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
        far = ff[240:240 + n].astype(np.int16)
        near = (0.4 * ff[:n]).clip(-32000, 32000).astype(np.int16)
        pairs.append((far, near))
    return pairs, fs


def cli_float_pair():
    """tests/test_utils_cli.py::test_cli_accepts_float_wav's pair (int16)
    and its float32 encoding, at 8 kHz."""
    fs = 8000
    rng = np.random.default_rng(4)
    n = fs // 2
    t = np.arange(n + 320)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
    ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far = ff[320:320 + n].astype(np.int16)
    near = (0.4 * ff[:n]).clip(-32000, 32000).astype(np.int16)
    return far, near, fs


def to_float32(pcm):
    """The float32 WAV payload of test_cli_accepts_float_wav."""
    return ((pcm.astype(np.float64) + 32768.0) / 32767.5 - 1.0
            ).astype("<f4")


def write_raw_wav(path, fmt, bits, payload, rate=8000, channels=1):
    """A RIFF file with a plain fmt chunk (stdlib `wave` writes PCM only)."""
    import struct
    fmt_body = struct.pack("<HHIIHH", fmt, channels, rate,
                           rate * channels * bits // 8,
                           channels * bits // 8, bits)
    chunks = (b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
              + b"data" + struct.pack("<I", len(payload)) + payload
              + (b"\x00" if len(payload) % 2 else b""))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE"
                + chunks)


# (c) the scenes of tools/erle_report.py, in its order
ERLE_SCENES = (["8k_demo_mode1"] + [f"8k_mode{m}" for m in range(5)]
               + ["8k_cng_off", "16k_default", "16k_variable_delay",
                  "16k_clean_input"])


def sha(x) -> str:
    """SHA-256 of an int16 signal's bytes."""
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(x).astype("<i2")).tobytes()).hexdigest()


# (d) tests/test_long_call.py's drift sequence
LONG_FS, LONG_SEGMENTS = 8000, 5


def long_segments():
    """The five 2 s segments (far (2, n), near (2, n), ms) of
    test_long_call_with_delay_drift, from its one generator."""
    fs = LONG_FS
    rng = np.random.default_rng(0)
    seg = 2 * fs
    out = []
    for k in range(LONG_SEGMENTS):
        t = np.arange(seg + 400)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * (t + k * seg) / (fs // 3))
        ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
        far = np.stack([ff[400:400 + seg], ff[200:200 + seg]]
                       ).astype(np.int16)
        near = (0.4 * ff[:seg] + rng.normal(0, 150, seg)).clip(
            -32000, 32000).astype(np.int16)
        out.append((far, np.stack([near, near]), 40 + 25 * (k % 3)))
    return out


# (e) frames_step on the port's serving path: the desync scene of
# tests/test_torch_frames.py at 16 kHz, 2 chunks a step, 8 streams
FRAMES_FS, FRAMES_B, FRAMES_STEPS = 16000, 8, 20
COMPARED = (1, 3, 5, 9, 14, 19)
PLANTED = ("two_equal_minima", "no_candidate_under_the_limit",
           "fresh_estimator_all_equal", "run_rows_none",
           "run_rows_last_two", "run_rows_all_four",
           "delay_across_the_head_wrap")


def frames_scene():
    """Desync scene (40-sample offsets per stream, per-(chunk, stream)
    sound-card delays, delay burst at chunk 24)."""
    fs, b = FRAMES_FS, FRAMES_B
    n_chunks = 2 * FRAMES_STEPS
    n = n_chunks * 160
    rng = np.random.default_rng(0)
    t = np.arange(n + 640)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
    ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far = np.stack([ff[640 - 40 * i:640 - 40 * i + n]
                    for i in range(b)]).astype(np.int16)
    near = (0.4 * far + rng.normal(0, 150, far.shape)
            ).clip(-32000, 32000).astype(np.int16)
    ms = np.full((n_chunks, b), 40, np.int32)
    ms += 15 * (np.arange(b, dtype=np.int32) % 5)[None, :]
    ms[24:30] += 80
    ms[:20] += 23 * (np.arange(b, dtype=np.int32) % 7)[None, :]
    return far, near, ms


def frames_capture():
    """Run the port's serving step (plain path, CPU) over frames_scene and
    return {step: (core in, frames_step args, result)} for the steps of
    COMPARED (copies: the step appends to far_history in place)."""
    import torch
    from webrtc_aecm_tpu_torch import fused as tf
    far, near, ms = frames_scene()
    records = {}
    orig = tf.frames_step
    step_no = [0]

    def recording(core, *args):
        res = orig(core, *args)
        if step_no[0] in COMPARED:
            records[step_no[0]] = (tf.clone_state(core), args,
                                   (tf.clone_state(res[0]),) + res[1:])
        step_no[0] += 1
        return res

    tf.frames_step = recording
    try:
        step = tf.FusedAecm(FRAMES_FS, 2, use_kernel=False, device="cpu")
        st = tf.create_fused(FRAMES_B, FRAMES_FS, device="cpu")
        st = st._replace(core=tf._to_circular_far(st.core))
        head = 0
        for s in range(FRAMES_STEPS):
            lo = s * 320
            st, head, _, _ = step(
                st, head, torch.as_tensor(far[:, lo:lo + 320]).int(),
                torch.as_tensor(near[:, lo:lo + 320]).int().T,
                torch.as_tensor(ms[2 * s:2 * s + 2]))
    finally:
        tf.frames_step = orig
    return records


def frames_plant(name, core, far, noisy, phase, run_rows):
    """Plants case `name` into copies of a warm captured call (all 8
    streams); returns the new arguments and the circular head to use."""
    import torch
    from webrtc_aecm_tpu_torch import fused as tf
    fills = torch.tensor([0, 16, 32, 48, 0, 16, 32, 48], dtype=torch.int32)
    core = tf.clone_state(core)
    run_rows = run_rows.clone()
    head = 20
    near = core.de_near
    if name == "two_equal_minima":
        # far-end rows sliding past rows 17 and 60 during the 5 blocks are
        # empty, so the two planted valleys stay equal
        for r in (17, 60):
            near.mean_bit_counts[r] = 0
            core.de_farend.bit_counts[r - 5:r] = 0
            core.de_farend.binary_history[r - 5:r] = 0
    elif name == "no_candidate_under_the_limit":
        near.mean_bit_counts[:] = 20000           # > 32 << 9, every row
    elif name == "fresh_estimator_all_equal":
        fresh = tf.create_fused(FRAMES_B, FRAMES_FS, device="cpu").core
        core = core._replace(de_near=fresh.de_near,
                             de_farend=fresh.de_farend)
    elif name.startswith("run_rows_"):
        rows = {"run_rows_none": [0, 0, 0, 0],
                "run_rows_last_two": [0, 0, 1, 1],
                "run_rows_all_four": [1, 1, 1, 1]}[name]
        run_rows[:] = torch.tensor(rows, dtype=torch.bool)[:, None]
        core.frame_fill[0] = fills
        core.out_fill[0] = 48 - fills
        core.out_fill[0, 4:] = 0                  # still zero-stuffing
    elif name == "delay_across_the_head_wrap":
        head = 95
        core.fixed_delay[0] = torch.tensor([0, 4, 5, 50, 94, 97, 99, -1],
                                           dtype=torch.int32)
    else:
        raise ValueError(name)
    return core, far, noisy, phase, run_rows, head


def digest(x) -> str:
    """SHA-256 of an array's shape and values: integers as int64 (the port
    holds some uint32 leaves in int64), floats as float32."""
    a = np.asarray(x)
    a = a.astype("<f4") if a.dtype.kind == "f" else a.astype("<i8")
    h = hashlib.sha256(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def frames_outputs(core, out, pend_hist, pend_q):
    """[(name, array)] of a frames_step result in the golden's order: the
    outputs, then every core leaf by its dotted path."""
    return ([("out", out), ("pend_hist", pend_hist), ("pend_q", pend_q)]
            + [(f"core.{p}", x) for p, x in leaves_with_path(core)])


def frames_input_digest(core, far, noisy, phase, run_rows, head) -> str:
    h = hashlib.sha256()
    for _, x in leaves_with_path(core):
        h.update(digest(x).encode())
    for x in (far, noisy, phase, run_rows, np.int32(head)):
        h.update(digest(x).encode())
    return h.hexdigest()


def frames_cases():
    """{case: (core, far, noisy, phase, run_rows, head)} of the port's
    captured steps and the planted cases, as numpy arrays."""
    recs = frames_capture()
    cases = {}
    for step in COMPARED:
        core, args, _ = recs[step]
        cases[f"step{step}"] = (core, args[1], args[2], args[4], args[5],
                                args[11])
    core, args, _ = recs[COMPARED[-1]]
    for name in PLANTED:
        cases[name] = frames_plant(name, core, args[1], args[2], args[4],
                                   args[5])
    return cases


def leaves_with_path(tree, prefix=""):
    """[(dotted field path, leaf)] of a NamedTuple tree, in field order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += leaves_with_path(getattr(tree, f), f"{prefix}{f}.")
        return out
    return [(prefix[:-1], tree)]


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from webrtc_aecm_tpu import api
    from webrtc_aecm_tpu import fused as jf
    from webrtc_aecm_tpu.models import AecmPipeline
    from webrtc_aecm_tpu.utils import cli, read_wav_int16, write_wav_int16
    from webrtc_aecm_tpu.utils.metrics import erle_db

    t_all = time.perf_counter()
    arrays = {}

    # (a) the debug taps, call by call
    for name, (fs, calls, _, _, _) in DBG.items():
        far, near, clean, ms = dbg_inputs(name)
        n = fs // 100
        inst = api.AecmInstance(fs)
        outs, warns, taps = [], [], []
        for c in range(calls):
            cols = slice(c * n, (c + 1) * n)
            inst.buffer_farend(far[cols])
            out, warn, tap = inst.process(
                near[cols], None if clean is None else clean[cols],
                int(ms[c]), debug=True)
            outs.append(out)
            warns.append(warn)
            taps.append(tap)
        p = f"dbg.{name}"
        arrays[f"{p}.out"] = np.stack(outs)
        arrays[f"{p}.warn"] = np.asarray(warns, np.int32)
        for k in taps[0]:
            arrays[f"{p}.tap.{k}"] = np.stack([t[k] for t in taps])
        assert int(np.asarray(inst.state.ec_startup)) == 0, name
        assert arrays[f"{p}.tap.delay_blocks"][-1].max() > 0, name
        assert arrays[f"{p}.warn"][BAD_MS_CALL] != 0, name
        print(f"dbg {name} ({time.perf_counter() - t_all:.0f} s)",
              flush=True)

    # (b) the CLI's output files
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)
        for name in CLI:
            far, near, fs = cli_pair(name)
            write_wav_int16(path(f"far_{name}.wav"), far, fs)
            write_wav_int16(path(f"near_{name}.wav"), near, fs)
            assert cli.main([path(f"far_{name}.wav"),
                             path(f"near_{name}.wav")] + CLI_FLAGS) == 0
            out, rate = read_wav_int16(path(f"near_{name}_out.wav"))
            assert rate == fs and len(out) == len(near)
            arrays[f"cli.{name}.out"] = out
        pairs, fs = cli_batch_pairs()
        lines = []
        for k, (far, near) in enumerate(pairs):
            write_wav_int16(path(f"far{k}.wav"), far, fs)
            write_wav_int16(path(f"near{k}.wav"), near, fs)
            lines.append(f"{path(f'far{k}.wav')} {path(f'near{k}.wav')}")
        with open(path("list.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        assert cli.main(["--batch", path("list.txt"), "--erle"]) == 0
        for k in range(len(pairs)):
            arrays[f"cli.batch{k}.out"] = read_wav_int16(
                path(f"near{k}_out.wav"))[0]
        far, near, fs = cli_float_pair()
        write_raw_wav(path("far_f32.wav"), 3, 32, to_float32(far).tobytes(),
                      rate=fs)
        write_raw_wav(path("near_f32.wav"), 3, 32,
                      to_float32(near).tobytes(), rate=fs)
        assert cli.main([path("far_f32.wav"), path("near_f32.wav")]) == 0
        arrays["cli.f32.out"] = read_wav_int16(path("near_f32_out.wav"))[0]
    print(f"cli ({time.perf_counter() - t_all:.0f} s)", flush=True)

    # (c) the ERLE battery, as tools/erle_report.py runs it
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import erle_report as er
    groups = []
    fs, n_s = 8000, 6.0
    b8 = len(ERLE_SCENES[:7])
    far = np.zeros((b8, int(fs * n_s)), np.int16)
    near = np.zeros_like(far)
    for b in range(b8):
        far[b], near[b] = er._scene(fs, n_s, delay_ms=64.0, echo_gain=0.42,
                                    seed=100 + b)
    cng = np.array([1, 1, 1, 1, 1, 1, 0], np.int32)
    mode = np.array([1, 0, 1, 2, 3, 4, 3], np.int32)
    groups.append((ERLE_SCENES[:7], fs, far, near, None,
                   er._run_ours(fs, far, near, 40, cng, mode)))
    fs = 16000
    far = np.zeros((2, int(fs * n_s)), np.int16)
    near = np.zeros_like(far)
    far[0], near[0] = er._scene(fs, n_s, delay_ms=32.0, echo_gain=0.42,
                                seed=200)
    far[1], near[1] = er._scene(fs, n_s, delay_ms=48.0, echo_gain=0.42,
                                seed=201)
    n_chunks = far.shape[1] // 160
    ms = np.full((n_chunks, 2), 40, np.int32)
    ms[:, 1] += (25 * np.sin(np.arange(n_chunks) / 17.0)).astype(np.int32)
    ms[n_chunks // 2:n_chunks // 2 + 8, 1] += 90
    groups.append((ERLE_SCENES[7:9], fs, far, near, None, er._run_ours(
        fs, far, near, ms, np.array([1, 1], np.int32),
        np.array([3, 3], np.int32))))
    far1, near1 = er._scene(fs, n_s, delay_ms=32.0, echo_gain=0.42,
                            seed=300)
    rng = np.random.default_rng(301)
    clean1 = (0.92 * near1.astype(np.float64)
              + rng.normal(0, 40, near1.shape)).clip(-32000, 32000)
    clean = clean1.astype(np.int16)[None]
    groups.append((ERLE_SCENES[9:], fs, far1[None], near1[None], clean,
                   er._run_ours(fs, far1[None], near1[None], 40,
                                np.array([1]), np.array([3]), clean=clean)))
    for names, fs, far, near, clean, out in groups:
        for b, name in enumerate(names):
            p = f"erle.{name}"
            arrays[f"{p}.sha_out"] = np.asarray(sha(out[b]))
            arrays[f"{p}.erle"] = np.float64(erle_db(
                near[b], out[b], far[b], skip_samples=int(fs * 2.0)))
            arrays[f"{p}.sha_far"] = np.asarray(sha(far[b]))
            arrays[f"{p}.sha_near"] = np.asarray(sha(near[b]))
            if clean is not None:
                arrays[f"{p}.sha_clean"] = np.asarray(sha(clean[b]))
            print(f"erle {name}: {float(arrays[f'{p}.erle']):.3f} dB",
                  flush=True)
    print(f"erle ({time.perf_counter() - t_all:.0f} s)", flush=True)

    # (d) the long call with delay drift
    pipe = AecmPipeline(2, LONG_FS)
    seg_sha = []
    for far, near, ms in long_segments():
        out = np.asarray(pipe.run(far, near, ms_in_sndcard_buf=ms))
        seg_sha.append(sha(out))
    arrays["long.seg_sha"] = np.asarray(seg_sha)
    for p, leaf in leaves_with_path(jax.tree_util.tree_map(
            np.asarray, pipe._canonical())):
        arrays[f"long.state.{p}"] = leaf
    print(f"long ({time.perf_counter() - t_all:.0f} s)", flush=True)

    # (e) frames_step on the port's serving path's inputs
    core_def = jax.tree_util.tree_structure(
        jf.create_fused(FRAMES_B, FRAMES_FS).core)
    run = jax.jit(lambda core, t, far, noisy, phase, rows, head: jf.
                  frames_step(core, t, far, noisy, None, phase, rows, mult=2,
                              n_frames=4, has_clean=False, abs_approx=False,
                              frames_per_chunk=2, far_head=head))
    tables = jf.make_tables()
    for name, (core, far, noisy, phase, rows, head) in frames_cases().items():
        leaves = [jnp.asarray(x.numpy().astype(np.uint32)
                              if p in ("seed", "de_farend.binary_history",
                                       "de_near.binary_history")
                              else x.numpy())
                  for p, x in leaves_with_path(core)]
        res = run(jax.tree_util.tree_unflatten(core_def, leaves), tables,
                  jnp.asarray(far.numpy()), jnp.asarray(noisy.numpy()),
                  jnp.asarray(phase.numpy()), jnp.asarray(rows.numpy()),
                  jnp.full((1, FRAMES_B), head, jnp.int32))
        core_j = jax.tree_util.tree_unflatten(
            core_def, [np.asarray(x) for x in jax.tree_util.tree_leaves(
                res[0])])
        p = f"frames.{name}"
        arrays[f"{p}.in_sha"] = np.asarray(frames_input_digest(
            core, far, noisy, phase, rows, head))
        outs = frames_outputs(core_j, *[np.asarray(r) for r in res[1:]])
        arrays[f"{p}.sha"] = np.asarray([digest(x) for _, x in outs])
        arrays["frames.names"] = np.asarray([k for k, _ in outs])
    print(f"frames ({time.perf_counter() - t_all:.0f} s)", flush=True)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: {len(arrays)} arrays, {os.path.getsize(OUT)} bytes "
          f"in {time.perf_counter() - t_all:.0f} s")


if __name__ == "__main__":
    main()
