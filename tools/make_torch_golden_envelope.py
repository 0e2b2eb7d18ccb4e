"""Write the golden file of the fused envelope and the public entry points.

The PyTorch port (webrtc_aecm_tpu_torch) runs on a machine without JAX, so
the JAX package's answers travel as data.  This tool runs the JAX package on
the CPU (pure paths, `use_kernel=False`) and writes

    tests/data/torch_golden_envelope.npz   (compressed)

with the scene parameters (seeds, sizes, sound-card delays are rebuilt from
them by `scene` / `desync_ms` below, the scene of tests/test_fused.py) and
the JAX answers, one group of keys per entry:

* `rsf.<name>.*`: `fused.run_streams_fused` at 8 streams: 8 kHz with 37
  chunks (9 steps of 4 and a 1-chunk tail), 8 kHz with a clean input, 16 kHz
  with a clean input and 37 chunks (a 1-chunk tail), 8 kHz with per-stream
  cng/echo modes, bench.py's 16 kHz scene; `out` and every leaf of the
  final state under `state.<dotted field path>`;
* `step.<name>.*`: `fused.make_fused_chunk_step` at one chunk per step
  (the 10 ms real-time step, newest-first far history, batch-leading
  input): 20 chunks at 8 and at 16 kHz, and 30 chunks at 8 kHz with
  per-stream modes and `abs_approx`; `out`, `warn` and the final state;
* `frames.<name>.*`: single `fused.frames_step` calls in the newest-first
  mode at 2, 3 and 4 block slots (with a clean input, with `abs_approx`),
  and one in the circular mode with a clean input, on the final state of
  an `rsf` entry (`core_from`): the inputs (`far`, `noisy`, `clean`,
  `phase`, `run_rows`, `head`) and the outputs (`out`, `pend_hist`,
  `pend_q`, `state.<path>` of the core);
* `api.<name>.*`: `api.AecmInstance.run_file_pair` at 8 kHz (robust
  validation, `init_echo_path`) and 16 kHz (`set_control` with a fixed
  delay and the NLP off): `out`, `echo_path`, `delay_quality`;
* `ckpt.*`: an `AecmPipeline.save` checkpoint (4 streams, 16 kHz, after a
  20-chunk run) under `ckpt.file.<key>`, and the pipeline's next `run`
  output (10 chunks) under `ckpt.next_out`.

tests/test_torch_envelope.py, tests/test_torch_api.py and
tests/test_torch_pipeline.py hold the port's plain paths to it;
chip_smoke.py holds the kernel path to it on the card.  Regenerate after a
change to the JAX package or to a scene (a few minutes of JAX compiles):

    JAX_PLATFORMS=cpu python tools/make_torch_golden_envelope.py
"""
from __future__ import annotations

import io
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_golden_envelope.npz")
B = 8

# name: (sample rate, chunks, delay burst at, seed, clean input, per-stream
# cng/echo modes)
RSF = {
    "8k": (8000, 37, 24, 0, False, False),
    "8k_clean": (8000, 37, 24, 3, True, False),
    "16k_clean": (16000, 37, 24, 3, True, False),
    "8k_config": (8000, 30, 18, 7, False, True),
}
# name: (sample rate, chunks, burst at, seed, per-stream modes, abs_approx)
STEP = {
    "8k": (8000, 20, 12, 0, False, False),
    "16k": (16000, 20, 12, 0, False, False),
    "8k_config_abs": (8000, 30, 18, 7, True, True),
}
# name: (rsf entry whose final state is the input core, frames, clean
# input, abs_approx, circular head or -1 for the newest-first history,
# seed)
FRAMES = {
    "2slot": ("8k", 1, False, False, -1, 21),
    "3slot_clean": ("8k_clean", 2, True, False, -1, 22),
    "4slot_abs": ("8k", 3, False, True, -1, 23),
    "16k_3slot_clean_abs": ("16k_clean", 2, True, True, -1, 24),
    "16k_5slot_clean_circular": ("16k_clean", 4, True, False, 93, 25),
}
# name: (sample rate, chunks, seed, robust validation, fixed delay (-1:
# the estimator), nlp flag, echo path seed or -1)
API = {
    "8k": (8000, 40, 31, True, -1, 1, 32),
    "16k": (16000, 40, 33, False, 5, 0, -1),
}
CKPT = dict(fs=16000, n_streams=4, n_first=20, n_next=10, seed=9)
BENCH = dict(fs=16000, n_chunks=40)


def scene(fs, n_streams, n_chunks, seed=0, with_clean=False):
    """tests/test_fused.py `_scene`: modulated far-end noise offset by 40
    samples per stream; near = 0.4 far + noise; clean = 0.35 far + noise."""
    chunk = min(160, fs // 100)
    n = n_chunks * chunk
    rng = np.random.default_rng(seed)
    t = np.arange(n + 640)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
    ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far = np.stack([ff[640 - 40 * b:640 - 40 * b + n]
                    for b in range(n_streams)]).astype(np.int16)
    near = (0.4 * far + rng.normal(0, 150, far.shape)
            ).clip(-32000, 32000).astype(np.int16)
    if with_clean:
        clean = (0.35 * far + rng.normal(0, 120, far.shape)
                 ).clip(-32000, 32000).astype(np.int16)
        return far, near, clean
    return far, near, None


def desync_ms(n_chunks, n_streams, burst_at):
    """tests/test_fused.py `_desync_ms`: per-(chunk, stream) sound-card
    delays that desynchronise startup and clamp some jitter-ring writes."""
    ms = np.full((n_chunks, n_streams), 40, np.int32)
    ms += 15 * (np.arange(n_streams, dtype=np.int32) % 5)[None, :]
    ms[burst_at:burst_at + 6] += 80
    ms[:min(20, n_chunks)] += 23 * (np.arange(n_streams, dtype=np.int32)
                                    % 7)[None, :]
    return ms


def stream_modes(n_streams):
    """Per-stream (cng_mode, echo_mode) of the `config` entries."""
    i = np.arange(n_streams, dtype=np.int32)
    return i % 2, i % 5


def bench_scene(n_streams, n_chunks, fs=16000):
    """bench.py's scene: one modulated far signal and its attenuated echo
    plus noise, the same for every stream (ms = 40)."""
    n = n_chunks * 160
    rng = np.random.default_rng(0)
    t = np.arange(n + 160)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
    far_full = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far1 = far_full[160:].astype(np.int16)
    near1 = (0.4 * far_full[:n] + rng.normal(0, 200, n)
             ).clip(-32000, 32000).astype(np.int16)
    return np.repeat(far1[None], n_streams, 0), np.repeat(near1[None],
                                                          n_streams, 0)


def frames_inputs(fs, n_frames, has_clean, seed, n_streams=B):
    """The sample inputs and run rows of a `frames` entry: int16 noise, and
    per stream k = b mod (chunks + 1) of the step's chunks running (the
    last k: a stream that starts mid-step)."""
    rng = np.random.default_rng(seed)
    fpc = min(160, fs // 100) // 80
    rows = n_frames * 80
    far = rng.integers(-20000, 20000, (rows, n_streams)).astype(np.int32)
    noisy = (0.4 * far + rng.normal(0, 200, far.shape)).astype(np.int32)
    clean = ((0.3 * far + rng.normal(0, 150, far.shape)).astype(np.int32)
             if has_clean else None)
    n_chunks = n_frames // fpc
    k = np.arange(n_streams) % (n_chunks + 1)
    chunk_of = np.arange(n_frames) // fpc
    run_rows = chunk_of[:, None] >= (n_chunks - k)[None, :]
    return far, noisy, clean, run_rows


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
    from webrtc_aecm_tpu import api, fused
    from webrtc_aecm_tpu.models import AecmPipeline
    from webrtc_aecm_tpu.parallel import batch as pbatch

    arrays = {}

    def put_state(prefix, state):
        for path, leaf in leaves_with_path(jax.tree_util.tree_map(
                np.asarray, state)):
            arrays[f"{prefix}.state.{path}"] = leaf

    def fused_start(fs, config):
        st = pbatch.create_batch(B, fs)
        if config:
            st = pbatch.set_config_batch(st, *stream_modes(B))
        return fused.to_fused_state(st)

    finals = {}
    for name, (fs, n_chunks, burst, seed, with_clean, config) in RSF.items():
        far, near, clean = scene(fs, B, n_chunks, seed, with_clean)
        ms = desync_ms(n_chunks, B, burst) if not config else np.int32(40)
        run = jax.jit(lambda s, f, d, c, m, fs=fs: fused.run_streams_fused(
            s, f, d, fs, m, use_kernel=False, clean=c))
        fin, out = run(fused_start(fs, config), jnp.asarray(far, jnp.int32),
                       jnp.asarray(near, jnp.int32),
                       None if clean is None else jnp.asarray(clean,
                                                              jnp.int32),
                       jnp.asarray(ms))
        finals[name] = fin
        arrays[f"rsf.{name}.out"] = np.asarray(out).astype(np.int16)
        put_state(f"rsf.{name}", fin)
        print(f"rsf {name}", flush=True)

    far, near = bench_scene(B, BENCH["n_chunks"])
    fin, out = jax.jit(lambda s, f, d: fused.run_streams_fused(
        s, f, d, BENCH["fs"], 40, use_kernel=False))(
        fused.create_fused(B, BENCH["fs"]), jnp.asarray(far, jnp.int32),
        jnp.asarray(near, jnp.int32))
    arrays["rsf.bench16k.out"] = np.asarray(out).astype(np.int16)
    put_state("rsf.bench16k", fin)
    print("rsf bench16k", flush=True)

    for name, (fs, n_chunks, burst, seed, config, absa) in STEP.items():
        chunk = min(160, fs // 100)
        far, near, _ = scene(fs, B, n_chunks, seed)
        ms = (desync_ms(n_chunks, B, burst) if not config
              else np.full((n_chunks, B), 40, np.int32))
        step = jax.jit(fused.make_fused_chunk_step(
            fs, use_kernel=False, abs_approx=absa))
        st, outs, warns = fused_start(fs, config), [], []
        for c in range(n_chunks):
            cols = slice(c * chunk, (c + 1) * chunk)
            st, out, warn = step(st, jnp.asarray(far[:, cols], jnp.int32),
                                 jnp.asarray(near[:, cols], jnp.int32),
                                 jnp.asarray(ms[c]))
            outs.append(np.asarray(out))
            warns.append(np.asarray(warn))
        arrays[f"step.{name}.out"] = np.concatenate(outs, 1).astype(np.int16)
        arrays[f"step.{name}.warn"] = np.stack(warns).astype(np.int32)
        put_state(f"step.{name}", st)
        print(f"step {name}", flush=True)

    t = fused.make_tables()
    for name, (src, n_frames, has_clean, absa, head, seed) in FRAMES.items():
        fs = RSF[src][0]
        mult, fpc = fs // 8000, min(160, fs // 100) // 80
        core = finals[src].core
        if head >= 0:
            # the same history in the circular order at `head`
            core = fused._to_circular_far(core)
            b = core.far_history.shape[-1]
            h3 = core.far_history.reshape(100, 40, b)
            core = core._replace(
                far_history=jnp.roll(h3, head, axis=0).reshape(-1, b),
                far_q_domains=jnp.roll(core.far_q_domains, head, axis=0))
        far, noisy, clean, run_rows = frames_inputs(fs, n_frames, has_clean,
                                                    seed)
        run_rows = jnp.asarray(run_rows)
        phase, new_seed = fused._precompute_cng_phases(core, run_rows,
                                                       n_frames)
        core = core._replace(seed=new_seed)
        res = jax.jit(lambda c, f, d, cl, p, r, h, n_frames=n_frames,
                      has_clean=has_clean, absa=absa, mult=mult, fpc=fpc:
                      fused.frames_step(c, t, f, d, cl, p, r, mult, n_frames,
                                        has_clean, absa, fpc, far_head=h))(
            core, jnp.asarray(far), jnp.asarray(noisy),
            None if clean is None else jnp.asarray(clean), phase, run_rows,
            None if head < 0 else jnp.full((1, B), head, jnp.int32))
        p = f"frames.{name}"
        arrays.update({f"{p}.far": far, f"{p}.noisy": noisy,
                       f"{p}.phase": np.asarray(phase),
                       f"{p}.run_rows": np.asarray(run_rows),
                       f"{p}.seed_in": np.asarray(new_seed),
                       f"{p}.head": np.int32(head),
                       f"{p}.out": np.asarray(res[1])})
        if clean is not None:
            arrays[f"{p}.clean"] = clean
        if head >= 0:
            arrays[f"{p}.pend_hist"] = np.asarray(res[2])
            arrays[f"{p}.pend_q"] = np.asarray(res[3])
        for path, leaf in leaves_with_path(jax.tree_util.tree_map(
                np.asarray, res[0])):
            arrays[f"{p}.state.{path}"] = leaf
        print(f"frames {name}", flush=True)

    for name, (fs, n_chunks, seed, robust, delay, nlp, ep_seed) in \
            API.items():
        far, near, _ = scene(fs, 1, n_chunks, seed)
        inst = api.AecmInstance(fs, robust_validation=robust)
        if ep_seed >= 0:
            ep = np.random.default_rng(ep_seed).integers(0, 4000, 65)
            inst.init_echo_path(ep.astype(np.int16))
        inst.set_control(delay, nlp)
        out = inst.run_file_pair(far[0], near[0], 40)
        p = f"api.{name}"
        arrays.update({f"{p}.out": out, f"{p}.echo_path":
                       inst.get_echo_path(), f"{p}.delay_quality":
                       np.float32(inst.delay_quality())})
        print(f"api {name}", flush=True)

    c = CKPT
    chunk = c["fs"] // 100
    far, near, _ = scene(c["fs"], c["n_streams"], c["n_first"] + c["n_next"],
                         c["seed"])
    pipe = AecmPipeline(c["n_streams"], c["fs"], engine="xla")
    pipe.run(far[:, :c["n_first"] * chunk], near[:, :c["n_first"] * chunk])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        pipe.save(path)
        with np.load(path) as ck:
            for k in ck.files:
                arrays[f"ckpt.file.{k}"] = ck[k]
    arrays["ckpt.next_out"] = np.asarray(pipe.run(
        far[:, c["n_first"] * chunk:], near[:, c["n_first"] * chunk:])
    ).astype(np.int16)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: {len(arrays)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
