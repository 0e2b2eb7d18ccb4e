"""Write the golden file of the reconfigured delay estimator, wide steps
and the single-stream functional API.

The PyTorch port (webrtc_aecm_tpu_torch) runs on a machine without JAX, so
the JAX package's answers travel as data.  This tool runs the JAX package on
the CPU (pure paths, `use_kernel=False`) and writes

    tests/data/torch_golden_reconfig.npz   (compressed)

with the JAX answers, one group of keys per entry (the inputs are rebuilt
from the scene parameters below, seeded with numpy):

* `de.<name>.*`: the delay estimator's reconfiguration surface on one
  estimator (the six scenarios of tests/test_de_reconfig.py, replayed as
  the op lists of DE below): `delays` (one per block), `rets` (what each
  setter and query returned, in op order) and the final `near.<field>` /
  `farend.<field>`;
* `float.*`: the float path (`add_far_spectrum_float`, `process_float`) on
  the stream of tests/test_delay_estimator.py's float test: `delays` and
  the final states;
* `rsf.<name>.*`: `fused.run_streams_fused` at 4 streams on a state whose
  delay estimator is resized (`set_history_size`) or rebuilt with
  lookahead capacity 4 and per-stream lookahead 0..3 (the mutation of
  tests/test_fused.py), and at wide steps (`chunks_per_step` 3 to 10, each
  with a tail): `out` and every leaf of the final state.  Before an entry
  is stored the tool checks that `parallel.batch.run_streams` gives the
  same output and state on the same start; it stops if they differ.  The
  entries of BATCH_ONLY hold the batch-major engine's answer alone, in the
  fused layout: the JAX fused engine's compile at 10 chunks a step (25
  block slots unrolled) took more than 35 GB and 30 minutes on the CPU;
* `fn.<fs>.*`: the single-stream functional sequence `api.create` ->
  `set_config` -> `init_echo_path` -> per chunk `buffer_farend` and
  `process`, at 8 and 16 kHz: `out` (chunks, n), `warn`, `echo_path` and
  the final state.

tests/test_torch_de_reconfig.py, tests/test_torch_envelope.py and
tests/test_torch_api.py hold the port's plain paths to it; chip_smoke.py
holds the kernel path to the `rsf` entries on the card.  Regenerate after a
change to the JAX package or to a scene (about an hour of JAX compiles; the
wide steps' compiles take several GB of memory each):

    JAX_PLATFORMS=cpu python tools/make_torch_golden_reconfig.py
"""
from __future__ import annotations

import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_golden_reconfig.npz")
B = 4

# name: (seed, blocks, echo delay in blocks, history size, max lookahead,
# robust validation, ops); an op is ("run", n blocks) or a setter / query
# with its argument: the scenarios of tests/test_de_reconfig.py
DE = {
    "lookahead_1": (30, 300, 12, 100, 1, False, [("lookahead", None),
                                                 ("run", 300)]),
    "lookahead_4": (36, 300, 12, 100, 4, False, [("lookahead", None),
                                                 ("run", 300)]),
    "lookahead_7": (37, 300, 12, 100, 7, False, [("lookahead", None),
                                                 ("run", 300)]),
    "set_lookahead": (31, 400, 20, 100, 6, False, [
        ("set_lookahead", 7), ("set_lookahead", -1), ("lookahead", None),
        ("run", 200), ("set_lookahead", 2), ("lookahead", None),
        ("run", 200)]),
    "allowed_offset": (32, 400, 25, 100, 0, True, [
        ("set_allowed_offset", -1), ("get_allowed_offset", None),
        ("set_allowed_offset", 3), ("get_allowed_offset", None),
        ("run", 400)]),
    "robust_toggle": (33, 450, 15, 100, 0, False, [
        ("is_robust_validation_enabled", None), ("run", 150),
        ("enable_robust_validation", 1),
        ("is_robust_validation_enabled", None), ("run", 150),
        ("enable_robust_validation", 2),
        ("is_robust_validation_enabled", None),
        ("enable_robust_validation", 0), ("run", 150)]),
    "soft_reset": (34, 500, 18, 100, 4, False, [
        ("run", 250), ("soft_reset", 3), ("soft_reset", -2),
        ("soft_reset", 10), ("lookahead", None), ("run", 250)]),
    "history_size": (35, 600, 8, 100, 0, False, [
        ("history_size", None), ("run", 200), ("set_history_size", 60),
        ("history_size", None), ("run", 200), ("set_history_size", 90),
        ("history_size", None), ("run", 200)]),
}
FLOAT = dict(seed=7, blocks=240, delay=11)

# name: (sample rate, chunks, delay burst at, seed, clean input, history
# size, lookahead capacity (> 1: per-stream lookahead b mod capacity),
# chunks per step or None for the default)
RSF = {
    "16k_la4": (16000, 37, 24, 11, False, 100, 4, None),
    "16k_cps1_la4": (16000, 37, 24, 22, False, 100, 4, 1),
    "16k_h37": (16000, 37, 24, 12, False, 37, 1, None),
    "8k_h64": (8000, 37, 24, 13, False, 64, 1, None),
    "16k_h128_clean": (16000, 37, 24, 14, True, 128, 1, None),
    "16k_h257_la4": (16000, 37, 24, 15, False, 257, 4, None),
    "16k_cps3": (16000, 37, 24, 16, False, 100, 1, 3),
    "16k_cps4": (16000, 37, 24, 17, False, 100, 1, 4),
    "16k_cps10": (16000, 31, 24, 18, False, 100, 1, 10),
    "8k_cps5": (8000, 37, 24, 19, False, 100, 1, 5),
    "8k_cps8": (8000, 37, 24, 20, False, 100, 1, 8),
    "8k_cps5_h257_la4": (8000, 37, 24, 21, False, 257, 4, 5),
}
BATCH_ONLY = ("16k_cps10",)
# sample rate: (chunks, seed, echo mode, echo path seed)
FN = {8000: (30, 41, 4, 42), 16000: (30, 43, 2, 44)}


def make_spectra(rng, n_blocks, delay_blocks):
    """tests/test_delay_estimator.py `_make_spectra`: a far spectra stream
    and a near stream = far delayed by delay_blocks (uint16 range)."""
    far = rng.integers(0, 4000, size=(n_blocks + delay_blocks, 65)).astype(
        np.uint16)
    return far[delay_blocks:delay_blocks + n_blocks], far[:n_blocks]


def de_spectra(name):
    seed, n_blocks, delay = DE[name][:3]
    return make_spectra(np.random.default_rng(seed), n_blocks, delay)


def float_spectra():
    far, near = make_spectra(np.random.default_rng(FLOAT["seed"]),
                             FLOAT["blocks"], FLOAT["delay"])
    return far.astype(np.float32), near.astype(np.float32)


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
    clean = None
    if with_clean:
        clean = (0.35 * far + rng.normal(0, 120, far.shape)
                 ).clip(-32000, 32000).astype(np.int16)
    return far, near, clean


def desync_ms(n_chunks, n_streams, burst_at):
    """tests/test_fused.py `_desync_ms`: per-(chunk, stream) sound-card
    delays that desynchronise startup and clamp some jitter-ring writes."""
    ms = np.full((n_chunks, n_streams), 40, np.int32)
    ms += 15 * (np.arange(n_streams, dtype=np.int32) % 5)[None, :]
    ms[burst_at:burst_at + 6] += 80
    ms[:min(20, n_chunks)] += 23 * (np.arange(n_streams, dtype=np.int32)
                                    % 7)[None, :]
    return ms


def fn_inputs(fs):
    """The functional sequence's far / near signals (one stream), its
    per-chunk sound-card delays (two of them out of range: warnings) and
    its echo path."""
    n_chunks, seed, _, ep_seed = FN[fs]
    far, near, _ = scene(fs, 1, n_chunks, seed)
    ms = desync_ms(n_chunks, 1, n_chunks // 2)[:, 0].copy()
    ms[3], ms[7] = -5, 520
    ep = np.random.default_rng(ep_seed).integers(0, 4000, 65).astype(
        np.int32)
    return far[0], near[0], ms, ep


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
    from webrtc_aecm_tpu import api, delay_estimator as de, fused
    from webrtc_aecm_tpu.parallel import batch as pbatch

    arrays = {}

    def put_tree(prefix, tree):
        for path, leaf in leaves_with_path(jax.tree_util.tree_map(
                np.asarray, tree)):
            arrays[f"{prefix}.{path}"] = leaf

    def run_fix(farend, near, far_s, near_s):
        @jax.jit
        def step(carry, inputs):
            fe, ne = carry
            f, n = inputs
            fe = de.add_far_spectrum_fix(fe, f, jnp.int32(8))
            ne, delay = de.process_fix(ne, fe, n, jnp.int32(8))
            return (fe, ne), delay
        (farend, near), delays = jax.lax.scan(
            step, (farend, near), (jnp.asarray(far_s.astype(np.int32)),
                                   jnp.asarray(near_s.astype(np.int32))))
        return farend, near, list(np.asarray(delays))

    for name, (seed, n_blocks, delay, hist, la, robust, ops) in DE.items():
        far_s, near_s = de_spectra(name)
        farend = de.create_farend(hist)
        near = de.create_near(hist, max_lookahead=la,
                              robust_validation=robust)
        delays, rets, at = [], [], 0
        for op, arg in ops:
            if op == "run":
                farend, near, d = run_fix(farend, near, far_s[at:at + arg],
                                          near_s[at:at + arg])
                delays += d
                at += arg
            elif op == "soft_reset":
                near, applied = de.soft_reset_near(near, arg)
                farend = de.soft_reset_farend(farend, arg)
                rets.append(int(applied))
            elif op == "set_history_size":
                near, farend = de.set_history_size(near, farend, arg)
                rets.append(arg)
            elif op == "history_size":
                rets.append(de.history_size(near, farend))
            elif arg is None:
                rets.append(int(getattr(de, op)(near)))
            else:
                near, ret = getattr(de, op)(near, arg)
                rets.append(int(ret))
        assert at == n_blocks, name
        p = f"de.{name}"
        arrays[f"{p}.delays"] = np.asarray(delays, np.int32)
        arrays[f"{p}.rets"] = np.asarray(rets, np.int32)
        put_tree(f"{p}.near", near)
        put_tree(f"{p}.farend", farend)
        print(f"de {name}", flush=True)

    far_f, near_f = float_spectra()

    @jax.jit
    def float_step(carry, inputs):
        fe, ne = carry
        f, n = inputs
        fe = de.add_far_spectrum_float(fe, f)
        ne, delay = de.process_float(ne, fe, n)
        return (fe, ne), delay
    (farend, near), delays = jax.lax.scan(
        float_step, (de.create_farend(float_spectrum=True),
                     de.create_near(float_spectrum=True)),
        (jnp.asarray(far_f), jnp.asarray(near_f)))
    arrays["float.delays"] = np.asarray(delays)
    put_tree("float.near", near)
    put_tree("float.farend", farend)
    print("float", flush=True)

    def start(fs, hist, cap):
        st = pbatch.create_batch(B, fs)
        core = st.core
        dn, df = core.de_near, core.de_farend
        if hist != 100:
            dn, df = de.set_history_size(dn, df, hist)
        if cap > 1:
            dn = dn._replace(binary_history=jnp.zeros((B, cap), jnp.uint32),
                             lookahead=jnp.arange(B, dtype=jnp.int32) % cap)
        return st._replace(core=core._replace(de_near=dn, de_farend=df))

    for name, (fs, n_chunks, burst, seed, with_clean, hist, cap, cps) in \
            RSF.items():
        far, near, clean = scene(fs, B, n_chunks, seed, with_clean)
        ms = jnp.asarray(desync_ms(n_chunks, B, burst))
        args = (jnp.asarray(far, jnp.int32), jnp.asarray(near, jnp.int32),
                None if clean is None else jnp.asarray(clean, jnp.int32))
        ref_state, ref_out = jax.jit(lambda s, f, d, c, fs=fs:
                                     pbatch.run_streams(s, f, d, fs, ms,
                                                        clean=c))(
            start(fs, hist, cap), *args)
        if name in BATCH_ONLY:
            fin, out = fused.to_fused_state(ref_state), ref_out
        else:
            fin, out = jax.jit(lambda s, f, d, c, fs=fs, cps=cps:
                               fused.run_streams_fused(
                                   s, f, d, fs, ms, use_kernel=False,
                                   clean=c, chunks_per_step=cps))(
                fused.to_fused_state(start(fs, hist, cap)), *args)
        if not np.array_equal(np.asarray(out), np.asarray(ref_out)):
            raise SystemExit(f"rsf {name}: the JAX fused engine's output "
                             "differs from the batch-major engine's")
        for (path, a), (_, b) in zip(
                leaves_with_path(fused.from_fused_state(fin)),
                leaves_with_path(ref_state)):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise SystemExit(f"rsf {name}: the JAX fused engine's state "
                                 f"leaf {path} differs from the batch-major "
                                 "engine's")
        arrays[f"rsf.{name}.out"] = np.asarray(out).astype(np.int16)
        put_tree(f"rsf.{name}.state", fin)
        print(f"rsf {name}", flush=True)

    for fs, (n_chunks, seed, echo_mode, _) in FN.items():
        far, near, ms, ep = fn_inputs(fs)
        n, mult = min(160, fs // 100), fs // 8000
        bf = jax.jit(api.buffer_farend, static_argnums=2)
        proc = jax.jit(api.process, static_argnums=(3, 5))
        s = api.create(fs)
        s = api.set_config(s, 1, echo_mode)
        s = api.init_echo_path(s, jnp.asarray(ep))
        outs, warns = [], []
        for c in range(n_chunks):
            cols = slice(c * n, (c + 1) * n)
            s = bf(s, jnp.asarray(far[cols], jnp.int32), mult)
            s, out, warn = proc(s, jnp.asarray(near[cols], jnp.int32), None,
                                n, jnp.int32(ms[c]), fs)
            outs.append(np.asarray(out))
            warns.append(int(warn))
        p = f"fn.{fs}"
        arrays[f"{p}.out"] = np.stack(outs).astype(np.int16)
        arrays[f"{p}.warn"] = np.asarray(warns, np.int32)
        arrays[f"{p}.echo_path"] = np.asarray(api.get_echo_path(s))
        put_tree(f"{p}.state", s)
        print(f"fn {fs}", flush=True)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: {len(arrays)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
