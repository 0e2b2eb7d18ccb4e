"""Write the golden file that carries the JAX package's answer to the GPU.

The PyTorch port (webrtc_aecm_tpu_torch) runs on a machine without JAX, so
its end-to-end reference travels as data: this tool runs the JAX package's
fused serving path (`fused.run_streams_fused`, pure path, on the CPU) on
the 16 kHz desync scene -- 8 streams, 40 chunks of 10 ms, per-(chunk,
stream) sound-card delays with a burst at chunk 24, every fourth stream
held in startup until its jitter-ring writes clamp -- and writes

    tests/data/torch_golden_16k.npz   (compressed)

holding the inputs `far`, `near` (int16, (8, 6400)), `ms` ((40, 8) int32),
the output `out` ((8, 6400)), and every leaf of the final fused state under
`state.<dotted field path>` (e.g. `state.core.de_near.histogram`) in the
JAX package's dtypes.  tests/test_torch_pipeline.py and chip_smoke.py hold
the port to it.

Regenerate after a change to the JAX package's fused path or to the scene:

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py
"""
from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_golden_16k.npz")
FS, B, N_CHUNKS, BURST_AT = 16000, 8, 40, 24


def desync_scene(fs=FS, n_streams=B, n_chunks=N_CHUNKS, burst_at=BURST_AT,
                 seed=0):
    """Modulated far-end noise, each stream's far signal offset by 40
    samples per stream; near = 0.4 far + noise.  Per-(chunk, stream)
    sound-card delays desynchronise the startup lengths across streams so
    jitter-ring writes clamp on some streams only, and a delay burst drives
    the buffer stuffing of DelayComp."""
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
    ms = np.full((n_chunks, n_streams), 40, np.int32)
    ms += 15 * (np.arange(n_streams, dtype=np.int32) % 5)[None, :]
    ms[burst_at:burst_at + 6] += 80
    ms[:min(20, n_chunks)] += 23 * (np.arange(n_streams, dtype=np.int32)
                                    % 7)[None, :]
    # every fourth stream reports a sound-card delay that alternates by
    # 120 ms for 40 chunks: it stays in startup while its jitter ring fills,
    # so its writes clamp while the other streams' do not
    unstable = np.arange(n_streams) % 4 == 3
    n_alt = min(40, n_chunks)
    ms[:n_alt, unstable] += 120 * (np.arange(n_alt) % 2)[:, None]
    return far, near, ms


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
    from webrtc_aecm_tpu import fused

    far, near, ms = desync_scene()
    state = fused.create_fused(B, FS)
    fin, out = jax.jit(lambda s, f, d: fused.run_streams_fused(
        s, f, d, FS, jnp.asarray(ms), use_kernel=False))(
        state, jnp.asarray(far, jnp.int32), jnp.asarray(near, jnp.int32))
    arrays = {"far": far, "near": near, "ms": ms,
              "out": np.asarray(out).astype(np.int16)}
    assert np.array_equal(arrays["out"], np.asarray(out))
    for path, leaf in leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                              fin)):
        arrays["state." + path] = leaf
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(arrays)} arrays, "
          f"{os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
