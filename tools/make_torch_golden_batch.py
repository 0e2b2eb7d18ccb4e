"""Write the golden file of the batch-major engine for the PyTorch port.

The port (webrtc_aecm_tpu_torch) runs on a machine without JAX, so the JAX
package's answer travels as data.  This tool runs the JAX package's
batch-major engine (`parallel.batch.run_streams`, on the CPU) on the desync
scene of tools/make_torch_golden.py -- 8 streams, 40 chunks of 10 ms,
per-(chunk, stream) sound-card delays with a burst at chunk 24, every
fourth stream held in startup while its jitter-ring writes clamp -- in four
configurations:

    16k         16 kHz, single near input
    16k_clean   16 kHz, with a clean near input
    8k          8 kHz, single near input
    8k_clean    8 kHz, with a clean near input

and writes tests/data/torch_golden_batch.npz (compressed) holding, under
`<config>.`: the inputs `far`, `near`, `clean` (int16, (8, 40 * chunk)) and
`ms` ((40, 8) int32), the output `out` (int16), and every leaf of the final
state under `state.<dotted field path>` in the JAX package's dtypes.
tests/test_torch_batch.py and chip_smoke.py hold the port to it.

Regenerate after a change to the JAX package's batch-major path or to the
scene:

    JAX_PLATFORMS=cpu python tools/make_torch_golden_batch.py
"""
from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_golden_batch.npz")
CONFIGS = {"16k": (16000, False), "16k_clean": (16000, True),
           "8k": (8000, False), "8k_clean": (8000, True)}


def scene(sample_rate: int, has_clean: bool):
    """(far, near, clean or None, ms): make_torch_golden's desync scene at
    `sample_rate`, and a seeded clean near input (a weak echo residue plus
    noise) when asked."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_torch_golden import desync_scene
    far, near, ms = desync_scene(fs=sample_rate)
    clean = None
    if has_clean:
        rng = np.random.default_rng(1)
        clean = (0.05 * far + rng.normal(0, 300, far.shape)
                 ).clip(-32000, 32000).astype(np.int16)
    return far, near, clean, ms


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
    from webrtc_aecm_tpu.parallel import batch

    arrays = {}
    for name, (fs, has_clean) in CONFIGS.items():
        far, near, clean, ms = scene(fs, has_clean)
        i32 = lambda x: jnp.asarray(x, jnp.int32)  # noqa: E731
        run = jax.jit(lambda s, f, d, m, c: batch.run_streams(
            s, f, d, fs, m, clean=c))
        fin, out = run(batch.create_batch(far.shape[0], fs), i32(far),
                       i32(near), jnp.asarray(ms),
                       None if clean is None else i32(clean))
        out = np.asarray(out)
        arrays.update({f"{name}.far": far, f"{name}.near": near,
                       f"{name}.ms": ms,
                       f"{name}.out": out.astype(np.int16)})
        assert np.array_equal(arrays[f"{name}.out"], out)
        if clean is not None:
            arrays[f"{name}.clean"] = clean
        for path, leaf in leaves_with_path(
                jax.tree_util.tree_map(np.asarray, fin)):
            arrays[f"{name}.state.{path}"] = leaf
        print(f"{name}: {out.shape[0]} streams x {out.shape[1]} samples")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(arrays)} arrays, "
          f"{os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
