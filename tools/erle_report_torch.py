"""ERLE battery of the PyTorch port, held to the JAX package.

Runs tools/erle_report.py's 10 scenes (the 8 kHz demo path and echoMode
0-4 and CNG off, 16 kHz default, variable sound-card delay and a clean
input; 6 s each) through the port's AecmPipeline, on the CUDA card unless
`--device cpu`, grouped as that tool groups them (one batch per rate and
input kind, per-stream cng/echo modes, the variable-delay scene's per-chunk
delays).  The scenes come from this file's own copy of that tool's scene
generator.  Every output is compared with the JAX package's in
tests/data/torch_golden_surface.npz (`erle.*`, from
tools/make_torch_golden_surface.py): the SHA-256 of its int16 samples, and
the generator's hashes of far and near.  The JAX package stands in for the
C reference that tools/erle_report.py runs; its bit-exactness with C rests
on ERLE.json.

Writes ERLE_TORCH.json at the repository root: per scene the ERLE (dB,
after a 2 s skip, the JAX tool's measure) and whether the output is
bit-exact with the JAX package's; the commit (`git rev-parse HEAD`) and
whether the tree was dirty, or, in a copy without git, the id given with
`--commit`; `sources_sha`, a SHA-256 over the files the run depends on
(the port's package, this tool, the golden file), which any checkout can
recompute; the device, and on a card its name and power limit from
nvidia-smi beside the wall time.  Exit code 1 if a scene or an output
differs.

    python tools/erle_report_torch.py [--device cpu] [--commit ID]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_surface.npz")
OUT = os.path.join(REPO, "ERLE_TORCH.json")
SECONDS = 6.0
SKIP_S = 2.0


def _scene(fs: int, n_s: float, delay_ms: float, echo_gain: float,
           seed: int, noise: float = 60.0):
    """Far = speech-shaped modulated noise; near = delayed echo + local
    noise (tools/erle_report.py's generator, copied).  Returns (far, near)
    int16."""
    rng = np.random.default_rng(seed)
    n = int(fs * n_s)
    d = int(fs * delay_ms / 1000.0)
    t = np.arange(n + d + fs)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
    env *= 0.3 + 0.7 * (np.sin(2 * np.pi * t / (2 * fs)) > 0)  # talk spurts
    ff = (env * rng.normal(0.0, 2800.0, t.shape)).clip(-30000, 30000)
    far = ff[d:d + n]
    near = (echo_gain * ff[:n] + rng.normal(0.0, noise, n)).clip(
        -32000, 32000)
    return far.astype(np.int16), near.astype(np.int16)


# name: (rate, echo delay ms, generator seed, cng, echo mode); the groups run
# as one batch each, in tools/erle_report.py's order
GROUPS = (
    ("8k", [("8k_demo_mode1", 8000, 64.0, 100, 1, 1)]
     + [(f"8k_mode{m}", 8000, 64.0, 101 + m, 1, m) for m in range(5)]
     + [("8k_cng_off", 8000, 64.0, 106, 0, 3)]),
    ("16k", [("16k_default", 16000, 32.0, 200, 1, 3),
             ("16k_variable_delay", 16000, 48.0, 201, 1, 3)]),
    ("16k_clean", [("16k_clean_input", 16000, 32.0, 300, 1, 3)]),
)
SCENES = {s[0]: (group, s[1:]) for group, scenes in GROUPS for s in scenes}


def build(name):
    """(far, near, clean or None, ms (n_chunks,)) of scene `name`."""
    group, (fs, delay_ms, seed, _, _) = SCENES[name]
    far, near = _scene(fs, SECONDS, delay_ms=delay_ms, echo_gain=0.42,
                       seed=seed)
    n_chunks = far.shape[0] // (fs // 100)
    ms = np.full(n_chunks, 40, np.int32)
    if name == "16k_variable_delay":
        ms += (25 * np.sin(np.arange(n_chunks) / 17.0)).astype(np.int32)
        ms[n_chunks // 2:n_chunks // 2 + 8] += 90     # delay burst
    clean = None
    if group == "16k_clean":
        rng = np.random.default_rng(seed + 1)
        clean = (0.92 * near.astype(np.float64)
                 + rng.normal(0, 40, near.shape)).clip(
                     -32000, 32000).astype(np.int16)
    return far, near, clean, ms


def sha(x) -> str:
    """SHA-256 of an int16 signal's bytes."""
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(x).astype("<i2")).tobytes()).hexdigest()


def run(names, device=None, engine="auto"):
    """The scenes `names` (all of one group) as one batch through the port's
    AecmPipeline.  Returns {name: (far, near, clean, out int16)}."""
    import torch
    from webrtc_aecm_tpu_torch.models import AecmPipeline
    groups = {SCENES[n][0] for n in names}
    if len(groups) != 1:
        raise ValueError(f"scenes of one group only, not {sorted(groups)}")
    fs = SCENES[names[0]][1][0]
    built = [build(n) for n in names]
    pipe = AecmPipeline(len(names), fs, engine=engine, device=device)
    pipe.set_config(np.array([SCENES[n][1][3] for n in names], np.int32),
                    np.array([SCENES[n][1][4] for n in names], np.int32))
    with torch.no_grad():
        out = pipe.run(np.stack([b[0] for b in built]),
                       np.stack([b[1] for b in built]),
                       None if built[0][2] is None
                       else np.stack([b[2] for b in built]),
                       np.stack([b[3] for b in built], axis=1))
    out = out.cpu().numpy().astype(np.int16)
    return {n: b[:3] + (out[i],) for i, (n, b) in enumerate(zip(names,
                                                                built))}


def check(name, far, near, clean, out, golden):
    """{erle_db, bit_exact, scene_matches} of one scene's result."""
    from webrtc_aecm_tpu_torch.utils import erle_db
    fs = SCENES[name][1][0]
    p = f"erle.{name}"
    scene_ok = (sha(far) == str(golden[f"{p}.sha_far"])
                and sha(near) == str(golden[f"{p}.sha_near"])
                and (clean is None
                     or sha(clean) == str(golden[f"{p}.sha_clean"])))
    return {"erle_db": erle_db(near, out, far,
                               skip_samples=int(fs * SKIP_S)),
            "erle_jax_db": float(golden[f"{p}.erle"]),
            "bit_exact": sha(out) == str(golden[f"{p}.sha_out"]),
            "scene_matches": bool(scene_ok)}


def _git(*args):
    """git's output, or None outside a git checkout."""
    try:
        r = subprocess.run(["git", *args], capture_output=True, text=True,
                           cwd=REPO, timeout=60)
    except FileNotFoundError:
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def sources_sha() -> str:
    """SHA-256 over the port's package files, this tool and the golden
    file, by path in sorted order."""
    paths = [os.path.join(d, f) for d, _, fs in os.walk(
        os.path.join(REPO, "webrtc_aecm_tpu_torch")) for f in fs
        if f.endswith((".py", ".cu", ".cuh"))]
    paths += [os.path.abspath(__file__), GOLDEN]
    h = hashlib.sha256()
    for path in sorted(paths):
        h.update(os.path.relpath(path, REPO).encode())
        with open(path, "rb") as f:
            h.update(hashlib.sha256(f.read()).digest())
    return h.hexdigest()


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--commit", default=None,
                   help="the commit or tree id to record where the copy "
                        "has no git")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    from webrtc_aecm_tpu_torch import _device
    device = _device.resolve(args.device)
    report = {"unit": "dB", "reference": "the JAX package "
              "(tests/data/torch_golden_surface.npz, erle.*)",
              "device": str(device),
              "scenarios": {}}
    if device.type == "cuda":
        report["card"] = card()
    with np.load(GOLDEN) as g:
        golden = {k: g[k] for k in g.files if k.startswith("erle.")}
    t0 = time.perf_counter()
    for _, scenes in GROUPS:
        for name, res in run([s[0] for s in scenes], device).items():
            r = check(name, *res, golden)
            report["scenarios"][name] = r
            print(f"{name:20s} ERLE {r['erle_db']:7.3f} dB (JAX "
                  f"{r['erle_jax_db']:7.3f})  bit_exact={r['bit_exact']}  "
                  f"scene={r['scene_matches']}", flush=True)
    report["wall_s"] = time.perf_counter() - t0
    report["all_bit_exact"] = all(
        r["bit_exact"] and r["scene_matches"]
        for r in report["scenarios"].values())
    head = _git("rev-parse", "HEAD")
    if head is not None:
        report["commit"] = head
        report["dirty"] = bool(_git("status", "--porcelain",
                                    "--untracked-files=no"))
    else:
        report["commit"] = args.commit or "unknown"
        report["dirty"] = None      # no git here to tell
    report["sources_sha"] = sources_sha()
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"all bit-exact = {report['all_bit_exact']}, "
          f"{report['wall_s']:.1f} s on {report.get('card', device)} "
          f"-> {OUT}")
    return 0 if report["all_bit_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
