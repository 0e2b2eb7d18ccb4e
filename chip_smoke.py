#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero before the
final line):
  1. card     the nvidia-smi name and power limit
  2. build    nvcc builds webrtc_aecm_tpu_torch/csrc into build/torch_kernels
  3. kernels  each CUDA kernel == its plain PyTorch version on the card at
              full width (4096 streams), bit for bit, outputs and state
  4. golden   run_streams_fused through the kernels == the JAX package's
              answer stored in tests/data/torch_golden_16k.npz
  5. main     the 16 kHz desync scene at 4096 streams x 1 s through the
              kernel path == the plain path; the frames and ring kernels
              must each launch once per step (50 steps)
  6. timing   the bench scene at 4096 streams x 1 s: streams served at 1x
              real time on the kernel path and the plain path (CUDA
              events), and each kernel's time per launch beside its plain
              version's
The last two lines are the kernels JSON and the device JSON.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FS, CHUNK, CPS = 16000, 160, 2
B_FULL = 4096
STEP_LEN = CPS * CHUNK


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# scenes (seeded numpy)
# ---------------------------------------------------------------------------

def desync_scene(n_streams, n_chunks, burst_at, offset_step, offset_mod,
                 seed=0):
    """Modulated far-end noise with per-stream offsets; near = 0.4 far +
    noise; per-(chunk, stream) sound-card delays that desynchronise the
    streams' startup and clamp some jitter-ring writes."""
    n = n_chunks * CHUNK
    rng = np.random.default_rng(seed)
    t = np.arange(n + 640)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (FS // 3))
    ff = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    off = offset_step * (np.arange(n_streams) % offset_mod)
    idx = 640 - off[:, None] + np.arange(n)[None, :]
    far = ff[idx].astype(np.int16)
    near = (0.4 * far + rng.normal(0, 150, far.shape)
            ).clip(-32000, 32000).astype(np.int16)
    ms = np.full((n_chunks, n_streams), 40, np.int32)
    ms += 15 * (np.arange(n_streams, dtype=np.int32) % 5)[None, :]
    ms[burst_at:burst_at + 6] += 80
    ms[:min(20, n_chunks)] += 23 * (np.arange(n_streams, dtype=np.int32)
                                    % 7)[None, :]
    n_alt = min(40, n_chunks)   # every fourth stream: clamped ring writes
    ms[:n_alt, 3::4] += 120 * (np.arange(n_alt) % 2)[:, None]
    return far, near, ms


def bench_scene(n_streams, audio_s=1.0):
    """bench.py's scene: one modulated far signal and its attenuated echo
    plus noise, the same for every stream."""
    n_samples = int(audio_s * 100) * CHUNK
    rng = np.random.default_rng(0)
    t = np.arange(n_samples + CHUNK)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (FS // 3))
    far_full = (env * rng.normal(0, 3000, t.shape)).clip(-30000, 30000)
    far1 = far_full[CHUNK:].astype(np.int16)
    near1 = (0.4 * far_full[:n_samples]
             + rng.normal(0, 200, n_samples)).clip(-32000, 32000
                                                   ).astype(np.int16)
    return (np.broadcast_to(far1, (n_streams, n_samples)),
            np.broadcast_to(near1, (n_streams, n_samples)))


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def max_abs_diff(a, b):
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    if a.dtype.is_floating_point:
        return float((a - b).abs().max().item()) if a.numel() else 0.0
    return float((a.long() - b.long()).abs().max().item()) if a.numel() \
        else 0.0


def compare_trees(tag, got, ref):
    """Leaf-by-leaf bit equality of two port states (or tensors); returns
    the largest absolute difference, fails on any."""
    worst = 0.0
    for (path, a), (_, b) in zip(flatten(got), flatten(ref)):
        d = max_abs_diff(a, b)
        if d != 0 or not torch_equal(a, b):
            fail(f"{tag}: {path or 'tensor'} differs (max |diff| {d})")
        worst = max(worst, d)
    return worst


def flatten(tree, prefix=""):
    """[(path, tensor)] of nested tuples / NamedTuples of tensors."""
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or [str(i) for i in
                                                    range(len(tree))]
        out = []
        for name, x in zip(names, tree):
            out += flatten(x, f"{prefix}{name}.")
        return out
    return [(prefix[:-1], tree)]


def torch_equal(a, b):
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a, b))


def cuda_ms(fn, n_iter):
    """Mean ms per call of fn over n_iter calls, with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n_iter):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n_iter


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def phase_build():
    from webrtc_aecm_tpu_torch import _build
    _build.build()
    _build.load_library()
    report = _build.build_info.get("ptxas", "")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    return _build.build_info


class StepCapture:
    """Wraps the two kernel wrappers for a few steps of the kernel path:
    each call also runs the plain version on copies of the same inputs and
    must agree with it bit for bit."""

    def __init__(self):
        self.worst = 0.0
        self.ring_args = None
        self.frames_args = None

    def __enter__(self):
        from webrtc_aecm_tpu_torch import fused, fused_kernel
        from webrtc_aecm_tpu_torch.ops import ring_kernels
        self.fk, self.rk, self.fused = fused_kernel, ring_kernels, fused
        self.orig_frames = fused_kernel.frames_kernel_call
        self.orig_ring = ring_kernels.ring_multi_pass
        cap = self

        def frames(core, t, *rest):
            cap.frames_args = (fused.clone_state(core), t) + rest
            ref = fused.frames_step(fused.clone_state(core), t, *rest)
            got = cap.orig_frames(core, t, *rest)
            cap.worst = max(cap.worst, compare_trees("frames kernel",
                                                     got, ref))
            return got

        def ring(data, *rest):
            cap.ring_args = (data.clone(),) + rest
            ref = fused._ring_write_gather_multi(data.clone(), *rest)
            got = cap.orig_ring(data, *rest)
            cap.worst = max(cap.worst, compare_trees("ring kernel", got,
                                                     ref))
            return got

        fused_kernel.frames_kernel_call = frames
        ring_kernels.ring_multi_pass = ring
        return self

    def __exit__(self, *exc):
        self.fk.frames_kernel_call = self.orig_frames
        self.rk.ring_multi_pass = self.orig_ring
        return False


def ring_case(torch, dev, b, cps, clamp_frac, rng):
    """Ring-pass inputs at main-path shapes: uniform positions, with a
    fraction of streams at their own (clamped) positions and counts."""
    cap, n = 4000, CHUNK
    data = torch.as_tensor(rng.integers(-32768, 32768, (b, cap)),
                           dtype=torch.int16, device=dev)
    values = torch.as_tensor(rng.integers(-32768, 32768, (b, cps * n)),
                             dtype=torch.int32, device=dev)
    w0 = int(rng.integers(0, cap))
    wpos = np.array([(w0 + c * n) % cap for c in range(cps)], np.int32
                    )[:, None].repeat(b, 1)
    rpos = ((wpos - 640) % cap).astype(np.int32)
    n_write = np.full((cps, b), n, np.int32)
    sel = rng.random(b) < clamp_frac
    k = int(sel.sum())
    wpos[:, sel] = rng.integers(0, cap + 1, (cps, k))
    rpos[:, sel] = rng.integers(0, cap + 1, (cps, k))
    n_write[:, sel] = rng.integers(0, n + 1, (cps, k))
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return data, t(wpos), values, t(n_write), t(rpos), n


def phase_kernels(torch, dev):
    from webrtc_aecm_tpu_torch import fused
    from webrtc_aecm_tpu_torch.ops import ring_kernels
    worst = 0.0
    rng = np.random.default_rng(1)
    for cps in (2, 1):
        for frac in (0.0, 0.1):
            data, wpos, values, n_write, rpos, n = ring_case(
                torch, dev, B_FULL, cps, frac, rng)
            ref = fused._ring_write_gather_multi(data, wpos, values,
                                                 n_write, rpos, n)
            if cps == 1:
                got = ring_kernels.ring_pass(data.clone(), wpos[0], values,
                                             n_write[0], rpos[0], n)
            else:
                got = ring_kernels.ring_multi_pass(data.clone(), wpos,
                                                   values, n_write, rpos, n)
            torch.cuda.synchronize()
            worst = max(worst, compare_trees(
                f"ring kernel cps={cps} clamped={frac}", got, ref))
            log(f"  ring kernel == plain: cps={cps}, clamped share {frac}")

    # frames kernel: warm 20 steps on the plain path, then 5 steps through
    # the kernels, each launch checked against the plain version
    far, near, ms = desync_scene(B_FULL, 50, 30, 5, 64)
    step = fused.FusedAecm(FS, CPS, use_kernel=False, device=dev)
    st = fused.create_fused(B_FULL, FS, device=dev)
    st = st._replace(core=fused._to_circular_far(st.core))
    far_t = torch.as_tensor(far, device=dev).to(torch.int32)
    near_t = torch.as_tensor(near, device=dev).to(torch.int32)
    ms_t = torch.as_tensor(ms, device=dev)
    head = 0
    for s in range(25):
        if s == 20:
            step = fused.FusedAecm(FS, CPS, use_kernel=True, device=dev)
            capture = StepCapture().__enter__()
        lo = s * STEP_LEN
        st, head, _, _ = step(st, head, far_t[:, lo:lo + STEP_LEN],
                              near_t[:, lo:lo + STEP_LEN].T,
                              ms_t[s * CPS:(s + 1) * CPS])
    torch.cuda.synchronize()
    capture.__exit__()
    log("  frames kernel == plain on 5 steps after 20 warm-up steps "
        "(outputs, pending blocks, every core leaf)")
    return max(worst, capture.worst), capture


def phase_golden(torch, dev):
    from webrtc_aecm_tpu_torch import convert, fused
    from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
    g = np.load(os.path.join(REPO, "tests", "data", "torch_golden_16k.npz"))
    b = g["far"].shape[0]
    st = fused.create_fused(b, FS, device=dev)
    fin, out = fused.run_streams_fused(st, g["far"], g["near"], FS,
                                       g["ms"], use_kernel=True)
    torch.cuda.synchronize()
    if not np.array_equal(out.cpu().numpy(), g["out"].astype(np.int32)):
        fail("golden: outputs differ from the JAX package's")
    n = 0
    for path, leaf in tree_leaves_with_path(convert.fused_state_to_numpy(fin)):
        ref = g["state." + path]
        if leaf.dtype != ref.dtype or not np.array_equal(leaf, ref):
            fail(f"golden: state leaf {path} differs from the JAX package's")
        n += 1
    return n


def phase_main(torch, dev):
    from webrtc_aecm_tpu_torch import fused, fused_kernel
    from webrtc_aecm_tpu_torch.ops import ring_kernels
    far, near, ms = desync_scene(B_FULL, 100, 60, 5, 64)
    st0 = fused.create_fused(B_FULL, FS, device=dev)
    ring_kernels.ring_multi_pass.launches = 0
    fused_kernel.frames_kernel_call.launches = 0
    fin_k, out_k = fused.run_streams_fused(st0, far, near, FS, ms,
                                           use_kernel=True)
    torch.cuda.synchronize()
    launches = {"frames": fused_kernel.frames_kernel_call.launches,
                "ring": ring_kernels.ring_multi_pass.launches}
    n_steps = 100 // CPS
    if launches["frames"] != n_steps or launches["ring"] != n_steps:
        fail(f"main path launches {launches}, expected {n_steps} each")
    fin_p, out_p = fused.run_streams_fused(st0, far, near, FS, ms,
                                           use_kernel=False)
    torch.cuda.synchronize()
    if out_k.shape != (B_FULL, 100 * CHUNK) or out_k.dtype != torch.int32:
        fail(f"main path output shape {tuple(out_k.shape)} {out_k.dtype}")
    if int(out_k.abs().max()) > 32768:
        fail("main path output outside the int16 range")
    worst = compare_trees("main path output", out_k, out_p)
    worst = max(worst, compare_trees("main path final state", fin_k, fin_p))
    return launches, worst


def phase_timing(torch, dev, capture):
    from webrtc_aecm_tpu_torch import fused, fused_kernel
    from webrtc_aecm_tpu_torch.ops import ring_kernels
    far, near = bench_scene(B_FULL, 1.0)
    audio_s = far.shape[1] / FS
    far_t = torch.as_tensor(np.ascontiguousarray(far), device=dev)
    near_t = torch.as_tensor(np.ascontiguousarray(near), device=dev)
    rates = {}
    for use_kernel in (True, False):
        st = fused.create_fused(B_FULL, FS, device=dev)
        st, _ = fused.run_streams_fused(st, far_t, near_t, FS, 40,
                                        use_kernel=use_kernel)  # warm-up
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(3):
            st, out = fused.run_streams_fused(st, far_t, near_t, FS, 40,
                                              use_kernel=use_kernel)
        t1.record()
        torch.cuda.synchronize()
        wall_s = t0.elapsed_time(t1) / 1000.0 / 3
        rates["kernel" if use_kernel else "plain"] = (
            B_FULL * audio_s / wall_s, wall_s)

    # per-launch times at the main path's shapes (the captured step inputs)
    core, t, *rest = capture.frames_args
    work = fused.clone_state(core)
    frames_ms = cuda_ms(lambda: fused_kernel.frames_kernel_call(
        work, t, *rest), 10)
    frames_plain_ms = cuda_ms(lambda: fused.frames_step(core, t, *rest), 3)
    data, *rrest = capture.ring_args
    ring_work = data.clone()
    ring_ms = cuda_ms(lambda: ring_kernels.ring_multi_pass(ring_work,
                                                           *rrest), 50)
    ring_plain_ms = cuda_ms(lambda: fused._ring_write_gather_multi(
        data, *rrest), 10)
    return rates, {"frames": (frames_ms, frames_plain_ms),
                   "ring": (ring_ms, ring_plain_ms)}


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        import webrtc_aecm_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not beside this script ({e})")
    if "jax" in sys.modules:
        fail("the port imported jax")
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    try:
        t = time.perf_counter()
        card = phase_card()
        log(f"[card] {card} ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        info = phase_build()
        log(f"[build] {info.get('path')} nvcc {info.get('seconds', 0):.1f} s "
            f"({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        worst_k, capture = phase_kernels(torch, dev)
        log(f"[kernels] bit-exact at B={B_FULL} "
            f"({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        n_leaves = phase_golden(torch, dev)
        log(f"[golden] outputs and {n_leaves} state leaves == the JAX "
            f"package's ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        launches, worst_m = phase_main(torch, dev)
        log(f"[main] B={B_FULL} x 1 s desync scene: kernel path == plain "
            f"path; launches {launches} ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        rates, per = phase_timing(torch, dev, capture)
        for name, (rate, wall) in rates.items():
            log(f"[timing] {name} path: {rate:.1f} streams at 1x real time "
                f"({wall * 1000:.3f} ms per 1 s of audio x {B_FULL} "
                f"streams) on {card}")
        for name, (k_ms, p_ms) in per.items():
            log(f"[timing] {name} kernel {k_ms:.4f} ms per launch, plain "
                f"{p_ms:.4f} ms (B={B_FULL}) on {card}")
        log(f"[timing] ({time.perf_counter() - t:.2f} s)")
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        fail("a phase raised")

    worst = max(worst_k, worst_m)
    kernels = [
        {"name": "frames_step", "route": "cuda",
         "source": "webrtc_aecm_tpu_torch/csrc/frames.cu",
         "replaces": "webrtc_aecm_tpu/fused.py:1595",
         "launches": launches["frames"], "max_abs_err": worst,
         "ms": per["frames"][0], "plain_ms": per["frames"][1]},
        {"name": "ring_multi_pass", "route": "cuda",
         "source": "webrtc_aecm_tpu_torch/csrc/ring.cu",
         "replaces": "webrtc_aecm_tpu/ops/pallas_ring.py:306",
         "launches": launches["ring"], "max_abs_err": worst,
         "ms": per["ring"][0], "plain_ms": per["ring"][1]},
    ]
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
