#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Two paths of the port are driven, each at 4096 streams: the fused engine
(`run_streams_fused`) and the batch-major engine (`parallel.batch.
run_streams`, one `ChunkStep` per 10 ms).

Phases (each prints its seconds; any failure exits non-zero before the
final line):
  1. card      the nvidia-smi name and power limit
  2. build     nvcc builds webrtc_aecm_tpu_torch/csrc into build/torch_kernels
               (one nvcc per source, all at once)
  3. kernels   each CUDA kernel == its plain PyTorch version on the card at
               full width (4096 streams), bit for bit, outputs and state
  4. golden    run_streams_fused through the kernels == the JAX package's
               answer stored in tests/data/torch_golden_16k.npz
  5. main      the 16 kHz desync scene at 4096 streams x 1 s through the
               fused engine's kernel path == its plain path; the frames and
               ring kernels must each launch once per step (50 steps)
  6. golden    run_streams (batch-major) through the kernels == the JAX
     batch     package's answers in tests/data/torch_golden_batch.npz, for
               each configuration there (8/16 kHz, single/clean input)
  7. main      the same 16 kHz desync scene through run_streams: kernel path
     batch     == plain path, exactly 100 ring_write and 200 ring_gather
               launches, and output and state == the fused engine's (phase 5)
  8. 8 kHz     4096 streams x 0.5 s at 8 kHz with a clean near input through
     clean     run_streams: kernel path == plain path, 50 writes, 50 gathers
  9. timing    streams served at 1x real time on each engine's kernel and
               plain paths (CUDA events); a batch-major chunk's kernel
               launches and device work (torch.profiler); each kernel's time
               per launch (CUDA events, and its device time alone from the
               profiler) beside its plain version's, its bound and, where
               one PyTorch call computes the same function, that call's time
The last three lines are the kernels JSON, the card, and the device JSON.
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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# scenes (seeded numpy)
# ---------------------------------------------------------------------------

def desync_scene(n_streams, n_chunks, burst_at, offset_step, offset_mod,
                 seed=0, fs=FS):
    """Modulated far-end noise with per-stream offsets; near = 0.4 far +
    noise; per-(chunk, stream) sound-card delays that desynchronise the
    streams' startup and clamp some jitter-ring writes."""
    n = n_chunks * (fs // 100)
    rng = np.random.default_rng(seed)
    t = np.arange(n + 640)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / (fs // 3))
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


def clean_input(far, seed=1):
    """A clean near input: a weak echo residue plus noise."""
    rng = np.random.default_rng(seed)
    return (0.05 * far + rng.normal(0, 300, far.shape)).clip(
        -32000, 32000).astype(np.int16)


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


def bound_ms(n_bytes):
    """The least time for moving n_bytes through device memory once."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


class PlainRing:
    """Within the block, the batch-major engine's ring wrappers are their
    plain versions (the plain path on the card; nothing is counted)."""

    def __enter__(self):
        from webrtc_aecm_tpu_torch.ops import ring_buffer, ring_kernels
        self.rk = ring_kernels
        self.orig = (ring_kernels.ring_gather, ring_kernels.ring_write)
        ring_kernels.ring_gather = ring_buffer._contig_read
        ring_kernels.ring_write = ring_buffer._contig_write
        return self

    def __exit__(self, *exc):
        self.rk.ring_gather, self.rk.ring_write = self.orig
        return False


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


def device_events(torch, fn):
    """fn() once under torch.profiler: {device event name: [count, total
    us]} of what ran on the card (kernels, copies, memsets)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c = out.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us()
    return out


def device_ms(torch, fn, n_iter, symbol=None):
    """Device ms of fn, the host's time left out: per launch of the kernel
    whose name holds `symbol`, or (symbol None) all of one call's device
    work, over n_iter calls; None when the profiler saw no such work."""
    fn()
    hits = [v for k, v in device_events(
        torch, lambda: [fn() for _ in range(n_iter)]).items()
        if symbol is None or symbol in k]
    n = n_iter if symbol is None else sum(h[0] for h in hits)
    return sum(h[1] for h in hits) / n / 1e3 if hits and n else None


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
        self.worst = {"frames": 0.0, "ring": 0.0}
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
            cap.worst["frames"] = max(cap.worst["frames"], compare_trees(
                "frames kernel", got, ref))
            return got

        def ring(data, *rest):
            cap.ring_args = (data.clone(),) + rest
            ref = fused._ring_write_gather_multi(data.clone(), *rest)
            got = cap.orig_ring(data, *rest)
            cap.worst["ring"] = max(cap.worst["ring"], compare_trees(
                "ring kernel", got, ref))
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


def ring_io_case(torch, dev, b, n, rng):
    """Inputs of ring_gather / ring_write at main-path shapes, with the
    edge cases: positions resting at the capacity, writes of 0, partial
    and full counts, values outside the int16 range."""
    cap = 4000
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    data = t(rng.integers(-32768, 32768, (b, cap)).astype(np.int16))
    pos = rng.integers(0, cap + 1, b).astype(np.int32)
    pos[::7] = cap
    n_write = rng.integers(0, n + 1, b).astype(np.int32)
    n_write[::5] = 0
    n_write[1::5] = n
    values = rng.integers(-70000, 70000, (b, n)).astype(np.int32)
    return data, t(pos), t(values), t(n_write)


def phase_kernels(torch, dev):
    from webrtc_aecm_tpu_torch import fused
    from webrtc_aecm_tpu_torch.ops import ring_buffer, ring_kernels
    worst = {"frames": 0.0, "ring": 0.0, "gather": 0.0, "write": 0.0}
    rng = np.random.default_rng(1)
    for n in (80, 160):
        data, pos, values, n_write = ring_io_case(torch, dev, B_FULL, n, rng)
        ref = ring_buffer._contig_read(data, pos, n)
        got = ring_kernels.ring_gather(data, pos, n)
        torch.cuda.synchronize()
        worst["gather"] = max(worst["gather"], compare_trees(
            f"ring_gather n={n}", got, ref))
        ref = ring_buffer._contig_write(data, pos, values, n_write)
        got = ring_kernels.ring_write(data.clone(), pos, values, n_write)
        torch.cuda.synchronize()
        worst["write"] = max(worst["write"], compare_trees(
            f"ring_write n={n}", got, ref))
        log(f"  ring_gather, ring_write == plain: n={n}, positions at the "
            "capacity, writes of 0 / partial / full, values outside int16")
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
            worst["ring"] = max(worst["ring"], compare_trees(
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
    for k in ("frames", "ring"):
        worst[k] = max(worst[k], capture.worst[k])
    return worst, capture


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
    return launches, worst, (fin_k, out_k)


def golden_configs(g):
    """{name: (sample rate, far, near, ms, clean or None)} of the batch
    golden file."""
    out = {}
    for key in g.files:
        if key.endswith(".out"):
            name = key[:-4]
            fs = 16000 if name.startswith("16k") else 8000
            out[name] = (fs, g[f"{name}.far"], g[f"{name}.near"],
                         g[f"{name}.ms"], g[f"{name}.clean"]
                         if f"{name}.clean" in g.files else None)
    return out


def phase_golden_batch(torch, dev):
    from webrtc_aecm_tpu_torch import convert
    from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
    from webrtc_aecm_tpu_torch.parallel import batch
    g = np.load(os.path.join(REPO, "tests", "data",
                             "torch_golden_batch.npz"))
    configs = golden_configs(g)
    if len(configs) != 4:
        fail(f"batch golden file holds {sorted(configs)}, expected 4")
    n = 0
    for name, (fs, far, near, ms, clean) in configs.items():
        st = batch.create_batch(far.shape[0], fs, device=dev)
        fin, out = batch.run_streams(st, far, near, fs, ms, clean=clean)
        torch.cuda.synchronize()
        if not np.array_equal(out.cpu().numpy(),
                              g[f"{name}.out"].astype(np.int32)):
            fail(f"batch golden {name}: outputs differ from the JAX "
                 "package's")
        for path, leaf in tree_leaves_with_path(
                convert.aecm_state_to_numpy(fin)):
            ref = g[f"{name}.state.{path}"]
            if leaf.dtype != ref.dtype or not np.array_equal(leaf, ref):
                fail(f"batch golden {name}: state leaf {path} differs")
            n += 1
        log(f"  {name}: outputs and state == the JAX package's")
    return sorted(configs), n


def run_batch(torch, dev, far, near, fs, ms, clean=None):
    """run_streams from fresh streams; returns (final state, out)."""
    from webrtc_aecm_tpu_torch.parallel import batch
    st = batch.create_batch(near.shape[0], fs, device=dev)
    res = batch.run_streams(st, far, near, fs, ms, clean=clean)
    torch.cuda.synchronize()
    return res


def counted_batch_run(torch, dev, far, near, fs, ms, clean=None):
    """The batch-major kernel path with the ring counters set to 0 just
    before it and read just after."""
    from webrtc_aecm_tpu_torch.ops import ring_kernels
    ring_kernels.ring_write.launches = 0
    ring_kernels.ring_gather.launches = 0
    fin, out = run_batch(torch, dev, far, near, fs, ms, clean)
    return fin, out, {"ring_write": ring_kernels.ring_write.launches,
                      "ring_gather": ring_kernels.ring_gather.launches}


def phase_main_batch(torch, dev, fused_ref):
    from webrtc_aecm_tpu_torch import fused
    far, near, ms = desync_scene(B_FULL, 100, 60, 5, 64)
    fin_k, out_k, launches = counted_batch_run(torch, dev, far, near, FS, ms)
    if launches != {"ring_write": 100, "ring_gather": 200}:
        fail(f"batch main path launches {launches}, expected 100 writes "
             "and 200 gathers")
    with PlainRing():
        fin_p, out_p = run_batch(torch, dev, far, near, FS, ms)
    if out_k.shape != (B_FULL, 100 * CHUNK) or out_k.dtype != torch.int32:
        fail(f"batch main path output shape {tuple(out_k.shape)}")
    worst = compare_trees("batch main path output", out_k, out_p)
    worst = max(worst, compare_trees("batch main path final state", fin_k,
                                     fin_p))
    fin_f, out_f = fused_ref
    compare_trees("batch-major == fused engine, output", out_k, out_f)
    compare_trees("batch-major == fused engine, state", fin_k,
                  fused.from_fused_state(fin_f))
    return launches, worst, fin_k


def phase_clean_8k(torch, dev):
    far, near, ms = desync_scene(B_FULL, 50, 30, 5, 64, fs=8000)
    clean = clean_input(far)
    fin_k, out_k, launches = counted_batch_run(torch, dev, far, near, 8000,
                                               ms, clean)
    if launches != {"ring_write": 50, "ring_gather": 50}:
        fail(f"8 kHz clean launches {launches}, expected 50 and 50")
    with PlainRing():
        fin_p, out_p = run_batch(torch, dev, far, near, 8000, ms, clean)
    worst = compare_trees("8 kHz clean output", out_k, out_p)
    return launches, max(worst, compare_trees("8 kHz clean final state",
                                              fin_k, fin_p))


def engine_rate(torch, run, audio_s):
    """Streams at 1x real time of one run() (CUDA events), and its wall."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    torch.cuda.synchronize()
    wall_s = t0.elapsed_time(t1) / 1000.0
    return B_FULL * audio_s / wall_s, wall_s


def frames_bytes(rest, b):
    """Bytes the frames kernel must move in one step: every core leaf but
    the far history read and written once, the far-history rows the step's
    5 block slots fetch, the step's inputs and outputs."""
    from webrtc_aecm_tpu_torch import fused_kernel
    state = 0
    for (path, _), (rows, dtype) in zip(
            fused_kernel._core_leaves(rest[0]), fused_kernel._leaf_layout()):
        if path not in ("far_history", "far_q_domains"):
            state += rows * dtype.itemsize
    far, noisy, phase, run_rows = rest[2:6]
    ins = sum(x.shape[0] for x in (far, noisy, phase, run_rows)) * 4
    history = 5 * (40 + 1) * 4
    outs = (far.shape[0] + 5 * 40 + 5) * 4
    return (2 * state + ins + history + outs) * b


def ring_pass_bytes(wpos, n_write, n_read):
    """Bytes of a ring pass: the written samples' values in and ring
    slots out, the gathered samples read and written, the positions."""
    cps, b = wpos.shape
    written = int(n_write.clamp(min=0, max=n_read).sum())
    return written * (4 + 2) + cps * b * n_read * (2 + 4) + 3 * cps * b * 4


def phase_timing(torch, dev, capture, batch_state):
    from webrtc_aecm_tpu_torch import fused, fused_kernel
    from webrtc_aecm_tpu_torch.ops import ring_buffer, ring_kernels
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
        rate, wall = engine_rate(torch, lambda: [fused.run_streams_fused(
            st, far_t, near_t, FS, 40, use_kernel=use_kernel)
            for _ in range(3)], 3 * audio_s)
        rates["fused " + ("kernel" if use_kernel else "plain")] = (
            rate, wall / 3)
    run_batch(torch, dev, far_t, near_t, FS, 40)        # warm-up
    rates["batch-major kernel"] = engine_rate(
        torch, lambda: run_batch(torch, dev, far_t, near_t, FS, 40), audio_s)
    with PlainRing():
        rates["batch-major plain"] = engine_rate(
            torch, lambda: run_batch(torch, dev, far_t, near_t, FS, 40),
            audio_s)

    # per-launch times at the main paths' shapes
    per = {}
    core, t, *rest = capture.frames_args
    work = fused.clone_state(core)
    frames = lambda: fused_kernel.frames_kernel_call(work, t, *rest)  # noqa: E731
    per["frames_step"] = dict(
        ms=cuda_ms(frames, 10),
        plain_ms=cuda_ms(lambda: fused.frames_step(core, t, *rest), 3),
        bound_ms=bound_ms(frames_bytes([core, t] + rest, B_FULL)),
        library_ms=None)
    data, wpos, values, n_write, rpos, n_read = capture.ring_args
    ring_work = data.clone()
    multi = lambda: ring_kernels.ring_multi_pass(  # noqa: E731
        ring_work, wpos, values, n_write, rpos, n_read)
    per["ring_multi_pass"] = dict(
        ms=cuda_ms(multi, 50),
        plain_ms=cuda_ms(lambda: fused._ring_write_gather_multi(
            data, wpos, values, n_write, rpos, n_read), 10),
        bound_ms=bound_ms(ring_pass_bytes(wpos, n_write, n_read)),
        library_ms=None)
    one = (wpos[0], values[:, :n_read].contiguous(), n_write[0], rpos[0])
    single = lambda: ring_kernels.ring_pass(  # noqa: E731
        ring_work, one[0], one[1], one[2], one[3], n_read)
    per["ring_pass"] = dict(
        ms=cuda_ms(single, 50),
        plain_ms=cuda_ms(lambda: fused._ring_write_gather_multi(
            data, wpos[:1], one[1], n_write[:1], rpos[:1], n_read), 10),
        bound_ms=bound_ms(ring_pass_bytes(wpos[:1], n_write[:1], n_read)),
        library_ms=None)

    # the batch-major passes on the main path's final jitter rings
    fb = batch_state.farend_buf
    ring = fb.data.contiguous()
    b, cap = ring.shape
    rng = np.random.default_rng(2)
    vals = torch.as_tensor(rng.integers(-32768, 32768, (b, CHUNK)),
                           dtype=torch.int32, device=dev)
    n_w = ring_buffer.available_write(fb).clamp(max=CHUNK).contiguous()
    wp, rp = fb.write_pos.contiguous(), fb.read_pos.contiguous()
    idx = (rp[:, None].long() + torch.arange(80, device=dev)) % cap
    gather = lambda: ring_kernels.ring_gather(ring, rp, 80)  # noqa: E731
    library_gather = lambda: torch.gather(ring, 1, idx)  # noqa: E731
    per["ring_gather"] = dict(
        ms=cuda_ms(gather, 100),
        plain_ms=cuda_ms(lambda: ring_buffer._contig_read(ring, rp, 80),
                         20),
        bound_ms=bound_ms(b * 80 * 2 * 2 + b * 4),
        library_ms=cuda_ms(library_gather, 100))
    j = torch.arange(CHUNK, device=dev)
    valid = j[None, :] < n_w[:, None]
    flat_idx = ((wp[:, None].long() + j) % cap
                + torch.arange(b, device=dev)[:, None] * cap)[valid]
    vals16 = vals.to(torch.int16)[valid]
    ring_w = ring.clone()
    written = int(n_w.sum())
    write = lambda: ring_kernels.ring_write(ring_w, wp, vals, n_w)  # noqa: E731
    library_write = lambda: ring_w.view(-1).index_put_(  # noqa: E731
        (flat_idx,), vals16)
    per["ring_write"] = dict(
        ms=cuda_ms(write, 100),
        plain_ms=cuda_ms(lambda: ring_buffer._contig_write(ring, wp, vals,
                                                           n_w), 20),
        bound_ms=bound_ms(written * (4 + 2) + b * 8),
        library_ms=cuda_ms(library_write, 100))

    # the profiler last, so that no CUDA-event time above runs beside it:
    # each kernel's device time alone, and where a batch-major 10 ms chunk
    # goes (its device work over a few ChunkSteps, beside the unprofiled
    # wall time per chunk)
    for name, fn, n, symbol in (
            ("frames_step", frames, 5, "frames_step_kernel"),
            ("ring_multi_pass", multi, 20, "ring_multi_pass_kernel"),
            ("ring_pass", single, 20, "ring_multi_pass_kernel"),
            ("ring_gather", gather, 20, "ring_gather_kernel"),
            ("ring_write", write, 20, "ring_write_kernel")):
        per[name]["device_ms"] = device_ms(torch, fn, n, symbol)
    for name, fn in (("ring_gather", library_gather),
                     ("ring_write", library_write)):
        per[name]["library_device_ms"] = device_ms(torch, fn, 20)
    from webrtc_aecm_tpu_torch._tree import tree_map
    from webrtc_aecm_tpu_torch.parallel import batch
    step = batch.make_chunk_step(FS, device=dev)
    st_b, n_prof = tree_map(lambda x: x.clone(), batch_state), 4

    def chunks():
        s = st_b
        for c in range(n_prof):
            cols = slice(c * CHUNK, (c + 1) * CHUNK)
            s, _, _ = step(s, far_t[:, cols], near_t[:, cols], 40)
    ev = device_events(torch, chunks)
    chunk_profile = dict(
        launches=sum(v[0] for k, v in ev.items()
                     if not k.startswith(("Memcpy", "Memset"))) / n_prof,
        busy_ms=sum(v[1] for v in ev.values()) / 1e3 / n_prof,
        wall_ms=rates["batch-major kernel"][1] * 1e3 / (audio_s * 100))
    return rates, per, chunk_profile


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
        worst, capture = phase_kernels(torch, dev)
        log(f"[kernels] bit-exact at B={B_FULL} "
            f"({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        n_leaves = phase_golden(torch, dev)
        log(f"[golden] outputs and {n_leaves} state leaves == the JAX "
            f"package's ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        launches, worst_m, fused_ref = phase_main(torch, dev)
        log(f"[main] B={B_FULL} x 1 s desync scene: kernel path == plain "
            f"path; launches {launches} ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        names, n_leaves = phase_golden_batch(torch, dev)
        log(f"[golden batch] {', '.join(names)}: outputs and {n_leaves} "
            f"state leaves == the JAX package's "
            f"({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        launches_b, worst_b, batch_state = phase_main_batch(torch, dev,
                                                            fused_ref)
        del fused_ref
        log(f"[main batch] B={B_FULL} x 1 s desync scene through "
            f"run_streams: kernel path == plain path == fused engine; "
            f"launches {launches_b} ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        launches_8k, worst_8k = phase_clean_8k(torch, dev)
        log(f"[8 kHz clean] B={B_FULL} x 0.5 s: kernel path == plain path; "
            f"launches {launches_8k} ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        rates, per, prof = phase_timing(torch, dev, capture, batch_state)
        for name, (rate, wall) in rates.items():
            log(f"[timing] {name} path: {rate:.1f} streams at 1x real time "
                f"({wall * 1000:.3f} ms per 1 s of audio x {B_FULL} "
                f"streams) on {card}")
        log(f"[timing] batch-major chunk (B={B_FULL}, profiled): "
            f"{prof['launches']:.1f} kernel launches and "
            f"{prof['busy_ms']:.3f} ms of device work per 10 ms chunk; "
            f"unprofiled wall {prof['wall_ms']:.3f} ms per chunk, device "
            f"idle {1 - prof['busy_ms'] / prof['wall_ms']:.1%} on {card}")
        def ms_or(x):
            return "not measured" if x is None else f"{x:.4f} ms"
        for name, r in per.items():
            lib = ("none" if r["library_ms"] is None else
                   f"{r['library_ms']:.4f} ms (device "
                   f"{ms_or(r['library_device_ms'])})")
            log(f"[timing] {name}: {r['ms']:.4f} ms per launch (device "
                f"{ms_or(r['device_ms'])}), plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.5f} ms, library call {lib} "
                f"(B={B_FULL}) on {card}")
        log(f"[timing] ({time.perf_counter() - t:.2f} s)")
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        fail("a phase raised")

    path_err = {"frames_step": max(worst["frames"], worst_m),
                "ring_multi_pass": max(worst["ring"], worst_m),
                "ring_gather": max(worst["gather"], worst_b, worst_8k),
                "ring_write": max(worst["write"], worst_b, worst_8k)}
    counts = {"frames_step": launches["frames"],
              "ring_multi_pass": launches["ring"],
              "ring_gather": launches_b["ring_gather"],
              "ring_write": launches_b["ring_write"]}
    where = {"frames_step": ("frames.cu", "webrtc_aecm_tpu/fused.py:1595"),
             "ring_multi_pass": ("ring.cu",
                                 "webrtc_aecm_tpu/ops/pallas_ring.py:306"),
             "ring_gather": ("ring.cu",
                             "webrtc_aecm_tpu/ops/pallas_ring.py:56"),
             "ring_write": ("ring.cu",
                            "webrtc_aecm_tpu/ops/pallas_ring.py:379")}
    kernels = []
    for name, (src, replaces) in where.items():
        r = per[name]
        if counts[name] <= 0:
            fail(f"{name} was not launched on its main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"webrtc_aecm_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": path_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"]})
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
