#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py
With `--frames` it stops after phase 3 and the frames kernel's times (at
1024, 4096 and 16384 streams on the main path's mode, and at 4096 in each
mode), and prints no result line: to compare two versions of the kernel,
unpack the other commit into an ignored directory (`git archive <commit> |
tar -x -C build/other`) and run both in turns, back to back, in one process
after the other on one card.

The port's paths are driven at 4096 streams: the fused engine
(`run_streams_fused`, and its 10 ms real-time step through
`AecmPipeline.step`), the batch-major engine (`parallel.batch.run_streams`,
one `ChunkStep` per 10 ms), and both through `AecmPipeline`.

Phases (each prints its seconds; any failure exits non-zero before the
final line):
  1. card      the nvidia-smi name and power limit
  2. build     nvcc builds webrtc_aecm_tpu_torch/csrc into build/torch_kernels
               (one nvcc per source, all at once); each frames kernel
               instance's registers, stack, spills and layout
  3. kernels   each CUDA kernel == its plain PyTorch version on the card at
               full width (4096 streams), bit for bit, outputs and state:
               the ring kernels on planted edge cases; the frames kernel in
               each of its modes (FRAMES_MODES: 16 and 8 kHz circular, 2, 3
               and 4 block slots newest-first, clean, abs_approx; a delay
               estimator resized to 37, 64, 128 and 257 rows or rebuilt with
               lookahead capacity 4 and per-stream lookahead 0..3; steps of
               8, 10 and 25 slots at 16 kHz and 7 and 10 at 8 kHz) on steps
               captured from the kernel path and again at 4099 streams, and
               on a planted case (re-blocking fills, run rows, ties in the
               delay search, fixed delays in the pending blocks, deep in the
               history and beyond it, startup transitions, full-scale and
               all-zero inputs, comfort noise at full scale, lookaheads the
               capacity clamps; every shift of an inverse-transform stage and
               the saturating adds must show in the plain run) at 4096 and
               4099 streams, in the main path's mode, in the 8 kHz 3-slot
               clean mode with the newest-first history merge (0 to 3 new
               blocks among the 8 streams of a thread block), and in both at
               history size 257 and lookahead capacity 4
  4. golden    run_streams_fused through the kernels == the JAX package's
               answer stored in tests/data/torch_golden_16k.npz
  5. golden    every entry of tests/data/torch_golden_envelope.npz out of
     envelope  the kernel path: run_streams_fused at 8 and 16 kHz with
               tails, clean inputs and per-stream modes, the 10 ms step
               (abs_approx too), single frames calls in each mode,
               AecmInstance, a JAX checkpoint resumed on both engines;
               and every run_streams_fused entry of
               tests/data/torch_golden_reconfig.npz (resized and
               lookahead-capacity-4 delay estimators, wide steps with tails)
               out of the kernel path, and its single-stream functional
               sequences (create, set_config, init_echo_path, buffer_farend,
               process) through the ring kernels
  6. main      the 16 kHz desync scene at 4096 streams x 1 s through the
               fused engine's kernel path == its plain path; the frames and
               ring kernels must each launch once per step (50 steps)
  7. golden    run_streams (batch-major) through the kernels == the JAX
     batch     package's answers in tests/data/torch_golden_batch.npz, for
               each configuration there (8/16 kHz, single/clean input)
  8. main      the same 16 kHz desync scene through run_streams: kernel path
     batch     == plain path, exactly 100 ring_write and 100 ring_read
               launches (one of each per 10 ms chunk), and output and state
               == the fused engine's (phase 6)
  9. 8 kHz     4096 streams x 0.5 s at 8 kHz with a clean near input through
     clean     run_streams: kernel path == plain path, 50 writes, 50 reads
 10. envelope  AecmPipeline("fused") == AecmPipeline("xla") at 4096 streams,
               8 and 16 kHz, single and clean: run over 1.05 s (a one-chunk
               tail) then 20 steps of 10 ms; output, warnings and state
               equal, and the launches exact (one frames kernel per fused
               step, one ring_multi_pass per multi-chunk step, one ring_pass
               per 10 ms fused step, one ring_write and one ring_read per
               batch-major chunk); and run_streams_fused at 3, 4 and 10
               chunks a step at 16 kHz and 5 and 8 at 8 kHz (one with a
               clean input, one at history size 257 and capacity 4) over 37
               chunks: kernel path == plain path, one frames launch and one
               ring launch per step, tails included
 11. debug     AecmInstance(device="cuda").process(debug=True) call by call
               at 8 kHz, 16 kHz and with a clean input == the JAX package's
               outputs, warnings and every debug tap
               (tests/data/torch_golden_surface.npz, dbg.*); one ring_write
               and one ring_read launch per call
 12. cli       the CLI (utils/cli.py main) in-process on the card: single
               pairs at 8 and 16 kHz with --erle --echo-mode 3, the --batch
               list of 3 pairs and a float32 pair == the JAX CLI's output
               samples (cli.*), the frames and ring_multi_pass kernels
               launched; `python -m webrtc_aecm_tpu_torch` in a subprocess:
               exit code 0 and the same file
 13. erle      tools/erle_report_torch.py's battery on the card: the 10
               scenes of tools/erle_report.py bit-exact with the JAX package
               (erle.*, output and scene hashes), ERLE per scene
 14. mesh      AecmPipeline(mesh=...) on [cuda:0] and [cuda:0, cuda:0] (and
               on two cards when there are two) == no mesh at 1024 streams:
               both engines, run and 10 ms steps, 8 and 16 kHz; the
               two-shard mesh launches exactly twice the one-shard mesh
 15. long call the state bytes of create_batch / create_fused on the card
               linear in the streams and under 128 KiB a stream;
               tests/test_long_call.py's drift sequence == the JAX
               package's (long.*)
 16. timing    streams served at 1x real time on each engine's kernel and
               plain paths at 16 kHz and on the kernel paths at 8 kHz (CUDA
               events); the real-time step's wall ms per 10 ms chunk at 8
               and 16 kHz on both engines; a batch-major chunk's kernel
               launches and device work (torch.profiler); each kernel's time
               per launch (CUDA events, its wrapper's host time alone, and
               its device time alone from the profiler) beside its plain
               version's, its bound (the frames kernel's is its integer
               operations, counted by stage in FRAMES_OPS and weighed
               by what a plain run shows the data to need, over the
               card's int32 rate) and, where PyTorch calls compute the same
               function, their time; the frames kernel at 1024, 4096 and
               16384 streams and in each mode of phase 3; the launch floor
               (an empty kernel through the same binding); what the stream
               handle, an argument check and the output allocations cost
               the host
The kernels JSON keeps the names of the TPU kernels: `ring_gather` is the
read kernel (ring_kernels.ring_read), which took the gather over.
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
INT32_LANES_PER_SM = 64     # Hopper: 4 partitions x 16 INT32 units a clock
# Integer operations of the frames kernel's algorithm for one stream,
# counted from csrc/frames.cu and csrc/spl.cuh.  The rule: an add, a
# subtract, a negate, a multiply, a shift, a logic operation, a compare, a
# select, a min, a max, an abs, a clz, a popc, a convert (to_w16 is one) and
# a division count 1 each; a multiply whose product is only added to or
# subtracted from (a * b + c) counts 1 with its add, one IMAD; a 64-bit add
# or shift counts 2; a float32 operation counts 1/2 (the card has twice the
# float32 lanes); logic on compare results, addresses, loads, stores, loop
# control and warp collectives count 0; an operation on a one-row leaf
# counts once a stream, not once a lane.  Of alternative paths the one taken
# is counted (a lane-parallel kernel may run both).
FFT_BUTTERFLIES = 7 * 64
# tr, ti: two multiply-adds and a shift each (6); ar * 2^14 + rounding, the
# same for ai (2); four outputs of add, shift, convert (12)
BUTTERFLY_OPS = 6 + 2 + 12
# + four abs and four max for the next stage's scaling
INVERSE_BUTTERFLY_OPS = BUTTERFLY_OPS + 8
# scaling: 128 abs, 127 max, min, norm_w16 (261); window: shift, convert,
# multiply, shift, convert on 128 samples (640); magnitudes: 63 bins of
# negate, convert, 2 abs, 2 compares, 2 selects, 2 multiplies, a saturating
# 64-bit add (6), sqrt_floor (11: 2 compares/selects, 2 converts, sqrtf, 2
# multiplies, 2 compares, add, subtract) = 27, 2 edge bins of one abs, 64
# adds for the sum (1,767)
FORWARD_REST_OPS = 261 + 640 + 1767
ACTIVE_BLOCK_OPS = {
    "two forward transforms: 448 butterflies x (1 shared twiddle negate + "
    "2 x 20) + 2 x (scaling 261 + window 640 + magnitudes 1,767)":
        FFT_BUTTERFLIES * (1 + 2 * BUTTERFLY_OPS) + 2 * FORWARD_REST_OPS,
    "inverse transform: Hermitian fill 65 x 6 + 63 x 4 = 642, 448 "
    "butterflies x 28, stage scaling 7 x 7, window and overlap-add "
    "64 x (9 + 7) + 1":
        642 + FFT_BUTTERFLIES * INVERSE_BUTTERFLY_OPS + 49 + 1025,
    "two binary spectra: 2 x (32 bins x 10 + 1)": 642,
    "delay search: 40 on one-row leaves (its rows: FRAMES_OPS)": 40,
    "pending block packed (40 x 4), aligned far block unpacked (65 x 2), "
    "10 on one-row leaves": 300,
    "energies and VAD: 65 bins x 4, four log energies x 10, 60 on one-row "
    "leaves": 360,
    "step size 10, store/restore arbitration 20 rows x 6 + 30, suppression "
    "gain 20, startup 10": 190,
    "Wiener filter: 65 bins x 84 + 10": 5470,
    "efw = dfw * hnl: 65 bins x 8": 520,
    "sample placement: 128 samples x 5": 640,
}
# what is counted: (operations each, how): per active block, per history
# row or entry of one, per row moved, per inactive slot, frame or step;
# all but the first two only where the data or the mode takes the path
FRAMES_OPS = {
    "active block": (sum(ACTIVE_BLOCK_OPS.values()), "ACTIVE_BLOCK_OPS"),
    "delay search row": (7, "each history row of an active block: xor, "
                         "popc, compare, compare and two selects for the "
                         "minimum, max"),
    "mean_bit_counts row updated": (12, "far-end bit count > 0"),
    "histogram entry updated": (12.5, "non-stationary far end: each of the "
                                "history size + 1 entries, 6 compares + 3 "
                                "selects + 7 float32 / 2"),
    "lookahead shift and select": (3, "lookahead capacity > 1: the new "
                                   "row's index and the lookahead clamped "
                                   "to the capacity, per active block"),
    "window reset row": (4, "general instance, each row a window change "
                         "moves (2 H + 3 x 64 + capacity a stream): its "
                         "index, 2 bound compares, a select"),
    "NLMS": (6110, "step size not 0: 65 bins x 94"),
    "hnl squared": (299, "mult == 2: 65 x 3 + 21 + 1 + 41 x 2"),
    "NLP": (587, "nlp_flag: 65 bins x 9 + 2"),
    "comfort noise": (2015, "cng_mode: 65 bins x 31"),
    "clean transform": (
        FFT_BUTTERFLIES * BUTTERFLY_OPS + FORWARD_REST_OPS + 65 * 2,
        "has_clean: a third forward transform per active block (the twiddle "
        "negate shared), its magnitudes stored 65 x 2"),
    "abs_approx magnitudes": (
        63, "abs_approx: 63 bins x (20 - 19) per forward transform: max, "
        "min, 2 shifts, 2 compares, 4 selects, 2 multiplies, 2 shifts, 2 "
        "converts, 2 ands, an add and an and, for 2 multiplies, a "
        "saturating add (6) and sqrt_floor (11)"),
    "inactive slot": (
        FFT_BUTTERFLIES * (1 + BUTTERFLY_OPS) + FORWARD_REST_OPS + 320 + 170,
        "circular history: one forward transform, 64 samples x 5, the "
        "packing 170"),
    "frame": ((80 + 64) * 8, "the emit of a frame: (80 + 64) samples x 8"),
    "step": (128 * 5 + 60, "the in-carry 128 x 5, 60"),
}


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
        self.orig = (ring_kernels.ring_read, ring_kernels.ring_write)
        ring_kernels.ring_read = ring_buffer.read_frames_plain
        ring_kernels.ring_write = ring_buffer.write_plain
        return self

    def __exit__(self, *exc):
        self.rk.ring_read, self.rk.ring_write = self.orig
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


def host_us(torch, fn, n_iter=1000):
    """Host microseconds per call of fn: the host's clock around n_iter
    back-to-back calls, none of which waits for the card; one synchronise
    after the clock has stopped."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n_iter * 1e6


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


def ptxas_entries(report):
    """{entry function: {registers, stack, spill stores, spill loads}} from
    nvcc -Xptxas -v output."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(
                m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def frames_instance(entry):
    """(has_clean, circular, general) of a frames_step_kernel<CLEAN, CIRC,
    GEN> entry, from its mangled template arguments; None for another
    kernel."""
    import re
    m = re.search(r"frames_step_kernelILb([01])ELb([01])ELb([01])E", entry)
    return None if m is None else tuple(m.group(i) == "1" for i in (1, 2, 3))


# the general instances' layouts that phase_build reports: (history size,
# lookahead capacity, frames of the step) for the circular and the
# newest-first history
GENERAL_LAYOUTS = {True: ((100, 1, 8), (100, 4, 4), (257, 4, 4)),
                   False: ((100, 1, 6), (257, 4, 2))}


def phase_build():
    from webrtc_aecm_tpu_torch import _build, fused_kernel
    _build.build()
    _build.load_library()
    report = _build.build_info.get("ptxas", "")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    for entry, info in ptxas_entries(report).items():
        inst = frames_instance(entry)
        if inst is None:
            continue
        clean, circ, gen = inst
        shapes = GENERAL_LAYOUTS[circ] if gen else ((100, 1, 4),)
        lays = []
        for h, cap, n_frames in shapes:
            lay = fused_kernel.frames_layout(clean, circ, h, cap, n_frames)
            if lay["general"] != gen:
                fail(f"frames layout H={h} cap={cap} {n_frames} frames: "
                     f"general {lay['general']}, the instance {gen}")
            if gen and lay["smem_bytes"] != 4 * (
                    fused_kernel.TABLE_WORDS + lay["streams_per_block"]
                    * fused_kernel.stream_words(h, cap, clean)):
                fail(f"frames layout H={h} cap={cap}: {lay['smem_bytes']} "
                     "bytes, fused_kernel.stream_words says otherwise")
            lays.append(
                (f"H={h} capacity {cap} {n_frames} frames: " if gen else "")
                + f"{lay['streams_per_block']} streams per block, "
                f"{lay['smem_bytes']} bytes of shared memory per block, "
                f"{lay['blocks_per_sm']} blocks = {lay['warps_per_sm']} "
                "resident warps per SM")
        log(f"  frames kernel, {'clean' if clean else 'single'} input, "
            f"{'circular' if circ else 'newest-first'} history, "
            f"{'general' if gen else 'main path'} instance: "
            f"{info.get('registers')} registers, {info.get('stack')} bytes "
            f"of stack frame, {info.get('spill_stores')} / "
            f"{info.get('spill_loads')} bytes spilled; one warp per stream; "
            + "; ".join(lays))
        if inst == (False, True, False):
            lay = fused_kernel.frames_layout(False, True)
            if (info.get("stack") or info.get("spill_stores")
                    or lay["smem_bytes"] != 108160
                    or lay["warps_per_sm"] != 16):
                log("  WARNING: the single-input circular instance lost its "
                    "layout (no stack, no spill, 108160 bytes, 16 warps per "
                    "SM)")
    return _build.build_info


class StepCapture:
    """Wraps the three kernel wrappers of the fused step for a few steps of
    the kernel path: each call also runs the plain version on copies of the
    same inputs and must agree with it bit for bit."""

    def __init__(self):
        self.worst = {"frames": 0.0, "ring": 0.0, "ring_pass": 0.0}
        self.ring_args = None
        self.frames_args = None

    def __enter__(self):
        from webrtc_aecm_tpu_torch import fused, fused_kernel
        from webrtc_aecm_tpu_torch.ops import ring_kernels
        self.fk, self.rk, self.fused = fused_kernel, ring_kernels, fused
        self.orig_frames = fused_kernel.frames_kernel_call
        self.orig_ring = ring_kernels.ring_multi_pass
        self.orig_pass = ring_kernels.ring_pass
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

        def one(data, wpos, values, n_write, rpos, n_read):
            ref = fused._ring_write_gather_multi(
                data.clone(), wpos[None], values, n_write[None], rpos[None],
                n_read)
            got = cap.orig_pass(data, wpos, values, n_write, rpos, n_read)
            cap.worst["ring_pass"] = max(cap.worst["ring_pass"], compare_trees(
                "ring_pass kernel", got, ref))
            return got

        fused_kernel.frames_kernel_call = frames
        ring_kernels.ring_multi_pass = ring
        ring_kernels.ring_pass = one
        return self

    def __exit__(self, *exc):
        self.fk.frames_kernel_call = self.orig_frames
        self.rk.ring_multi_pass = self.orig_ring
        self.rk.ring_pass = self.orig_pass
        return False


class PlainProbe:
    """Watches fused.frames_step (the plain version) run once and records,
    per stream, what the data made the step's active blocks do: the shift of
    every inverse-transform stage, saturating adds that clipped, and the
    data-dependent paths that the operation count follows.  `seen[name]` is
    a (B,) mask of streams, `count[name]` a sum over streams and blocks."""

    FUSED = ("_process_block_f", "_process_binary_spectrum_f",
             "_calc_step_size_f", "_complex_ifft_128", "_butterfly_inputs")
    SPL = ("sat_w16", "add_sat_w32")

    def __init__(self, torch, core, run_rows):
        from webrtc_aecm_tpu_torch import fused
        self.torch = torch
        n_act = (core.frame_fill[0] + 80 * run_rows.sum(0)) >> 6
        self.act = [n_act > s for s in range(
            fused._n_slots_for(run_rows.shape[0]))]
        self.slot, self.in_ifft = -1, False
        self.seen, self.count = {}, {"active block": sum(
            a.sum() for a in self.act)}

    def mark(self, name, mask):
        m = mask.reshape(-1) & self.act[self.slot]
        self.seen[name] = self.seen.get(name, False) | m
        self.count[name] = self.count.get(name, 0) + m.sum()

    def __enter__(self):
        from webrtc_aecm_tpu_torch import fused
        probe, spl = self, fused.spl
        self.saved = ([(fused, n, getattr(fused, n)) for n in self.FUSED]
                      + [(spl, n, getattr(spl, n)) for n in self.SPL])
        orig = {n: f for _, n, f in self.saved}

        def _process_block_f(*args):
            probe.slot += 1
            return orig["_process_block_f"](*args)

        def _process_binary_spectrum_f(near, farend, bits):
            stirred = farend.bit_counts > 0
            probe.mark("histogram updated", stirred.any(0))
            probe.count["mean_bit_counts row updated"] = probe.count.get(
                "mean_bit_counts row updated", 0) + (
                    stirred.sum(0) * probe.act[probe.slot]).sum()
            return orig["_process_binary_spectrum_f"](near, farend, bits)

        def _calc_step_size_f(core):
            mu = orig["_calc_step_size_f"](core)
            probe.mark("NLMS", mu != 0)
            return mu

        def _complex_ifft_128(fr, fi, t):
            probe.in_ifft = True
            out = orig["_complex_ifft_128"](fr, fi, t)
            probe.in_ifft = False
            return out

        def _butterfly_inputs(fr, fi, t, s):
            if probe.in_ifft:    # the stage's input: what its shift is for
                top = probe.torch.maximum(fr.abs().amax(0), fi.abs().amax(0))
                shift = (top > 13573).int() + (top > 27146).int()
                for v in (0, 1, 2):
                    probe.mark(f"an inverse-transform stage shifting by {v}",
                               shift == v)
            return orig["_butterfly_inputs"](fr, fi, t, s)

        def sat_w16(x):
            if 0 <= probe.slot < len(probe.act):
                probe.mark("a saturating int16 add or clamp that clipped",
                           ((x > 32767) | (x < -32768)).any(0))
            return orig["sat_w16"](x)

        def add_sat_w32(a, b):
            if 0 <= probe.slot < len(probe.act):
                total = a.long() + b.long()
                probe.mark("a saturating int32 add that clipped",
                           ((total > 2 ** 31 - 1) | (total < -2 ** 31)
                            ).any(0))
            return orig["add_sat_w32"](a, b)

        hooks = locals()
        for mod, name, _ in self.saved:
            setattr(mod, name, hooks[name])
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        self.slot = -1
        return False


def widen_frames_args(torch, frames_args, b):
    """A captured frames_step call (core, tables, far, noisy, clean, phase,
    run_rows, mult, n_frames, has_clean, abs_approx, fpc, head) repeated
    along the stream axis to b streams; every tensor is a fresh contiguous
    copy."""
    from webrtc_aecm_tpu_torch._tree import tree_map
    core, t, far, noisy, clean, phase, run_rows, *tail = frames_args
    b0 = far.shape[1]

    def widen(x):
        if x is None:
            return None
        return torch.cat([x] * (b // b0) + [x[:, :b % b0]],
                         dim=1).contiguous()
    return (tree_map(widen, core), t, widen(far), widen(noisy), widen(clean),
            widen(phase), widen(run_rows)) + tuple(tail)


def frames_planted_case(torch, dev, frames_args, b, head, seed=3):
    """Inputs of one frames_step call at b streams with the cases a
    lane-parallel kernel is most likely to get wrong, planted by stream
    index on a warm state (a captured call, repeated to b streams; its mode
    -- frame count, clean input, abs_approx -- is kept, `head` replaces its
    history head: None for the newest-first history).  Returns (core, rest
    of the arguments, {category: mask})."""
    from webrtc_aecm_tpu_torch import fused
    (core, t, far, noisy, clean, phase, run_rows, mult, n_frames, has_clean,
     abs_approx, fpc, _) = widen_frames_args(torch, frames_args, b)
    fs = 8000 * mult
    rng = np.random.default_rng(seed)
    i = torch.arange(b, device=dev)
    cats = {}
    near_ins = [noisy] + ([clean] if has_clean else [])
    near_bufs = [core.d_buf_noisy, core.in_carry_noisy] + (
        [core.d_buf_clean, core.in_carry_clean] if has_clean else [])

    # the streams of the history-shift case (below), which take their own
    # fills and run rows
    shift_case = head is None and n_frames == 2 and fpc == 1
    hist_m = ((i // 8) % 3 == 0) if shift_case else torch.zeros_like(
        i, dtype=torch.bool)

    def where(name, mask):
        cats[name] = mask
        return mask

    def put(leaf, mask, value, rows=slice(None)):
        leaf[rows, mask] = torch.as_tensor(value, dtype=leaf.dtype,
                                           device=dev)

    history = core.de_near.bit_counts.shape[0]
    la_cap = core.de_near.binary_history.shape[0]
    # a fresh state: every mean_bit_counts row equal, histories empty
    m = where("fresh state (all minima equal)", i % 5 == 0)
    fresh = reconfigured_fused(torch, dev, b, fs, history, la_cap).core
    if head is not None:
        fresh = fused._to_circular_far(fresh)
    for (_, leaf), (_, new) in zip(flatten(core), flatten(fresh)):
        leaf[:, m] = new[:, m]
    # two equal valleys that the far-end rows sliding past them leave alone
    m = where("two equal minima", i % 7 == 1)
    for r in (17, 60 if history <= 100 else history - 27):
        put(core.de_near.mean_bit_counts, m, 0, slice(r, r + 1))
        put(core.de_farend.bit_counts, m, 0, slice(r - 5, r))
        put(core.de_farend.binary_history, m, 0, slice(r - 5, r))
    # re-blocking: the carry fill with the out fill of a running stream, or
    # of one still in its first frames (out fill 0: zero-stuffing)
    for fill in (0, 16, 32, 48):
        m = where(f"frame_fill {fill}", (i % 4 == fill // 16) & ~hist_m)
        put(core.frame_fill, m, fill)
        put(core.out_fill, m & (i % 8 < 4), 48 - fill)
        put(core.out_fill, m & (i % 8 >= 4), 0)
    last = [0] * (n_frames - fpc) + [1] * fpc
    for name, rows, cls in (("run_rows none", [0] * n_frames, 0),
                            ("run_rows the last chunk", last, 1),
                            ("run_rows all", [1] * n_frames, 2)):
        m = where(name, ((i // 4) % 3 == cls) & ~hist_m)
        run_rows[:, m] = torch.as_tensor(rows, dtype=torch.bool,
                                         device=dev)[:, None]
    # fixed delays: in the step's own pending blocks, just past them, and
    # deep in the history (for the circular one on both sides of the head)
    delays = [0, 2, 4, 5, 50, 97, 99] + ([150, history - 1]
                                         if history > 100 else [])
    fixed = torch.as_tensor(delays, dtype=torch.int32,
                            device=dev)[(i // 11) % len(delays)]
    m = where("fixed_delay >= 0", (i % 11 == 2) & ~hist_m)
    if history > 100:
        where("fixed delay beyond the far history (a zero block)",
              m & (fixed >= 100))
    core.fixed_delay[0, m] = fixed[m]
    where("fixed delay in the pending blocks", m & (fixed <= 4))
    if head is not None:
        where("fixed delay past the head wrap",
              m & (fixed - 5 >= 0) & (head + 99 - (fixed - 5) >= 100))
        where("fixed delay before the head wrap",
              m & (head + 99 - (fixed - 1) < 100))
    else:
        where("fixed delay deep in the history", m & (fixed >= 50))
    # a silent near end under full suppression over a saturated noise
    # estimate: comfort noise at full scale in every bin, the largest input
    # the inverse transform can get
    m = where("silent near end over a full-scale noise estimate",
              i % 37 == 12)
    for leaf in near_ins + near_bufs + [core.near_filt]:
        put(leaf, m, 0)
    put(core.noise_est, m, 0x7FFFFFFF)
    put(core.cng_mode, m, 1)
    put(core.cng_mode, where("cng_mode 0", i % 13 == 3), 0)
    where("cng_mode 1", core.cng_mode[0] == 1)
    put(core.nlp_flag, where("nlp_flag 0", i % 17 == 4), 0)
    where("nlp_flag 1", core.nlp_flag[0] == 1)
    for name, cls, state, count in (
            ("startup_state 0, tot_count 511", 5, 0, 511),
            ("startup_state 1, tot_count 1023", 6, 1, 1023),
            ("startup_state 2", 7, 2, 5000)):
        m = where(name, i % 19 == cls)
        put(core.startup_state, m, state)
        put(core.tot_count, m, count)
    put(core.de_near.robust_validation_enabled,
        where("robust validation on", i % 31 == 11), 1)
    if la_cap > 1:
        # lookahead values the capacity clamps
        put(core.de_near.lookahead, where("lookahead above the capacity",
                                          i % 41 == 5), la_cap + 5)
        put(core.de_near.lookahead, where("lookahead below 0", i % 41 == 6),
            -3)
        where("lookahead at the capacity's last row",
              core.de_near.lookahead[0] == la_cap - 1)
    # full-scale inputs: the IFFT's stage shifts and the saturating adds
    n = far.shape[0]
    tone = np.round(32767 * np.sin(2 * np.pi * 9 * np.arange(n) / 128))
    for name, cls, wave in (
            ("full-scale square noise", 0,
             rng.choice([-32768, 32767], (n, 1))),
            ("full-scale tone", 1, tone[:, None]),
            ("full-scale constant", 2, np.full((n, 1), 32767))):
        m = where(name, (i % 23 == 9) & ((i // 23) % 3 == cls))
        for leaf in [far] + near_ins:
            put(leaf, m, wave)
    m = where("all-zero inputs and filters", i % 29 == 10)
    for leaf in [far, core.x_buf, core.in_carry_far, core.echo_filt,
                 core.near_filt] + near_ins + near_bufs:
        put(leaf, m, 0)
    if shift_case:
        # the newest-first history merge: in every third block of 8 streams
        # the 8 streams take 0, 1, 2 and 3 new blocks (fill0, active frames
        # by stream), and some read fixed delays at the rows that shift
        g = i % 8
        m = where("history shift: 0 to 3 new blocks in one block of 8",
                  hist_m)
        fills = torch.as_tensor([0, 0, 48, 32, 0, 16, 48, 48], device=dev)
        ks = torch.as_tensor([0, 1, 1, 2, 2, 1, 2, 0], device=dev)
        core.frame_fill[0, m] = fills[g[m]].to(core.frame_fill.dtype)
        for f in range(n_frames):
            run_rows[f, m] = (f >= n_frames - ks[g[m]])
        delays = torch.as_tensor([-1, 0, 2, 3, 4, 97, 98, 99],
                                 device=dev)[(i // 8) % 8]
        core.fixed_delay[0, m] = delays[m].to(core.fixed_delay.dtype)
        for v in (0, 1, 2, 3):
            where(f"history shift by {v} blocks",
                  m & (((core.frame_fill[0] + 80 * run_rows.sum(0)) >> 6)
                       == v))
        where("history shift with a fixed delay at the rows that move",
              m & (core.fixed_delay[0] >= 97))
    lows = core.de_near.mean_bit_counts[:history]
    where("equal minima in mean_bit_counts",
          (lows == lows.min(0).values).sum(0) >= 2)
    return core, (t, far, noisy, clean, phase, run_rows, mult, n_frames,
                  has_clean, abs_approx, fpc, head), cats


def frames_planted_check(torch, dev, frames_args, b, head, tag=""):
    """The frames kernel == fused.frames_step on the planted case at b
    streams: every output and every core leaf; fails if a category of the
    case has no stream.  What the full-scale inputs are there to reach (each
    shift of an inverse-transform stage, a saturating add that clips) is
    read off the plain run, not off what was planted."""
    from webrtc_aecm_tpu_torch import fused, fused_kernel
    core, rest, cats = frames_planted_case(torch, dev, frames_args, b, head)
    with PlainProbe(torch, core, rest[5]) as probe:
        ref = fused.frames_step(fused.clone_state(core), *rest)
    reached = [f"an inverse-transform stage shifting by {v}"
               for v in (0, 1, 2)] + [
        "a saturating int16 add or clamp that clipped",
        "a saturating int32 add that clipped"]
    cats.update({k: probe.seen.get(k, torch.zeros(b, dtype=torch.bool,
                                                  device=dev))
                 for k in reached})
    missing = [k for k, m in cats.items() if not bool(m.any())]
    if missing:
        fail(f"frames planted case {tag} B={b} lacks: {missing}")
    got = fused_kernel.frames_kernel_call(core, *rest)
    torch.cuda.synchronize()
    worst = compare_trees(f"frames kernel, planted case {tag} B={b}", got,
                          ref)
    log(f"  frames kernel == plain on the planted case {tag} at B={b}, head "
        f"{head}: " + ", ".join(f"{k} ({int(m.sum())})"
                                for k, m in cats.items()))
    return worst


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
    """Jitter rings for ring_write / ring_read at main-path shapes, as a
    consistent (data, read_pos, write_pos, rw_wrap), with the edge cases by
    stream index: every 7th a read position resting at the capacity, every
    5th a full ring (a write of 0), every 11th fewer than 80 readable
    samples, every 23rd an empty ring, every 13th exactly n free slots up
    to the ring's end (a write of exactly the margin), every 17th n / 2 (a
    write that wraps); elsewhere random fills, three in ten short of n
    free slots (clamped writes).  Also values outside the int16
    range, and a gate that is false on every 4th stream."""
    cap = 4000
    i = np.arange(b)
    read_pos = rng.integers(0, cap, b)
    fill = rng.integers(0, cap + 1, b)
    clamped = rng.random(b) < 0.3
    fill[clamped] = cap - rng.integers(1, n, b)[clamped]
    read_pos[i % 7 == 0] = cap
    fill[i % 5 == 0] = cap
    fill[i % 11 == 0] = rng.integers(0, 80, b)[i % 11 == 0]
    fill[i % 23 == 0] = 0
    for every, margin in ((13, n), (17, n // 2)):
        sel = i % every == 0         # write_pos = cap - margin, room for n
        fill[sel] = rng.integers(0, cap - n + 1, b)[sel]
        read_pos[sel] = cap - margin - fill[sel]
    end = read_pos + fill
    write_pos = np.where(end > cap, end - cap, end)
    rw_wrap = (end > cap).astype(np.int32)
    # a full ring whose write position came to rest at the capacity
    rest = (i % 35 == 0)
    read_pos[rest], write_pos[rest], rw_wrap[rest] = cap, cap, 1
    t = lambda x, dt: torch.as_tensor(np.asarray(x, dt), device=dev)  # noqa: E731
    ring = (t(rng.integers(-32768, 32768, (b, cap)), np.int16),
            t(read_pos, np.int32), t(write_pos, np.int32),
            t(rw_wrap, np.int32))
    values = t(rng.integers(-70000, 70000, (b, n)), np.int32)
    return ring, values, t(i % 4 != 0, np.bool_)


# the modes of the frames kernel held against its plain version on the
# card: (name, sample rate, chunks per step, clean input, abs_approx,
# delay-estimator history size, lookahead capacity (> 1: per-stream
# lookahead b mod capacity)); the first is the main path's, the next seven
# the other modes of the main path's instances, the rest the general
# instances': a resized or rebuilt delay estimator, and steps of more than
# 5 block slots
FRAMES_MODES = (
    ("16k circular", 16000, 2, False, False, 100, 1),
    ("8k circular", 8000, 4, False, False, 100, 1),
    ("8k 2 slots", 8000, 1, False, False, 100, 1),
    ("8k 3 slots clean", 8000, 2, True, False, 100, 1),
    ("8k 4 slots abs_approx", 8000, 3, False, True, 100, 1),
    ("16k 3 slots clean abs_approx", 16000, 1, True, True, 100, 1),
    ("16k circular clean", 16000, 2, True, False, 100, 1),
    ("16k 3 slots, the 10 ms step", 16000, 1, False, False, 100, 1),
    ("16k circular, lookahead 4", 16000, 2, False, False, 100, 4),
    ("16k circular, H 37", 16000, 2, False, False, 37, 1),
    ("8k circular, H 64", 8000, 4, False, False, 64, 1),
    ("16k circular clean, H 128", 16000, 2, True, False, 128, 1),
    ("16k circular, H 257 lookahead 4", 16000, 2, False, False, 257, 4),
    ("8k 3 slots clean, H 257 lookahead 4", 8000, 2, True, False, 257, 4),
    ("16k 8 slots", 16000, 3, False, False, 100, 1),
    ("16k 10 slots circular", 16000, 4, False, False, 100, 1),
    ("16k 10 slots circular, H 128 lookahead 4", 16000, 4, False, False, 128,
     4),
    ("16k 25 slots circular clean", 16000, 10, True, False, 100, 1),
    ("8k 7 slots", 8000, 5, False, False, 100, 1),
    ("8k 10 slots circular", 8000, 8, False, False, 100, 1),
)


def reconfigured_fused(torch, dev, b, fs, history, cap):
    """Fresh fused streams whose delay estimator is resized to `history`
    (set_history_size) and, for cap > 1, rebuilt with lookahead capacity
    cap and per-stream lookahead b mod cap."""
    from webrtc_aecm_tpu_torch import delay_estimator as de, fused
    from webrtc_aecm_tpu_torch.parallel import batch as pbatch
    st = pbatch.create_batch(b, fs, device=dev)
    dn, df = st.core.de_near, st.core.de_farend
    if history != 100:
        dn, df = de.set_history_size(dn, df, history)
    if cap > 1:
        dn = dn._replace(
            binary_history=torch.zeros((b, cap), dtype=torch.int64,
                                       device=dev),
            lookahead=torch.arange(b, dtype=torch.int32, device=dev) % cap)
    return fused.to_fused_state(st._replace(core=st.core._replace(
        de_near=dn, de_farend=df)))


def capture_mode(torch, dev, fs, cps, with_clean, abs_approx, b, n_warm,
                 n_check, history=100, cap=1):
    """A fused step of this mode over the desync scene at b streams: n_warm
    steps on the plain path, then n_check on the kernel path with every
    kernel launch checked against its plain version.  Returns the
    StepCapture (the last frames call's arguments, the worst differences)."""
    from webrtc_aecm_tpu_torch import fused
    chunk = fs // 100
    n_chunks = cps * (n_warm + n_check)
    far, near, ms = desync_scene(b, n_chunks, n_chunks // 2, 5, 64, fs=fs)
    dv = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    far_t, near_t, ms_t = dv(far).int(), dv(near).int(), dv(ms)
    cl_t = dv(clean_input(far)).int() if with_clean else None
    st = reconfigured_fused(torch, dev, b, fs, history, cap)
    head, capture = 0, None
    for s in range(n_warm + n_check):
        if s in (0, n_warm):
            step = fused.FusedAecm(fs, cps, use_kernel=s == n_warm,
                                   device=dev, has_clean=with_clean,
                                   abs_approx=abs_approx,
                                   lane_major_io=False)
        if s == 0 and step.circular_far:
            st = st._replace(core=fused._to_circular_far(st.core))
        if s == n_warm:
            capture = StepCapture().__enter__()
        cols = slice(s * cps * chunk, (s + 1) * cps * chunk)
        xs = (far_t[:, cols], near_t[:, cols]) + (
            (cl_t[:, cols],) if with_clean else ()) + (
            ms_t[s * cps:(s + 1) * cps],)
        if step.circular_far:
            st, head, _, _ = step(st, head, *xs)
        else:
            st, _, _ = step(st, *xs)
    torch.cuda.synchronize()
    capture.__exit__()
    return capture


def frames_widened_check(torch, captured, b, tag):
    """The frames kernel == plain on a captured call repeated to b
    streams (a ragged last block at 4099)."""
    from webrtc_aecm_tpu_torch import fused, fused_kernel
    args = widen_frames_args(torch, captured, b)
    ref = fused.frames_step(fused.clone_state(args[0]), *args[1:])
    got = fused_kernel.frames_kernel_call(*args)
    torch.cuda.synchronize()
    return compare_trees(f"frames kernel, {tag}, B={b}", got, ref)


def envelope_tool():
    """tools/make_torch_golden_envelope.py as a module: its scenes and
    entry tables (numpy only at import)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden_envelope",
        os.path.join(REPO, "tools", "make_torch_golden_envelope.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def golden_tree(g, prefix, like):
    """The numpy leaves of golden file g under `prefix` + dotted field
    path, in the tree structure of the port state `like`."""
    from types import SimpleNamespace

    def build(tree, at):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return SimpleNamespace(**{f: build(getattr(tree, f), f"{at}{f}.")
                                      for f in tree._fields})
        return g[prefix + at[:-1]]
    return build(like, "")


def golden_state_check(tag, got_np_state, g, prefix):
    """Every leaf of a port state (numpy, the JAX dtypes) == golden file
    g's leaves under prefix; returns the number of leaves."""
    from webrtc_aecm_tpu_torch._tree import tree_leaves_with_path
    n = 0
    for path, leaf in tree_leaves_with_path(got_np_state):
        ref = g[prefix + path]
        if leaf.dtype != ref.dtype or not np.array_equal(leaf, ref):
            fail(f"golden envelope {tag}: state leaf {path} differs from "
                 "the JAX package's")
        n += 1
    return n


def phase_golden_envelope(torch, dev):
    """Every JAX answer of tests/data/torch_golden_envelope.npz out of the
    kernel path on the card: run_streams_fused (8 and 16 kHz, clean, tails,
    per-stream modes, bench.py's scene), the 10 ms step (abs_approx too),
    single frames calls in every mode, AecmInstance, and a JAX checkpoint
    resumed by AecmPipeline on both engines."""
    import tempfile
    from webrtc_aecm_tpu_torch import convert, fused, fused_kernel
    from webrtc_aecm_tpu_torch.api import AecmInstance
    from webrtc_aecm_tpu_torch.models import AecmPipeline
    from webrtc_aecm_tpu_torch.parallel import batch as pbatch
    gen = envelope_tool()
    g = np.load(os.path.join(REPO, "tests", "data",
                             "torch_golden_envelope.npz"))
    b, n_leaves, n_entries = gen.B, 0, 0

    def start(fs, config):
        st = pbatch.create_batch(b, fs, device=dev)
        if config:
            st = pbatch.set_config_batch(st, *gen.stream_modes(b))
        return fused.to_fused_state(st)

    def same_out(tag, out, ref):
        if not np.array_equal(out.cpu().numpy(), ref.astype(np.int32)):
            fail(f"golden envelope {tag}: outputs differ from the JAX "
                 "package's")

    launches0 = fused_kernel.frames_kernel_call.launches
    runs = dict(gen.RSF, bench16k=(16000, gen.BENCH["n_chunks"], 0, 0,
                                   False, False))
    for name, (fs, n_chunks, burst, seed, with_clean, config) in runs.items():
        if name == "bench16k":
            far, near = gen.bench_scene(b, n_chunks)
            clean, ms = None, 40
        else:
            far, near, clean = gen.scene(fs, b, n_chunks, seed, with_clean)
            ms = gen.desync_ms(n_chunks, b, burst) if not config else 40
        fin, out = fused.run_streams_fused(start(fs, config), far, near, fs,
                                           ms, use_kernel=True, clean=clean)
        torch.cuda.synchronize()
        same_out(f"rsf.{name}", out, g[f"rsf.{name}.out"])
        n_leaves += golden_state_check(f"rsf.{name}",
                                       convert.fused_state_to_numpy(fin), g,
                                       f"rsf.{name}.state.")
        n_entries += 1
    for name, (fs, n_chunks, burst, seed, config, absa) in gen.STEP.items():
        chunk = fs // 100
        far, near, _ = gen.scene(fs, b, n_chunks, seed)
        ms = (gen.desync_ms(n_chunks, b, burst) if not config
              else np.full((n_chunks, b), 40, np.int32))
        step = fused.make_fused_chunk_step(fs, abs_approx=absa, device=dev)
        st, outs, warns = start(fs, config), [], []
        for c in range(n_chunks):
            cols = slice(c * chunk, (c + 1) * chunk)
            st, out, warn = step(st, torch.as_tensor(far[:, cols],
                                                     device=dev),
                                 torch.as_tensor(near[:, cols], device=dev),
                                 torch.as_tensor(ms[c], device=dev))
            outs.append(out)
            warns.append(warn)
        torch.cuda.synchronize()
        same_out(f"step.{name}", torch.cat(outs, 1), g[f"step.{name}.out"])
        if not np.array_equal(torch.stack(warns).cpu().numpy(),
                              g[f"step.{name}.warn"]):
            fail(f"golden envelope step.{name}: warnings differ")
        n_leaves += golden_state_check(f"step.{name}",
                                       convert.fused_state_to_numpy(st), g,
                                       f"step.{name}.state.")
        n_entries += 1
    for name, (src, n_frames, has_clean, absa, head, _) in gen.FRAMES.items():
        fs = gen.RSF[src][0]
        like = fused.create_fused(b, fs, device=dev)
        core = convert.fused_state_from_numpy(golden_tree(
            g, f"rsf.{src}.state.", like), device=dev).core
        if head >= 0:
            core = fused._to_circular_far(core)
            h3 = core.far_history.view(100, 40, b)
            core = core._replace(
                far_history=torch.roll(h3, head, 0).reshape(-1, b
                                                            ).contiguous(),
                far_q_domains=torch.roll(core.far_q_domains, head, 0
                                         ).contiguous())
        p = f"frames.{name}"
        dv = lambda k: torch.as_tensor(g[f"{p}.{k}"], device=dev)  # noqa
        core = core._replace(seed=torch.as_tensor(
            g[f"{p}.seed_in"].astype(np.int64), device=dev))
        t = fused.make_tables(dev, fused._n_slots_for(n_frames))
        res = fused_kernel.frames_kernel_call(
            core, t, dv("far"), dv("noisy"),
            dv("clean") if has_clean else None, dv("phase"), dv("run_rows"),
            fs // 8000, n_frames, has_clean, absa, (fs // 100) // 80,
            None if head < 0 else head)
        torch.cuda.synchronize()
        same_out(p, res[1], g[f"{p}.out"])
        if head >= 0:
            for i, k in ((2, "pend_hist"), (3, "pend_q")):
                if not np.array_equal(res[i].cpu().numpy(), g[f"{p}.{k}"]):
                    fail(f"golden envelope {p}: {k} differs")
        n_leaves += golden_state_check(
            p, convert.fused_state_to_numpy(like._replace(core=res[0])).core,
            g, f"{p}.state.")
        n_entries += 1
    frames_launches = fused_kernel.frames_kernel_call.launches - launches0
    for name, (fs, n_chunks, seed, robust, delay, nlp, ep_seed) in \
            gen.API.items():
        far, near, _ = gen.scene(fs, 1, n_chunks, seed)
        inst = AecmInstance(fs, robust_validation=robust, device=dev)
        if ep_seed >= 0:
            ep = np.random.default_rng(ep_seed).integers(0, 4000, 65)
            inst.init_echo_path(ep.astype(np.int16))
        inst.set_control(delay, nlp)
        out = inst.run_file_pair(far[0], near[0], 40)
        p = f"api.{name}"
        if not (np.array_equal(out, g[f"{p}.out"])
                and np.array_equal(inst.get_echo_path(), g[f"{p}.echo_path"])
                and np.float32(inst.delay_quality())
                == g[f"{p}.delay_quality"]):
            fail(f"golden envelope {p}: AecmInstance differs from the JAX "
                 "package's")
        n_entries += 1
    c = gen.CKPT
    chunk = c["fs"] // 100
    far, near, _ = gen.scene(c["fs"], c["n_streams"],
                             c["n_first"] + c["n_next"], c["seed"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        np.savez(path, **{k[len("ckpt.file."):]: g[k] for k in g.files
                          if k.startswith("ckpt.file.")})
        for engine in ("fused", "xla"):
            pipe = AecmPipeline(c["n_streams"], c["fs"], engine=engine,
                                device=dev)
            pipe.load(path)
            out = pipe.run(far[:, c["n_first"] * chunk:],
                           near[:, c["n_first"] * chunk:])
            torch.cuda.synchronize()
            same_out(f"ckpt resumed on the {engine} engine", out,
                     g["ckpt.next_out"])
            n_entries += 1
    return n_entries, n_leaves, frames_launches


def reconfig_tool():
    """tools/make_torch_golden_reconfig.py as a module: its scenes and
    entry tables (numpy only at import)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden_reconfig",
        os.path.join(REPO, "tools", "make_torch_golden_reconfig.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_golden_reconfig(torch, dev):
    """Every JAX answer of tests/data/torch_golden_reconfig.npz that a
    kernel serves, on the card: run_streams_fused on resized and
    lookahead-capacity-4 delay estimators and at wide steps with tails,
    out of the kernel path, and the single-stream functional sequence
    through the ring kernels."""
    from webrtc_aecm_tpu_torch import api, convert, fused, fused_kernel
    gen = reconfig_tool()
    g = np.load(os.path.join(REPO, "tests", "data",
                             "torch_golden_reconfig.npz"))
    b, n_leaves, n_entries = gen.B, 0, 0
    launches0 = fused_kernel.frames_kernel_call.launches
    for name, (fs, n_chunks, burst, seed, with_clean, history, cap,
               cps) in gen.RSF.items():
        far, near, clean = gen.scene(fs, b, n_chunks, seed, with_clean)
        st = reconfigured_fused(torch, dev, b, fs, history, cap)
        fin, out = fused.run_streams_fused(
            st, far, near, fs, gen.desync_ms(n_chunks, b, burst),
            use_kernel=True, clean=clean, chunks_per_step=cps)
        torch.cuda.synchronize()
        if not np.array_equal(out.cpu().numpy(),
                              g[f"rsf.{name}.out"].astype(np.int32)):
            fail(f"golden reconfig rsf.{name}: outputs differ from the JAX "
                 "package's")
        n_leaves += golden_state_check(f"rsf.{name}",
                                       convert.fused_state_to_numpy(fin), g,
                                       f"rsf.{name}.state.")
        n_entries += 1
    frames_launches = fused_kernel.frames_kernel_call.launches - launches0
    for fs, (n_chunks, _, echo_mode, _) in gen.FN.items():
        far, near, ms, ep = gen.fn_inputs(fs)
        n = min(160, fs // 100)
        s = api.create(fs, device=dev)
        s = api.set_config(s, 1, echo_mode)
        s = api.init_echo_path(s, torch.as_tensor(ep, device=dev))
        outs, warns = [], []
        for c in range(n_chunks):
            cols = slice(c * n, (c + 1) * n)
            s = api.buffer_farend(s, torch.as_tensor(far[cols], device=dev),
                                  fs // 8000)
            s, out, warn = api.process(
                s, torch.as_tensor(near[cols], device=dev), None, n,
                int(ms[c]), fs)
            outs.append(out)
            warns.append(warn)
        torch.cuda.synchronize()
        p = f"fn.{fs}"
        if not (np.array_equal(torch.stack(outs).cpu().numpy(),
                               g[f"{p}.out"].astype(np.int32))
                and np.array_equal(torch.stack(warns).cpu().numpy(),
                                   g[f"{p}.warn"])
                and np.array_equal(api.get_echo_path(s).cpu().numpy(),
                                   g[f"{p}.echo_path"].astype(np.int32))):
            fail(f"golden reconfig {p}: the functional sequence differs "
                 "from the JAX package's")
        n_leaves += golden_state_check(p, convert.aecm_state_to_numpy(s), g,
                                       f"{p}.state.")
        n_entries += 1
    return n_entries, n_leaves, frames_launches


# the wide steps run at full width with their launches counted: (sample
# rate, chunks per step, clean input, history size, lookahead capacity)
WIDE_RUNS = ((16000, 3, False, 100, 1), (16000, 4, False, 100, 1),
             (16000, 10, True, 100, 1), (8000, 5, False, 257, 4),
             (8000, 8, False, 100, 1))
WIDE_CHUNKS = 37


def phase_wide(torch, dev):
    """run_streams_fused at 4096 streams at each width of WIDE_RUNS over
    37 chunks (a tail each): the kernel path == the plain path, output and
    state, and exactly one frames launch and one ring launch per step."""
    from webrtc_aecm_tpu_torch import fused
    totals, worst = {}, 0.0
    for fs, cps, with_clean, history, cap in WIDE_RUNS:
        far, near, ms = desync_scene(B_FULL, WIDE_CHUNKS, 24, 5, 64, fs=fs)
        clean = clean_input(far) if with_clean else None
        st = reconfigured_fused(torch, dev, B_FULL, fs, history, cap)
        n_super, rem = divmod(WIDE_CHUNKS, cps)
        want = {"frames_step": n_super + (rem > 0),
                "ring_multi_pass": n_super + (rem > 1),
                "ring_pass": int(rem == 1), "ring_write": 0,
                "ring_gather": 0}
        res_k, launches = counted(torch, lambda: fused.run_streams_fused(
            st, far, near, fs, ms, use_kernel=True, clean=clean,
            chunks_per_step=cps))
        tag = (f"{fs // 1000} kHz, {cps} chunks a step"
               f"{', clean' if with_clean else ''}, H {history}, "
               f"capacity {cap}")
        if launches != want:
            fail(f"wide steps {tag}: launches {launches}, expected {want}")
        res_p = fused.run_streams_fused(st, far, near, fs, ms,
                                        use_kernel=False, clean=clean,
                                        chunks_per_step=cps)
        torch.cuda.synchronize()
        worst = max(worst, compare_trees(f"wide steps {tag}", res_k, res_p))
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  {tag}: kernel path == plain path at B={B_FULL} over "
            f"{WIDE_CHUNKS} chunks (output, every state leaf); launches "
            f"{want}")
    return totals, worst


ENVELOPE_CHUNKS, ENVELOPE_STEPS = 105, 20


def counted(torch, fn):
    """fn() with every kernel's launch counter set to 0 just before and
    read just after."""
    from webrtc_aecm_tpu_torch import fused_kernel
    from webrtc_aecm_tpu_torch.ops import ring_kernels as rk
    wrappers = {"frames_step": fused_kernel.frames_kernel_call,
                "ring_multi_pass": rk.ring_multi_pass,
                "ring_pass": rk.ring_pass, "ring_write": rk.ring_write,
                "ring_gather": rk.ring_read}
    for w in wrappers.values():
        w.launches = 0
    res = fn()
    torch.cuda.synchronize()
    return res, {k: w.launches for k, w in wrappers.items()}


def phase_envelope(torch, dev):
    """At 4096 streams, AecmPipeline("fused") == AecmPipeline("xla"), both
    on the card: run over 1.05 s (a tail of one chunk) and then 20 steps of
    10 ms, at 8 and 16 kHz, single and clean; output, warnings and state
    equal, and each engine's launches exactly one frames kernel per fused
    step, one ring_multi_pass per multi-chunk step, one ring_pass per 10 ms
    fused step, one ring_write and one ring_read per batch-major chunk."""
    from webrtc_aecm_tpu_torch.models import AecmPipeline
    totals, worst = {}, 0.0
    n_all = ENVELOPE_CHUNKS + ENVELOPE_STEPS
    for fs in (8000, 16000):
        chunk, cps = fs // 100, (4 if fs == 8000 else 2)
        far, near, ms = desync_scene(B_FULL, n_all, 60, 5, 64, fs=fs)
        dv = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        far, near, ms = dv(far).int(), dv(near).int(), dv(ms)
        for with_clean in (False, True):
            cl = dv(clean_input(far.cpu().numpy())).int() if with_clean \
                else None
            tag = f"{fs // 1000} kHz {'clean' if with_clean else 'single'}"
            span = slice(0, ENVELOPE_CHUNKS * chunk)
            n_super, rem = divmod(ENVELOPE_CHUNKS, cps)
            want = {
                "fused": {"frames_step": n_super + (rem > 0)
                          + ENVELOPE_STEPS,
                          "ring_multi_pass": n_super + (rem > 1),
                          "ring_pass": (rem == 1) + ENVELOPE_STEPS,
                          "ring_write": 0, "ring_gather": 0},
                "xla": {"frames_step": 0, "ring_multi_pass": 0,
                        "ring_pass": 0, "ring_write": n_all,
                        "ring_gather": n_all}}
            outs = {}
            for engine in ("fused", "xla"):
                pipe = AecmPipeline(B_FULL, fs, engine=engine, device=dev)

                def serve():
                    o = [pipe.run(far[:, span], near[:, span],
                                  None if cl is None else cl[:, span],
                                  ms[:ENVELOPE_CHUNKS])]
                    w = []
                    for c in range(ENVELOPE_CHUNKS, n_all):
                        s = slice(c * chunk, (c + 1) * chunk)
                        oc, wc = pipe.step(far[:, s], near[:, s],
                                           None if cl is None else cl[:, s],
                                           ms[c])
                        o.append(oc)
                        w.append(wc)
                    return torch.cat(o, 1), torch.stack(w)
                (out, warn), launches = counted(torch, serve)
                if launches != want[engine]:
                    fail(f"envelope {tag} {engine}: launches {launches}, "
                         f"expected {want[engine]}")
                for k, v in launches.items():
                    totals[k] = totals.get(k, 0) + v
                outs[engine] = (out, warn, pipe._canonical())
            if outs["fused"][0].shape != (B_FULL, n_all * chunk):
                fail(f"envelope {tag}: output shape "
                     f"{tuple(outs['fused'][0].shape)}")
            worst = max(worst, compare_trees(f"envelope {tag}, fused == xla",
                                             outs["fused"], outs["xla"]))
            log(f"  {tag}: fused == xla at B={B_FULL} over "
                f"{ENVELOPE_CHUNKS} chunks of run and {ENVELOPE_STEPS} steps "
                f"(output, warnings, every state leaf); launches "
                f"{want['fused']} and {want['xla']}")
    return totals, worst


# ---------------------------------------------------------------------------
# the outer surface: debug taps, CLI, ERLE battery, several devices, the
# long call (tests/data/torch_golden_surface.npz, from
# tools/make_torch_golden_surface.py)
# ---------------------------------------------------------------------------

def repo_tool(name):
    """tools/<name>.py as a module (numpy only at import)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def surface_golden(group):
    """The surface golden file's arrays whose key starts with `group`."""
    with np.load(os.path.join(REPO, "tests", "data",
                              "torch_golden_surface.npz")) as g:
        return {k: g[k] for k in g.files if k.startswith(group)}


DEBUG_ENTRIES = ("8k", "16k", "16k_clean")


def phase_debug(torch, dev):
    """AecmInstance(device="cuda").process(..., debug=True) call by call ==
    the JAX package's outputs, warnings and every tap (golden `dbg.*`), at
    8 kHz, 16 kHz and with a clean input; one ring_write and one ring_read
    launch per call."""
    from webrtc_aecm_tpu_torch import AecmInstance
    gen = repo_tool("make_torch_golden_surface")
    g = surface_golden("dbg.")
    totals, n_taps = {}, 0
    for name in DEBUG_ENTRIES:
        fs, calls = gen.DBG[name][:2]
        far, near, clean, ms = gen.dbg_inputs(name)
        n = fs // 100
        inst = AecmInstance(fs, device=dev)
        p = f"dbg.{name}"

        def serve():
            res = []
            for c in range(calls):
                cols = slice(c * n, (c + 1) * n)
                inst.buffer_farend(far[cols])
                res.append(inst.process(
                    near[cols], None if clean is None else clean[cols],
                    int(ms[c]), debug=True))
            return res
        res, launches = counted(torch, serve)
        want = {"frames_step": 0, "ring_multi_pass": 0, "ring_pass": 0,
                "ring_write": calls, "ring_gather": calls}
        if launches != want:
            fail(f"debug {name}: launches {launches}, expected {want}")
        for c, (out, warn, taps) in enumerate(res):
            if not np.array_equal(out, g[f"{p}.out"][c]) \
                    or warn != g[f"{p}.warn"][c]:
                fail(f"debug {name}: call {c} output or warning differs "
                     "from the JAX package's")
            for k, v in taps.items():
                ref = g[f"{p}.tap.{k}"][c]
                if v.dtype != ref.dtype or not np.array_equal(v, ref):
                    fail(f"debug {name}: call {c} tap {k} differs from the "
                         "JAX package's")
                n_taps += 1
        if res[-1][2]["delay_blocks"].max() <= 0:
            fail(f"debug {name}: no delay estimate")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  {name}: {calls} calls, outputs, warnings and taps == the "
            f"JAX package's; launches {launches}")
    return totals, n_taps


def phase_cli(torch, dev):
    """The CLI in-process on the card (single pairs with --erle
    --echo-mode 3 at 8 and 16 kHz, the --batch list, a float32 pair) ==
    the JAX CLI's output samples (golden `cli.*`), the frames and
    ring_multi_pass kernels launched; and `python -m
    webrtc_aecm_tpu_torch` in a subprocess: exit code 0 and the same
    file."""
    import tempfile
    from webrtc_aecm_tpu_torch.utils import cli, read_wav_int16, \
        write_wav_int16
    gen = repo_tool("make_torch_golden_surface")
    g = surface_golden("cli.")
    totals = {}

    def run_cli(argv):
        rc, launches = counted(torch, lambda: cli.main(argv))
        if rc != 0:
            fail(f"cli {argv}: exit code {rc}")
        if launches["frames_step"] <= 0 or launches["ring_multi_pass"] <= 0:
            fail(f"cli {argv}: launches {launches}: the fused kernels did "
                 "not run")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    def same(path, key):
        out, _ = read_wav_int16(path)
        if not np.array_equal(out, g[key]):
            fail(f"cli: {os.path.basename(path)} differs from the JAX "
                 f"CLI's ({key})")

    with tempfile.TemporaryDirectory() as tmp:
        def at(name):
            return os.path.join(tmp, name)
        for name in gen.CLI:
            far, near, fs = gen.cli_pair(name)
            write_wav_int16(at(f"far_{name}.wav"), far, fs)
            write_wav_int16(at(f"near_{name}.wav"), near, fs)
            run_cli([at(f"far_{name}.wav"), at(f"near_{name}.wav")]
                    + gen.CLI_FLAGS)
            same(at(f"near_{name}_out.wav"), f"cli.{name}.out")
        pairs, fs = gen.cli_batch_pairs()
        lines = []
        for k, (far, near) in enumerate(pairs):
            write_wav_int16(at(f"far{k}.wav"), far, fs)
            write_wav_int16(at(f"near{k}.wav"), near, fs)
            lines.append(f"{at(f'far{k}.wav')} {at(f'near{k}.wav')}")
        with open(at("list.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        run_cli(["--batch", at("list.txt"), "--erle"])
        for k in range(len(pairs)):
            same(at(f"near{k}_out.wav"), f"cli.batch{k}.out")
        far, near, fs = gen.cli_float_pair()
        gen.write_raw_wav(at("far_f32.wav"), 3, 32,
                          gen.to_float32(far).tobytes(), rate=fs)
        gen.write_raw_wav(at("near_f32.wav"), 3, 32,
                          gen.to_float32(near).tobytes(), rate=fs)
        run_cli([at("far_f32.wav"), at("near_f32.wav")])
        same(at("near_f32_out.wav"), "cli.f32.out")
        # python -m, on the default device (the card)
        os.remove(at("near_8k_out.wav"))
        r = subprocess.run(
            [sys.executable, "-m", "webrtc_aecm_tpu_torch",
             at("far_8k.wav"), at("near_8k.wav")] + gen.CLI_FLAGS,
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=REPO))
        if r.returncode != 0:
            fail(f"python -m webrtc_aecm_tpu_torch: exit code "
                 f"{r.returncode}\n{r.stderr[-2000:]}")
        same(at("near_8k_out.wav"), "cli.8k.out")
        log(f"  python -m webrtc_aecm_tpu_torch: exit 0, "
            f"{r.stdout.strip().splitlines()[0]}")
    return totals


def phase_erle(torch, dev):
    """tools/erle_report_torch.py's battery on the card: all 10 scenes
    bit-exact with the JAX package (golden `erle.*`), the scene generator's
    hashes too; ERLE per scene."""
    tool = repo_tool("erle_report_torch")
    g = surface_golden("erle.")
    erle, totals = {}, {}
    for _, scenes in tool.GROUPS:
        res, launches = counted(torch, lambda: tool.run(
            [s[0] for s in scenes], dev))
        if launches["frames_step"] <= 0:
            fail(f"erle: the frames kernel did not run ({launches})")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        for name, r in res.items():
            c = tool.check(name, *r, g)
            if not (c["bit_exact"] and c["scene_matches"]):
                fail(f"erle {name}: {c}")
            erle[name] = c["erle_db"]
            log(f"  {name}: ERLE {c['erle_db']:.3f} dB (JAX "
                f"{c['erle_jax_db']:.3f}), bit-exact")
    return erle, totals


MESH_B = 1024


def phase_mesh(torch, dev):
    """AecmPipeline on a mesh [cuda:0] and [cuda:0, cuda:0] (and over two
    cards when there are two) == without a mesh: both engines, run (with a
    tail) then 10 ms steps, 8 and 16 kHz, the desync scene (streams that
    differ); outputs, warnings and the gathered state equal, and the
    two-shard mesh launches exactly twice what the one-shard mesh does."""
    from webrtc_aecm_tpu_torch.models import AecmPipeline
    from webrtc_aecm_tpu_torch.parallel import make_mesh
    n_cards = torch.cuda.device_count()
    log(f"  torch.cuda.device_count() = {n_cards}")
    meshes = {"[cuda:0]": [dev], "[cuda:0, cuda:0]": [dev, dev]}
    if n_cards > 1:
        meshes["[cuda:0, cuda:1]"] = [torch.device("cuda", 0),
                                      torch.device("cuda", 1)]
    per_step, worst = {}, 0.0
    for fs in (8000, 16000):
        chunk, cps = fs // 100, (4 if fs == 8000 else 2)
        n_run, n_steps = 2 * cps + 1, 3
        far, near, ms = desync_scene(MESH_B, n_run + n_steps, 2, 5, 64,
                                     fs=fs)
        for engine in ("fused", "xla"):
            results = {}
            for label, devices in [("none", None)] + list(meshes.items()):
                mesh = None if devices is None else make_mesh(devices)
                pipe = AecmPipeline(MESH_B, fs, engine=engine, device=dev,
                                    mesh=mesh)

                def run():
                    return pipe.run(far[:, :n_run * chunk],
                                    near[:, :n_run * chunk], None,
                                    ms[:n_run])

                def steps():
                    o, w = [], []
                    for c in range(n_run, n_run + n_steps):
                        s = slice(c * chunk, (c + 1) * chunk)
                        oc, wc = pipe.step(far[:, s], near[:, s], None,
                                           ms[c])
                        o.append(oc)
                        w.append(wc)
                    return torch.cat(o, 1), torch.stack(w)
                out_r, l_run = counted(torch, run)
                (out_s, warn), l_step = counted(torch, steps)
                results[label] = ((torch.cat([out_r, out_s], 1), warn,
                                   pipe._canonical()), l_run, l_step)
            ref = results["none"][0]
            tag = f"{fs // 1000} kHz {engine}"
            for label in meshes:
                worst = max(worst, compare_trees(
                    f"mesh {label} {tag} == no mesh", results[label][0],
                    ref))
            one, two = results["[cuda:0]"], results["[cuda:0, cuda:0]"]
            for i, what in ((1, "run"), (2, "step")):
                doubled = {k: 2 * v for k, v in one[i].items()}
                if two[i] != doubled or one[i] != results["none"][i]:
                    fail(f"mesh {tag} {what}: launches {two[i]} on two "
                         f"shards, {one[i]} on one, {results['none'][i]} "
                         "without a mesh")
            per_step[tag] = {k: v / n_steps for k, v in one[2].items()
                             if v}
            log(f"  {tag}: meshes {', '.join(meshes)} == no mesh at "
                f"B={MESH_B} (output, warnings, state); launches run "
                f"{one[1]} -> {two[1]}, {n_steps} steps {one[2]} -> "
                f"{two[2]} (one shard -> two)")
    return per_step, worst


def phase_long_call(torch, dev):
    """The state bytes of create_batch and create_fused on the card are
    exactly linear in the streams (1 and 1000) and under 128 KiB a stream;
    tests/test_long_call.py's drift sequence on the card == the JAX
    package's (golden `long.*`: each segment's output hash, the final
    state)."""
    import hashlib
    from webrtc_aecm_tpu_torch import convert, fused
    from webrtc_aecm_tpu_torch._tree import tree_leaves
    from webrtc_aecm_tpu_torch.models import AecmPipeline
    from webrtc_aecm_tpu_torch.parallel import create_batch
    gen = repo_tool("make_torch_golden_surface")
    g = surface_golden("long.")

    def nbytes(state):
        return sum(x.numel() * x.element_size() for x in tree_leaves(state))
    sizes = {}
    for create in (create_batch, fused.create_fused):
        one = nbytes(create(1, 16000, device=dev))
        thousand = nbytes(create(1000, 16000, device=dev))
        if thousand != 1000 * one or one >= 128 * 1024:
            fail(f"long call: {create.__name__} state {one} bytes a stream, "
                 f"{thousand} for 1000")
        sizes[create.__name__] = one
    pipe = AecmPipeline(2, gen.LONG_FS, device=dev)
    base = nbytes(pipe.state)
    totals = {}
    for k, (far, near, ms) in enumerate(gen.long_segments()):
        out, launches = counted(torch, lambda: pipe.run(
            far, near, ms_in_sndcard_buf=ms).cpu().numpy())
        for name, v in launches.items():
            totals[name] = totals.get(name, 0) + v
        if nbytes(pipe.state) != base:
            fail("long call: the state grew")
        if hashlib.sha256(out.astype("<i2").tobytes()).hexdigest() != \
                str(g["long.seg_sha"][k]):
            fail(f"long call: segment {k} differs from the JAX package's")
    if totals["frames_step"] <= 0:
        fail(f"long call: the frames kernel did not run ({totals})")
    n = golden_state_check("long call", convert.aecm_state_to_numpy(
        pipe._canonical()), g, "long.state.")
    return sizes, n, pipe.engine, totals


def realtime_step_ms(torch, dev, engine, fs, n_warm=30, n_timed=50):
    """Wall ms per 10 ms chunk of AecmPipeline.step at 4096 streams (CUDA
    events around n_timed steps after n_warm; the desync scene without its
    delay burst or its per-stream offsets)."""
    from webrtc_aecm_tpu_torch.models import AecmPipeline
    chunk = fs // 100
    far, near, _ = desync_scene(B_FULL, n_warm + n_timed, 10 ** 6, 0, 1,
                                fs=fs)
    far = torch.as_tensor(far, device=dev).int()
    near = torch.as_tensor(near, device=dev).int()
    pipe = AecmPipeline(B_FULL, fs, engine=engine, device=dev)
    cols = lambda c: slice(c * chunk, (c + 1) * chunk)  # noqa: E731
    for c in range(n_warm):
        pipe.step(far[:, cols(c)], near[:, cols(c)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for c in range(n_warm, n_warm + n_timed):
        pipe.step(far[:, cols(c)], near[:, cols(c)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n_timed


def phase_kernels(torch, dev):
    from webrtc_aecm_tpu_torch import fused
    from webrtc_aecm_tpu_torch.ops import ring_buffer, ring_kernels
    worst = {"frames": 0.0, "ring": 0.0, "ring_pass": 0.0, "gather": 0.0,
             "write": 0.0}
    rng = np.random.default_rng(1)
    for n in (80, 160):
        ring, values, gate = ring_io_case(torch, dev, B_FULL, n, rng)
        free = ring_buffer.available_write(ring_buffer.RingBuffer(*ring))
        readable = ring_buffer.available_read(ring_buffer.RingBuffer(*ring))
        margin = 4000 - ring[2]
        seen = {"full": free == 0, "clamped": (free > 0) & (free < n),
                "exactly the margin": (free >= n) & (margin == n),
                "wrapping": (free >= n) & (margin < n),
                "short of a frame": readable < 80, "empty": readable == 0,
                "read position at the capacity": ring[1] == 4000,
                "write position at the capacity": ring[2] == 4000}
        missing = [k for k, v in seen.items() if not bool(v.any())]
        if missing:
            fail(f"ring case n={n} lacks: {missing}")
        ref = ring_buffer.write_plain(*ring, values)
        wide = torch.cat([values, values, values], dim=1)  # strided rows
        for vals in (values, wide[:, n:2 * n]):
            got = ring_kernels.ring_write(ring[0].clone(), *ring[1:], vals)
            torch.cuda.synchronize()
            worst["write"] = max(worst["write"], compare_trees(
                f"ring_write n={n}", got, ref))
        for n_frames in (1, 2):
            for g in (gate, None):
                for whole in (True, False):
                    ref = ring_buffer.read_frames_plain(
                        *ring, g, 80, n_frames, whole)
                    got = ring_kernels.ring_read(*ring, g, 80, n_frames,
                                                 whole)
                    torch.cuda.synchronize()
                    worst["gather"] = max(worst["gather"], compare_trees(
                        f"ring_read n_frames={n_frames} gate="
                        f"{g is not None} whole_frames={whole}", got, ref))
        log(f"  ring_write (n={n}; ring, write_pos, rw_wrap) and ring_read "
            "(1 and 2 frames; frames, have_data, read_pos, rw_wrap) == "
            "plain: " + ", ".join(seen) + ", gates false "
            "on a quarter of the streams, values outside int16, strided "
            "value rows")
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
            key = "ring_pass" if cps == 1 else "ring"
            worst[key] = max(worst[key], compare_trees(
                f"ring kernel cps={cps} clamped={frac}", got, ref))
            log(f"  ring kernel == plain: cps={cps}, clamped share {frac}")

    # frames kernel, every mode: warm steps on the plain path, then steps
    # through the kernels, each launch checked against the plain version;
    # the last captured call again at 4099 streams (a ragged last block)
    captures = {}
    for name, fs, cps, with_clean, absa, history, la_cap in FRAMES_MODES:
        n_warm = 20 if name == "16k circular" else -(-24 // cps)
        cap = capture_mode(torch, dev, fs, cps, with_clean, absa, B_FULL,
                           n_warm, 3 if name == "16k circular" else 2,
                           history, la_cap)
        captures[name] = cap
        for k in ("frames", "ring", "ring_pass"):
            worst[k] = max(worst[k], cap.worst[k])
        worst["frames"] = max(worst["frames"], frames_widened_check(
            torch, cap.frames_args, B_FULL + 3, name))
        log(f"  frames kernel == plain, {name}: the kernel path's steps at "
            f"B={B_FULL} and the last one again at B={B_FULL + 3} (outputs, "
            "pending blocks, every core leaf); ring kernels == plain")
    main = captures["16k circular"]
    for b, head in ((B_FULL, 95), (B_FULL + 3, 90)):
        worst["frames"] = max(worst["frames"], frames_planted_check(
            torch, dev, main.frames_args, b, head, "16k circular"))
    for name in ("8k 3 slots clean", "8k 3 slots clean, H 257 lookahead 4"):
        for b in (B_FULL, B_FULL + 3):
            worst["frames"] = max(worst["frames"], frames_planted_check(
                torch, dev, captures[name].frames_args, b, None, name))
    name = "16k circular, H 257 lookahead 4"
    for b, head in ((B_FULL, 95), (B_FULL + 3, 90)):
        worst["frames"] = max(worst["frames"], frames_planted_check(
            torch, dev, captures[name].frames_args, b, head, name))
    return worst, captures


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
    ring_kernels.ring_read.launches = 0
    fin, out = run_batch(torch, dev, far, near, fs, ms, clean)
    return fin, out, {"ring_write": ring_kernels.ring_write.launches,
                      "ring_read": ring_kernels.ring_read.launches}


def phase_main_batch(torch, dev, fused_ref):
    from webrtc_aecm_tpu_torch import fused
    far, near, ms = desync_scene(B_FULL, 100, 60, 5, 64)
    fin_k, out_k, launches = counted_batch_run(torch, dev, far, near, FS, ms)
    if launches != {"ring_write": 100, "ring_read": 100}:
        fail(f"batch main path launches {launches}, expected 100 writes "
             "and 100 reads (one of each per chunk)")
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
    if launches != {"ring_write": 50, "ring_read": 50}:
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
    block slots fetch, the step's inputs and outputs; with the newest-first
    history the whole history read and written once more (the merge, 32.8
    KB a stream), and in the general instance its pending blocks written
    and read back; with the circular one the pending blocks written."""
    from webrtc_aecm_tpu_torch import fused, fused_kernel
    core = rest[0]
    history, cap = fused_kernel.core_shape(core)
    state = 0
    for path, shape, dtype in fused_kernel._leaf_layout(1, history, cap):
        if path not in ("far_history", "far_q_domains"):
            state += shape[0] * dtype.itemsize
    far, noisy, clean, phase, run_rows = rest[2:7]
    n_frames, head = rest[8], rest[12]
    n_slots = fused._n_slots_for(n_frames)
    ins = sum(x.shape[0] for x in (far, noisy, clean, phase, run_rows)
              if x is not None) * 4
    history_bytes = n_slots * (40 + 1) * 4
    if head is None:
        history_bytes += 2 * 100 * (40 + 1) * 4
        if fused_kernel.general_instance(history, cap, n_frames, False):
            history_bytes += 2 * n_slots * (40 + 1) * 4
    outs = (far.shape[0] + (n_slots * 41 if head is not None else 0)) * 4
    return (2 * state + ins + history_bytes + outs) * b


def frames_ops(torch, rest):
    """Integer operations of one frames_step call on these inputs: the
    counts of FRAMES_OPS times what a plain run of the call shows its data
    to need (active and inactive blocks, and per active block the
    data-dependent paths).  Returns (operations, {what: how many})."""
    from webrtc_aecm_tpu_torch import fused, fused_kernel
    core, run_rows, mult, n_frames = rest[0], rest[6], rest[7], rest[8]
    has_clean, abs_approx, head = rest[9], rest[10], rest[12]
    history, la_cap = fused_kernel.core_shape(core)
    with PlainProbe(torch, core, run_rows) as probe:
        fused.frames_step(fused.clone_state(core), *rest[1:])
    b = run_rows.shape[1]
    n = {k: int(v) for k, v in probe.count.items()}
    active = n["active block"]
    inactive = (fused._n_slots_for(n_frames) * b - active
                if head is not None else 0)
    act_of = lambda leaf: int(sum(  # noqa: E731
        (a & (leaf[0] != 0)).sum() for a in probe.act))
    resets = 0
    if fused_kernel.general_instance(history, la_cap, n_frames,
                                     head is not None):
        n_act = sum(a.long() for a in probe.act)
        resets = int(((n_act - 1).clamp(min=0) // 5).sum())
    times = {
        "active block": active,
        "delay search row": active * history,
        "mean_bit_counts row updated": n.get("mean_bit_counts row updated",
                                             0),
        "histogram entry updated": n.get("histogram updated", 0)
        * (history + 1),
        "lookahead shift and select": active if la_cap > 1 else 0,
        "window reset row": resets * (2 * history + 3 * 64 + la_cap),
        "NLMS": n.get("NLMS", 0),
        "hnl squared": active if mult == 2 else 0,
        "NLP": act_of(core.nlp_flag),
        "comfort noise": act_of(core.cng_mode),
        "clean transform": active if has_clean else 0,
        "abs_approx magnitudes": ((2 + has_clean) * active + inactive
                                  if abs_approx else 0),
        "inactive slot": inactive,
        "frame": n_frames * b,
        "step": b}
    return sum(times[k] * ops for k, (ops, _) in FRAMES_OPS.items()), times


def int32_ops_per_s(torch):
    """The card's peak int32 rate outside the tensor cores: SMs x 64 lanes
    x the highest SM clock nvidia-smi reports."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6, sms, mhz


def ring_pass_bytes(wpos, n_write, n_read):
    """Bytes of a ring pass: the written samples' values in and ring
    slots out, the gathered samples read and written, the positions."""
    cps, b = wpos.shape
    written = int(n_write.clamp(min=0, max=n_read).sum())
    return written * (4 + 2) + cps * b * n_read * (2 + 4) + 3 * cps * b * 4


def frames_sizes(torch, capture):
    """The frames kernel at 1024, 4096 and 16384 streams (the captured call
    repeated along the stream axis): ms per launch by CUDA events, the
    wrapper's host us, the kernel's device ms."""
    from webrtc_aecm_tpu_torch import fused_kernel
    sizes = {}
    for b_n in (1024, B_FULL, 16384):
        args_n = widen_frames_args(torch, capture.frames_args, b_n)
        fn_n = lambda: fused_kernel.frames_kernel_call(*args_n)  # noqa: E731
        sizes[b_n] = dict(ms=cuda_ms(fn_n, 10),
                          host_us=host_us(torch, fn_n, 100),
                          device_ms=device_ms(torch, fn_n, 5,
                                              "frames_step_kernel"))
    return sizes


def log_frames_modes(modes, card):
    for name, r in modes.items():
        dev_ms = ("not measured" if r["device_ms"] is None
                  else f"{r['device_ms']:.4f} ms")
        log(f"[timing] frames_step, {name}, B={B_FULL}: {r['ms']:.4f} ms per "
            f"launch (device {dev_ms}), bound {r['bound_ms']:.5f} ms "
            f"({r['ops_per_stream']:.0f} operations a stream: "
            f"{r['ops_ms']:.5f} ms; bytes {r['bytes_ms']:.5f} ms) on {card}")


def log_frames_sizes(sizes, card):
    for b_n, r in sizes.items():
        dev_ms = ("not measured" if r["device_ms"] is None
                  else f"{r['device_ms']:.4f} ms")
        log(f"[timing] frames_step at B={b_n}: {r['ms']:.4f} ms per launch "
            f"(host {r['host_us']:.2f} us, device {dev_ms}) on {card}")


def frames_mode_times(torch, captures):
    """Each frames kernel mode at 4096 streams, on its captured call: ms by
    CUDA events, device ms by the profiler, the operations and bytes
    bounds."""
    from webrtc_aecm_tpu_torch import fused, fused_kernel
    peak_ops, _, _ = int32_ops_per_s(torch)
    out = {}
    for name, cap in captures.items():
        core, t, *rest = cap.frames_args
        work = fused.clone_state(core)
        fn = lambda: fused_kernel.frames_kernel_call(  # noqa: E731
            work, t, *rest)
        n_ops, _ = frames_ops(torch, [core, t] + rest)
        bytes_ms = bound_ms(frames_bytes([core, t] + rest, B_FULL))
        ops_ms = n_ops / peak_ops * 1e3
        out[name] = dict(ms=cuda_ms(fn, 10),
                         device_ms=device_ms(torch, fn, 5,
                                             "frames_step_kernel"),
                         bound_ms=max(bytes_ms, ops_ms), ops_ms=ops_ms,
                         bytes_ms=bytes_ms, ops_per_stream=n_ops / B_FULL)
    return out


def phase_timing(torch, dev, captures, batch_state):
    from webrtc_aecm_tpu_torch import fused, fused_kernel
    from webrtc_aecm_tpu_torch.ops import ring_buffer, ring_kernels
    capture = captures["16k circular"]
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
    # 8 kHz, 1 s of the desync scene without its burst, both engines'
    # kernel paths
    f8, n8, _ = desync_scene(B_FULL, 100, 10 ** 6, 5, 64, fs=8000)
    f8 = torch.as_tensor(f8, device=dev).int()
    n8 = torch.as_tensor(n8, device=dev).int()
    st8 = fused.create_fused(B_FULL, 8000, device=dev)
    fused.run_streams_fused(st8, f8, n8, 8000, 40)             # warm-up
    rates["fused kernel, 8 kHz"] = engine_rate(
        torch, lambda: fused.run_streams_fused(st8, f8, n8, 8000, 40), 1.0)
    rates["batch-major kernel, 8 kHz"] = engine_rate(
        torch, lambda: run_batch(torch, dev, f8, n8, 8000, 40), 1.0)
    # the real-time step: wall ms per 10 ms chunk of AecmPipeline.step
    realtime = {(engine, fs): realtime_step_ms(
        torch, dev, engine, fs, *((30, 50) if engine == "fused" else (10, 20)))
        for fs in (8000, 16000) for engine in ("fused", "xla")}

    # per-launch times at the main paths' shapes
    per = {}
    core, t, *rest = capture.frames_args
    work = fused.clone_state(core)
    frames = lambda: fused_kernel.frames_kernel_call(work, t, *rest)  # noqa: E731
    peak_ops, sms, mhz = int32_ops_per_s(torch)
    n_ops, op_times = frames_ops(torch, [core, t] + rest)
    bytes_ms = bound_ms(frames_bytes([core, t] + rest, B_FULL))
    ops_ms = n_ops / peak_ops * 1e3
    per["frames_step"] = dict(
        ms=cuda_ms(frames, 10),
        plain_ms=cuda_ms(lambda: fused.frames_step(core, t, *rest), 3),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="operations" if ops_ms > bytes_ms else "bytes",
        bytes_ms=bytes_ms, ops_ms=ops_ms, ops_per_stream=n_ops / B_FULL,
        op_times=op_times,
        peak=f"{sms} SMs x {INT32_LANES_PER_SM} int32 lanes x {mhz:.0f} MHz",
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

    # the batch-major write and read on the main path's final jitter rings,
    # at the 16 kHz chunk's shapes: 160 samples written, 2 frames read
    fb = batch_state.farend_buf
    ring = tuple(x.contiguous() for x in fb)
    b, cap = ring[0].shape
    rng = np.random.default_rng(2)
    vals = torch.as_tensor(rng.integers(-32768, 32768, (b, CHUNK)),
                           dtype=torch.int32, device=dev)
    gate = (batch_state.ec_startup == 0).contiguous()
    n_fr = CHUNK // 80
    ring_w = ring[0].clone()

    write = lambda: ring_kernels.ring_write(  # noqa: E731
        ring_w, *ring[1:], vals)
    read = lambda: ring_kernels.ring_read(  # noqa: E731
        *ring, gate, 80, n_fr)

    # library yardsticks on precomputed indices: one index_put_ for the
    # write, one torch.gather per frame for the read
    n_w = ring_buffer.available_write(fb).clamp(max=CHUNK)
    j = torch.arange(CHUNK, device=dev)
    valid = j[None, :] < n_w[:, None]
    flat_idx = ((ring[2][:, None].long() + j) % cap
                + torch.arange(b, device=dev)[:, None] * cap)[valid]
    vals16 = vals.to(torch.int16)[valid]
    written = int(n_w.sum())
    library_write = lambda: ring_w.view(-1).index_put_(  # noqa: E731
        (flat_idx,), vals16)
    idx, walk, samples_read = [], ring_buffer.RingBuffer(*ring), 0
    for _ in range(n_fr):
        idx.append((walk.read_pos[:, None].long()
                    + torch.arange(80, device=dev)) % cap)
        samples_read += int(
            ring_buffer.available_read(walk).clamp(0, 80).sum())
        _, _, rp_f, rw_f = ring_buffer.read_frames_plain(*walk, gate, 80, 1)
        walk = walk._replace(read_pos=rp_f, rw_wrap=rw_f)
    library_read = lambda: [torch.gather(ring[0], 1, ix)  # noqa: E731
                            for ix in idx]
    per["ring_write"] = dict(
        ms=cuda_ms(write, 100),
        plain_ms=cuda_ms(lambda: ring_buffer.write_plain(*ring, vals), 20),
        bound_ms=bound_ms(written * (4 + 2) + (3 + 2) * b * 4),
        library_ms=cuda_ms(library_write, 100))
    per["ring_gather"] = dict(
        ms=cuda_ms(read, 100),
        plain_ms=cuda_ms(lambda: ring_buffer.read_frames_plain(
            *ring, gate, 80, n_fr), 20),
        bound_ms=bound_ms(samples_read * 2 + b * n_fr * (80 * 4 + 1)
                          + (3 + 2) * b * 4 + b),
        library_ms=cuda_ms(library_read, 100))

    # the launch floor: an empty kernel through the same binding
    from webrtc_aecm_tpu_torch import _build
    noop = lambda: _build.launch("aecm_noop", dev.index)  # noqa: E731
    floor = dict(ms=cuda_ms(noop, 100))

    # each wrapper's host time alone, and what the parts of a wrapper's
    # host path cost beside the launch itself
    host = {name: host_us(torch, fn) for name, fn in (
        ("aecm_noop", noop), ("ring_write", write), ("ring_gather", read),
        ("ring_multi_pass", multi), ("ring_pass", single),
        ("library ring_write", library_write),
        ("library ring_gather", library_read))}
    host["frames_step"] = host_us(torch, frames, 10)
    pieces = {name: host_us(torch, fn) for name, fn in (
        ("a Stream object's handle",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("the raw stream handle",
         lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
        ("_build.require of one tensor", lambda: _build.require(
            ring[2], "write_pos", torch.int32, (b,), dev)),
        ("torch.empty((B, 2, 80))", lambda: torch.empty(
            (b, 2, 80), dtype=torch.int32, device=dev)),
        ("torch.empty_like((B,))", lambda: torch.empty_like(ring[2])))}

    # the profiler last, so that no CUDA-event time above runs beside it:
    # each kernel's device time alone, and where a batch-major 10 ms chunk
    # goes (its device work over a few ChunkSteps, beside the unprofiled
    # wall time per chunk)
    for name, fn, n, symbol in (
            ("frames_step", frames, 5, "frames_step_kernel"),
            ("ring_multi_pass", multi, 20, "ring_multi_pass_kernel"),
            ("ring_pass", single, 20, "ring_multi_pass_kernel"),
            ("ring_gather", read, 20, "ring_read_kernel"),
            ("ring_write", write, 20, "ring_write_kernel")):
        per[name]["device_ms"] = device_ms(torch, fn, n, symbol)
        per[name]["host_us"] = host[name]
    per["frames_step"]["sizes"] = frames_sizes(torch, capture)
    for name, fn in (("ring_gather", library_read),
                     ("ring_write", library_write)):
        per[name]["library_device_ms"] = device_ms(torch, fn, 20)
        per[name]["library_host_us"] = host["library " + name]
    floor.update(device_ms=device_ms(torch, noop, 20, "noop_kernel"),
                 host_us=host["aecm_noop"])
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
    modes = frames_mode_times(torch, captures)
    return rates, per, chunk_profile, dict(floor=floor, pieces=pieces,
                                           realtime=realtime, modes=modes)


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
        worst, captures = phase_kernels(torch, dev)
        log(f"[kernels] bit-exact at B={B_FULL} "
            f"({time.perf_counter() - t:.2f} s)")
        if "--frames" in sys.argv[1:]:
            log_frames_sizes(frames_sizes(torch, captures["16k circular"]),
                             card)
            log_frames_modes(frames_mode_times(torch, captures), card)
            log(f"[total] {time.perf_counter() - t_all:.1f} s")
            return 0

        t = time.perf_counter()
        n_leaves = phase_golden(torch, dev)
        log(f"[golden] outputs and {n_leaves} state leaves == the JAX "
            f"package's ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        n_env, n_leaves, n_fr = phase_golden_envelope(torch, dev)
        log(f"[golden envelope] {n_env} entries of torch_golden_envelope.npz "
            f"out of the kernel path ({n_fr} frames kernel launches), "
            f"outputs and {n_leaves} state leaves == the JAX package's "
            f"({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        n_rc, n_leaves, n_fr = phase_golden_reconfig(torch, dev)
        log(f"[golden reconfig] {n_rc} entries of torch_golden_reconfig.npz "
            f"on the card ({n_fr} frames kernel launches), outputs and "
            f"{n_leaves} state leaves == the JAX package's "
            f"({time.perf_counter() - t:.2f} s)")

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
        launches_env, worst_env = phase_envelope(torch, dev)
        log(f"[envelope] B={B_FULL}: AecmPipeline fused == xla at 8 and 16 "
            f"kHz, single and clean; launches {launches_env} "
            f"({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        launches_wide, worst_wide = phase_wide(torch, dev)
        log(f"[wide steps] B={B_FULL}: kernel path == plain path at 3 to 10 "
            f"chunks a step; launches {launches_wide} "
            f"({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        launches_dbg, n_taps = phase_debug(torch, dev)
        log(f"[debug] AecmInstance(device=cuda).process(debug=True) at 8 "
            f"and 16 kHz and clean: outputs, warnings and {n_taps} taps == "
            f"the JAX package's; launches {launches_dbg} "
            f"({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        launches_cli = phase_cli(torch, dev)
        log(f"[cli] single, --batch and float32 pairs and python -m "
            f"webrtc_aecm_tpu_torch == the JAX CLI's outputs; launches "
            f"{launches_cli} ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        erle, launches_erle = phase_erle(torch, dev)
        log(f"[erle] {len(erle)} scenes bit-exact with the JAX package, "
            f"ERLE {min(erle.values()):.3f} to {max(erle.values()):.3f} dB; "
            f"launches {launches_erle} ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        mesh_steps, worst_mesh = phase_mesh(torch, dev)
        log(f"[mesh] B={MESH_B}: mesh == no mesh, launches per 10 ms step "
            f"on one shard {mesh_steps}, exactly twice on two "
            f"({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        sizes, n_leaves, engine, launches_long = phase_long_call(torch, dev)
        log(f"[long_call] state bytes a stream {sizes} (linear in streams); "
            f"drift sequence on the {engine} engine: 5 segments and "
            f"{n_leaves} state leaves == the JAX package's; launches "
            f"{launches_long} ({time.perf_counter() - t:.2f} s)")

        t = time.perf_counter()
        rates, per, prof, extra = phase_timing(torch, dev, captures,
                                               batch_state)
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
        floor = extra["floor"]
        log(f"[timing] launch floor aecm_noop (an empty kernel through the "
            f"same binding): {floor['ms']:.4f} ms per launch (host "
            f"{floor['host_us']:.2f} us, device "
            f"{ms_or(floor['device_ms'])}) on {card}")
        for name, r in per.items():
            lib = ("none" if r["library_ms"] is None else
                   f"{r['library_ms']:.4f} ms (host "
                   f"{r['library_host_us']:.2f} us, device "
                   f"{ms_or(r['library_device_ms'])})")
            log(f"[timing] {name}: {r['ms']:.4f} ms per launch (host "
                f"{r['host_us']:.2f} us, device {ms_or(r['device_ms'])}), "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} "
                f"ms, library call {lib} (B={B_FULL}) on {card}")
        fr = per["frames_step"]
        log(f"[timing] frames_step bound: {fr['ops_per_stream']:.0f} integer "
            f"operations per stream and step over {fr['peak']} = "
            f"{fr['ops_ms']:.5f} ms; bytes {fr['bytes_ms']:.5f} ms; bound by "
            f"{fr['bound_by']}")
        for what, (ops, how) in FRAMES_OPS.items():
            log(f"[timing]   {fr['op_times'][what]} x {ops}: {what} ({how})")
        log_frames_sizes(fr["sizes"], card)
        log_frames_modes(extra["modes"], card)
        for (engine, fs), ms_c in extra["realtime"].items():
            log(f"[timing] real-time step, {engine} engine, {fs // 1000} kHz, "
                f"B={B_FULL}: {ms_c:.3f} ms of wall per 10 ms chunk (deadline "
                f"10 ms: {'met' if ms_c <= 10 else 'missed'}) on {card}")
        for name, us in extra["pieces"].items():
            log(f"[timing] host path, {name}: {us:.2f} us per call")
        log(f"[timing] ({time.perf_counter() - t:.2f} s)")
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        fail("a phase raised")

    path_err = {"frames_step": max(worst["frames"], worst_m, worst_env,
                                   worst_wide, worst_mesh),
                "ring_multi_pass": max(worst["ring"], worst_m, worst_wide,
                                       worst_mesh),
                "ring_pass": max(worst["ring_pass"], worst_env, worst_wide,
                                 worst_mesh),
                "ring_gather": max(worst["gather"], worst_b, worst_8k,
                                   worst_mesh),
                "ring_write": max(worst["write"], worst_b, worst_8k,
                                  worst_mesh)}
    # the main paths' counts: the fused 16 kHz run (phase main), the 10 ms
    # fused steps and tails of the envelope phase, the batch-major run
    counts = {"frames_step": launches["frames"],
              "ring_multi_pass": launches["ring"],
              "ring_pass": launches_env["ring_pass"],
              "ring_gather": launches_b["ring_read"],
              "ring_write": launches_b["ring_write"]}
    where = {"frames_step": ("frames.cu", "webrtc_aecm_tpu/fused.py:1595"),
             "ring_multi_pass": ("ring.cu",
                                 "webrtc_aecm_tpu/ops/pallas_ring.py:306"),
             "ring_pass": ("ring.cu",
                           "webrtc_aecm_tpu/ops/pallas_ring.py:169"),
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
            "bound_by": r.get("bound_by", "bytes"),
            "library_ms": r["library_ms"]})
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
