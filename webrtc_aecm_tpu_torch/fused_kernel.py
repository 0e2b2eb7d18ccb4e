"""The frames kernel: CUDA wrapper around csrc/frames.cuh.

Replaces the TPU kernel `_frames_kernel_call` (webrtc_aecm_tpu/fused.py:
1595, pallas_call at :1708, body `frames_step` :1283 -> `_process_block_f`
:1037): the whole AECM core for one serving step of n_frames frames, in
each of its modes: any number of frames, a single or a clean near input,
`abs_approx`, a delay estimator of any history size and lookahead capacity
(read off the leaf shapes, as the TPU kernel reads them), and the far
history circular (whole-block steps dividing the history; the new blocks
come out for the caller to append) or newest-first (merged in place, as
the TPU kernel's aliases do).  Unlike the TPU kernel it also draws the
comfort-noise phases (each lane its own, from the LCG's affine-closure
tables) and advances the CNG seed, which the JAX package does ahead of its
kernel.  The plain version is fused.frames_step_cng.

What bounds it on the card: integer operations (three 128-point
fixed-point FFTs, four with a clean input, the history-size delay search
and the 65-bin NLMS / Wiener / comfort-noise stages per block: about 0.24
M integer operations per stream and 5-slot step against 22 KB moved, 55 KB
with the newest-first history merge), not bytes.

Design: one warp per stream, 8 streams per thread block (4 with a clean
input, whose state takes 2 KB more a stream).  The block stages its
streams' state (every leaf the step reads but the far history) in shared
memory once, cooperatively, so that the lane-major (rows, B) layout of the
JAX package gives 32 contiguous bytes per row; the warp then runs the
step's block schedule on shared memory with its lanes across bins (65-bin
stages in three passes, the delay search and its histogram in ceil(H / 32),
two FFT butterflies per lane and stage, warp reductions for the sums,
maxima and the delay search's lowest-index minimum); one-row leaves ride in
registers through the slots; the one-row-per-block histories are not
shifted but staged with head room and stored from where they ended.  The
state is updated in place, as input_output_aliases does for the TPU
kernel.  The main path's instances (history 100, capacity 1, up to 5
slots) fix that layout at compile time; the general instances compute it
at launch, run the slots in windows of 5 (resetting the histories' head
room between windows), write each slot's far block and each frame's output
to global memory as they are made, and take fewer streams a block where a
stream's state is larger.  The modes of a call are template parameters
(clean input, history order, general) or uniform branches (abs_approx, the
frame count) of csrc/frames.cuh.
"""
from __future__ import annotations

import array
import ctypes
import functools

import torch

from . import _build
from ._tree import tree_leaves, tree_leaves_with_path

I32 = torch.int32


# The shared-memory layout of csrc/frames.cuh, for the checks made before
# a launch (chip_smoke.py holds these against aecm_frames_layout).
TABLE_WORDS = 2 * 7 * 128 + 128     # a block's twiddle rows and window
WINDOW_SLOTS = 5                    # block slots staged at once
FIXED_WORDS = {False: 2627, True: 3140}   # a stream's words before its
#                                          delay-estimator rows (single, clean)
SMEM_LIMIT = 232448                 # shared bytes a thread block may take


def stream_words(history: int, cap: int, has_clean: bool,
                 general: bool = True) -> int:
    """Words of shared memory one stream takes: the fixed part, then the
    delay estimator's rows (the two sliding far-end histories, the bit
    counts, mean bit counts and histogram) and, in the general instance,
    the sliding near binary history of `cap` rows; rounded to 4 mod 32
    words, which spreads a block's streams over the banks."""
    w = WINDOW_SLOTS
    end = (FIXED_WORDS[has_clean] + 2 * (w + history) + history
           + 2 * (history + 1) + ((w + cap) if general else 0))
    return (end - 4 + 31) // 32 * 32 + 4


@functools.lru_cache(maxsize=None)
def max_history_size(cap: int = 1, has_clean: bool = False) -> int:
    """The largest delay-estimator history size whose one stream fits a
    thread block (SMEM_LIMIT bytes): 10,703 at lookahead capacity 1 with a
    single near input, 10,601 with a clean one."""
    words = SMEM_LIMIT // 4 - TABLE_WORDS
    h = (words - FIXED_WORDS[has_clean] - 3 * WINDOW_SLOTS - 2 - cap) // 5
    while stream_words(h, cap, has_clean) > words:
        h -= 1
    return h


def core_shape(core):
    """(history size, lookahead capacity) of a lane-major core's delay
    estimator, from its leaf shapes."""
    return core.de_near.bit_counts.shape[0], \
        core.de_near.binary_history.shape[0]


def check_fits(core, has_clean: bool):
    """Raise NotImplementedError if one stream of this core does not fit a
    thread block's shared memory (a history size above max_history_size)."""
    history, cap = core_shape(core)
    if history > max_history_size(cap, has_clean):
        raise NotImplementedError(
            f"the frames kernel takes delay-estimator history sizes up to "
            f"{max_history_size(cap, has_clean)} at lookahead capacity {cap}"
            f"{' with a clean input' if has_clean else ''}: one stream of "
            f"history size {history} needs "
            f"{4 * (TABLE_WORDS + stream_words(history, cap, has_clean))} "
            f"bytes of shared memory, more than a thread block's "
            f"{SMEM_LIMIT} (use_kernel=False runs the plain path)")


def general_instance(history: int, cap: int, n_frames: int,
                     circular: bool) -> bool:
    """Whether a launch takes the general instance (delay-estimator sizes
    from the leaf shapes, the slots in windows of WINDOW_SLOTS, pending
    blocks and outputs written as they are made) rather than the main
    path's (history 100, capacity 1, at most 5 slots, circular only at 4
    frames)."""
    from .fused import _n_slots_for
    return not (history == 100 and cap == 1
                and _n_slots_for(n_frames) <= WINDOW_SLOTS
                and (n_frames == 4 or not circular))


def _core_leaves(core):
    """[(path, tensor)] in CoreState field order, nested tuples flattened:
    the order of `enum Leaf` in csrc/frames.cuh."""
    return tree_leaves_with_path(core)


@functools.lru_cache(maxsize=16)
def _leaf_layout(b: int, history: int = 100, cap: int = 1):
    """(path, shape, dtype) of each core leaf at b streams, in kernel order,
    from a fresh one-stream state whose delay estimator has `history` rows
    and lookahead capacity `cap`."""
    from .fused import create_fused
    one = create_fused(1, 16000, device="cpu")
    rows = {"de_farend.binary_history": history,
            "de_farend.bit_counts": history,
            "de_near.binary_history": cap, "de_near.bit_counts": history,
            "de_near.mean_bit_counts": history + 1,
            "de_near.histogram": history + 1}
    return tuple((path, torch.Size((rows.get(path, x.shape[0]), b)),
                  x.dtype) for path, x in _core_leaves(one.core))


def frames_layout(has_clean: bool = False, circular: bool = True,
                  history: int = 100, cap: int = 1, n_frames: int = 4):
    """The launch shape a step of these dimensions takes, from the built
    library: streams per block, shared-memory bytes per block, resident
    blocks and warps per SM, and whether it is the general instance."""
    lib = _build.load_library()
    g, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check(lib.aecm_frames_layout(
        int(has_clean), int(circular), history, cap, n_frames,
        ctypes.byref(g), ctypes.byref(smem), ctypes.byref(blocks)),
        "aecm_frames_layout")
    return dict(streams_per_block=g.value, smem_bytes=smem.value,
                blocks_per_sm=blocks.value,
                warps_per_sm=blocks.value * g.value,
                general=general_instance(history, cap, n_frames, circular))


def frames_kernel_call(core, t, far_frames, noisy_frames, clean_frames,
                       run_rows, mult: int, n_frames: int,
                       has_clean: bool, abs_approx: bool = False,
                       frames_per_chunk: int = 1, far_head=None):
    """fused.frames_step_cng on CPU tensors (the CNG chain, then
    frames_step); the CUDA frames kernel on CUDA tensors, which draws the
    step's comfort-noise phases itself and updates every core leaf in place
    (the CNG seed too; far_history and far_q_domains when far_head is None:
    the newest-first merge).  Returns what frames_step returns: (core, out)
    with far_head None, (core, out, pend_hist, pend_q) with the circular
    head far_head (a 0-d int32 tensor on the step's device, which the
    kernel reads from device memory, or an int, filled into one here).

    The kernel takes its arguments as they stand and converts nothing:
    every core leaf in its layout (the delay estimator's history size and
    lookahead capacity are read off its leaves), far / noisy / clean_frames
    (n_frames*80, B) int32, run_rows (n_frames, B) bool, the tables int32
    but the LCG's int64 ones (at least n_slots*64 draws), all contiguous
    and on one device; anything else raises, as does a circular step that is not whole
    blocks dividing the history, or a history size above
    max_history_size."""
    dev = far_frames.device
    if dev.type == "cpu":
        from .fused import frames_step_cng
        return frames_step_cng(core, t, far_frames, noisy_frames,
                               clean_frames, run_rows, mult, n_frames,
                               has_clean, abs_approx, frames_per_chunk,
                               far_head)
    if dev.type != "cuda":
        raise RuntimeError(f"no frames kernel for device {dev}")
    from .fused import _exact_block, _n_slots_for
    circular = far_head is not None
    if n_frames < 1 or (circular and not _exact_block(n_frames * 80)):
        raise ValueError(
            f"a frames step of {n_frames} frames"
            + (" is not whole blocks dividing the 100-block history, which "
               "the circular history needs" if n_frames >= 1 else ""))
    if has_clean != (clean_frames is not None):
        raise ValueError("clean_frames must be given exactly when has_clean")
    check_fits(core, has_clean)
    history, cap = core_shape(core)
    b = far_frames.shape[-1]
    leaves = tree_leaves(core)
    layout = _leaf_layout(b, history, cap)
    if len(leaves) != len(layout):
        raise ValueError(f"core has {len(leaves)} leaves, the kernel "
                         f"takes {len(layout)}")
    # one pass over the 75 leaves; the message is made only on a failure
    ptrs = array.array("Q")
    for x, (path, shape, dtype) in zip(leaves, layout):
        if (x.dtype != dtype or x.shape != shape or x.device != dev
                or not x.is_contiguous()):
            _build.require(x, path, dtype, shape, dev)  # raises
        ptrs.append(x.data_ptr())
    rows = (n_frames * 80, b)
    _build.require(far_frames, "far_frames", I32, rows, dev)
    _build.require(noisy_frames, "noisy_frames", I32, rows, dev)
    if has_clean:
        _build.require(clean_frames, "clean_frames", I32, rows, dev)
    n_slots = _n_slots_for(n_frames)
    _build.require(run_rows, "run_rows", torch.bool, (n_frames, b), dev)
    for name in ("win128", "fwr", "fws"):
        x = getattr(t, name)
        _build.require(x, f"table {name}", I32, x.shape, dev)
    for name in ("cos360", "sin360"):
        _build.require(getattr(t, name), f"table {name}", I32, (360,), dev)
    draws = t.lcg_a.shape[0]
    for name in ("lcg_a", "lcg_c"):
        _build.require(getattr(t, name), f"table {name}", torch.int64,
                       (draws, 1), dev)
    if draws < n_slots * 64:
        raise ValueError(
            f"the LCG tables hold {draws} draws; a step of {n_frames} frames "
            f"draws up to {n_slots * 64} (fused.make_tables(device, "
            f"{n_slots}))")
    if circular:
        if not torch.is_tensor(far_head):
            far_head = torch.full((), far_head, dtype=I32, device=dev)
        _build.require(far_head, "far_head", I32, (), dev)
    out = torch.empty(rows, dtype=I32, device=dev)
    # the step's new far blocks: the circular history's output, and the
    # general instance's store of them for the newest-first merge
    pending = circular or general_instance(history, cap, n_frames, circular)
    if pending:
        pend_hist = torch.empty((n_slots * 40, b), dtype=I32, device=dev)
        pend_q = torch.empty((n_slots, b), dtype=I32, device=dev)
    _build.launch(
        "aecm_frames_step", dev.index, ptrs.buffer_info()[0], len(ptrs),
        far_frames.data_ptr(), noisy_frames.data_ptr(),
        clean_frames.data_ptr() if has_clean else None,
        t.lcg_a.data_ptr(), t.lcg_c.data_ptr(), t.cos360.data_ptr(),
        t.sin360.data_ptr(), run_rows.data_ptr(), t.win128.data_ptr(),
        t.fwr.data_ptr(), t.fws.data_ptr(), out.data_ptr(),
        pend_hist.data_ptr() if pending else None,
        pend_q.data_ptr() if pending else None,
        far_head.data_ptr() if circular else None, b, mult,
        frames_per_chunk, n_frames, int(has_clean), int(abs_approx), history,
        cap)
    _FRAMES.launches += 1
    if circular:
        return core, out, pend_hist, pend_q
    return core, out


frames_kernel_call.launches = 0   # launches of the CUDA kernel
_FRAMES = frames_kernel_call      # the counter's owner, whatever rebinds the name
