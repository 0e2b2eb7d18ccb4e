"""The frames kernel: CUDA wrapper around csrc/frames.cu.

Replaces the TPU kernel `_frames_kernel_call` (webrtc_aecm_tpu/fused.py:
1595, pallas_call at :1708, body `frames_step` :1283 -> `_process_block_f`
:1037): the whole AECM core for one serving step of n_frames frames, in each
of its modes: 1 to 4 frames (2 to 5 block slots), a single or a clean near
input, `abs_approx`, and the far history circular (4-frame steps; the new
blocks come out for the caller to append) or newest-first (merged in place,
as the TPU kernel's aliases do).  The plain version is fused.frames_step.

What bounds it on the card: integer operations (three 128-point
fixed-point FFTs, four with a clean input, the 100-entry delay search and
the 65-bin NLMS / Wiener / comfort-noise stages per block, 5 blocks per
step: about 0.3 M integer operations per stream and step against 22 KB
moved, 55 KB with the newest-first history merge), not bytes.

Design: one warp per stream, 8 streams per thread block (4 with a clean
input, whose state takes 2 KB more a stream).  The block stages its
streams' state (every leaf the step reads but the far history) in shared
memory once, cooperatively, so that the lane-major (rows, B) layout of the
JAX package gives 32 contiguous bytes per row; the warp then runs the
step's block schedule on shared memory with its lanes across bins (65-bin
stages in three passes, the delay search and its histogram in four, two FFT
butterflies per lane and stage, warp reductions for the sums, maxima and
the delay search's lowest-index minimum); one-row leaves ride in registers
through the slots; the one-row-per-block histories are not shifted but
staged with head room and stored from where they ended.  The state is
updated in place, as input_output_aliases does for the TPU kernel.  The
modes of a call are template parameters (clean input, history order) or
uniform branches (abs_approx, the frame count) of csrc/frames.cuh.
"""
from __future__ import annotations

import array
import ctypes
import functools

import torch

from . import _build
from ._tree import tree_leaves, tree_leaves_with_path

I32 = torch.int32


def _core_leaves(core):
    """[(path, tensor)] in CoreState field order, nested tuples flattened:
    the order of `enum Leaf` in csrc/frames.cu."""
    return tree_leaves_with_path(core)


@functools.lru_cache(maxsize=8)
def _leaf_layout(b: int):
    """(path, shape, dtype) of each core leaf at b streams, in kernel order,
    from a fresh one-stream state."""
    from .fused import create_fused
    one = create_fused(1, 16000, device="cpu")
    return tuple((path, torch.Size((x.shape[0], b)), x.dtype)
                 for path, x in _core_leaves(one.core))


def frames_layout(has_clean: bool = False, circular: bool = True):
    """An instance's launch shape, from the built library: streams per
    block, shared-memory bytes per block, resident blocks and warps per
    SM."""
    lib = _build.load_library()
    g, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check(lib.aecm_frames_layout(
        int(has_clean), int(circular), ctypes.byref(g), ctypes.byref(smem),
        ctypes.byref(blocks)), "aecm_frames_layout")
    return dict(streams_per_block=g.value, smem_bytes=smem.value,
                blocks_per_sm=blocks.value,
                warps_per_sm=blocks.value * g.value)


def frames_kernel_call(core, t, far_frames, noisy_frames, clean_frames,
                       phase_all, run_rows, mult: int, n_frames: int,
                       has_clean: bool, abs_approx: bool = False,
                       frames_per_chunk: int = 1, far_head=None):
    """fused.frames_step on CPU tensors; the CUDA frames kernel on CUDA
    tensors, which updates every core leaf in place (far_history and
    far_q_domains too when far_head is None: the newest-first merge).
    Returns what frames_step returns: (core, out) with far_head None,
    (core, out, pend_hist, pend_q) with the circular head far_head.

    The kernel takes its arguments as they stand and converts nothing:
    every core leaf in its layout, far / noisy / clean_frames (n_frames*80,
    B) and phase_all (n_slots*64, B) int32, run_rows (n_frames, B) bool,
    the tables int32, all contiguous and on one device; anything else
    raises, as does a step of more than 4 frames, a circular step of fewer,
    or lookahead capacity > 1."""
    dev = far_frames.device
    if dev.type == "cpu":
        from .fused import frames_step
        return frames_step(core, t, far_frames, noisy_frames, clean_frames,
                           phase_all, run_rows, mult, n_frames, has_clean,
                           abs_approx, frames_per_chunk, far_head)
    if dev.type != "cuda":
        raise RuntimeError(f"no frames kernel for device {dev}")
    from .fused import MAX_KERNEL_FRAMES, _n_slots_for
    circular = far_head is not None
    if not 1 <= n_frames <= MAX_KERNEL_FRAMES or (
            circular and n_frames != MAX_KERNEL_FRAMES):
        raise NotImplementedError(
            f"the frames kernel runs 1 to {MAX_KERNEL_FRAMES} frames a step "
            f"with the newest-first far history and {MAX_KERNEL_FRAMES} with "
            f"the circular one; got {n_frames} (ROADMAP.md Queue 1 item 9)")
    if has_clean != (clean_frames is not None):
        raise ValueError("clean_frames must be given exactly when has_clean")
    b = far_frames.shape[-1]
    leaves = tree_leaves(core)
    layout = _leaf_layout(b)
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
    if core.de_near.binary_history.shape[0] != 1:
        raise NotImplementedError("lookahead capacity > 1")
    rows = (n_frames * 80, b)
    _build.require(far_frames, "far_frames", I32, rows, dev)
    _build.require(noisy_frames, "noisy_frames", I32, rows, dev)
    if has_clean:
        _build.require(clean_frames, "clean_frames", I32, rows, dev)
    n_slots = _n_slots_for(n_frames)
    _build.require(phase_all, "phase_all", I32, (n_slots * 64, b), dev)
    _build.require(run_rows, "run_rows", torch.bool, (n_frames, b), dev)
    for name in ("win128", "fwr", "fws"):
        x = getattr(t, name)
        _build.require(x, f"table {name}", I32, x.shape, dev)
    out = torch.empty(rows, dtype=I32, device=dev)
    if circular:
        pend_hist = torch.empty((n_slots * 40, b), dtype=I32, device=dev)
        pend_q = torch.empty((n_slots, b), dtype=I32, device=dev)
    _build.launch(
        "aecm_frames_step", dev.index, ptrs.buffer_info()[0], len(ptrs),
        far_frames.data_ptr(), noisy_frames.data_ptr(),
        clean_frames.data_ptr() if has_clean else None,
        phase_all.data_ptr(), run_rows.data_ptr(), t.win128.data_ptr(),
        t.fwr.data_ptr(), t.fws.data_ptr(), out.data_ptr(),
        pend_hist.data_ptr() if circular else None,
        pend_q.data_ptr() if circular else None, b,
        far_head if circular else -1, mult, frames_per_chunk, n_frames,
        int(has_clean), int(abs_approx))
    _FRAMES.launches += 1
    if circular:
        return core, out, pend_hist, pend_q
    return core, out


frames_kernel_call.launches = 0   # launches of the CUDA kernel
_FRAMES = frames_kernel_call      # the counter's owner, whatever rebinds the name
