"""The frames kernel: CUDA wrapper around csrc/frames.cu.

Replaces the TPU kernel `_frames_kernel_call` (webrtc_aecm_tpu/fused.py:
1595, pallas_call at :1708, body `frames_step` :1283 -> `_process_block_f`
:1037): the whole AECM core for one serving step of n_frames frames, in the
circular far-history mode.  The plain version is fused.frames_step.

What bounds it on the card: integer operations (three 128-point
fixed-point FFTs, the 100-entry delay search and the 65-bin NLMS / Wiener /
comfort-noise stages per block, 5 blocks per step: about 0.3 M integer
operations per stream and step against 22 KB moved), not bytes.

Design: one warp per stream, 8 streams per thread block.  The block stages
its streams' state (every leaf the step reads but the far history) in
shared memory once, cooperatively, so that the lane-major (rows, B) layout
of the JAX package gives 32 contiguous bytes per row; the warp then runs
the step's 5-slot block schedule on shared memory with its lanes across
bins (65-bin stages in three passes, the delay search and its histogram in
four, two FFT butterflies per lane and stage, warp reductions for the sums,
maxima and the delay search's lowest-index minimum); one-row leaves ride in
registers through the 5 slots; the one-row-per-block histories are not
shifted but staged with head room and stored from where they ended.  The
state is updated in place, as input_output_aliases does for the TPU kernel;
the two far-history leaves are read-only and the step's new blocks come out
in pend_hist and pend_q for the caller to append.
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


def frames_layout():
    """The kernel's launch shape, from the built library: streams per
    block, shared-memory bytes per block, resident blocks and warps per
    SM."""
    lib = _build.load_library()
    g, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check(lib.aecm_frames_layout(
        ctypes.byref(g), ctypes.byref(smem), ctypes.byref(blocks)),
        "aecm_frames_layout")
    return dict(streams_per_block=g.value, smem_bytes=smem.value,
                blocks_per_sm=blocks.value,
                warps_per_sm=blocks.value * g.value)


def frames_kernel_call(core, t, far_frames, noisy_frames, phase_all,
                       run_rows, mult: int, n_frames: int,
                       frames_per_chunk: int, far_head: int):
    """fused.frames_step on CPU tensors; the CUDA frames kernel on CUDA
    tensors, which updates every core leaf in place except far_history and
    far_q_domains.  Returns (core, out, pend_hist, pend_q).

    The kernel takes its arguments as they stand and converts nothing:
    every core leaf in its layout, far_frames / noisy_frames (n_frames*80,
    B) and phase_all (320, B) int32, run_rows (n_frames, B) bool, the
    tables int32, all contiguous and on one device; anything else raises."""
    dev = far_frames.device
    if dev.type == "cpu":
        from .fused import frames_step
        return frames_step(core, t, far_frames, noisy_frames, phase_all,
                           run_rows, mult, n_frames, frames_per_chunk,
                           far_head)
    if dev.type != "cuda":
        raise RuntimeError(f"no frames kernel for device {dev}")
    if n_frames * 80 != 320:
        raise NotImplementedError("the frames kernel runs 4-frame steps")
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
    _build.require(far_frames, "far_frames", I32, (n_frames * 80, b), dev)
    _build.require(noisy_frames, "noisy_frames", I32, (n_frames * 80, b),
                   dev)
    _build.require(phase_all, "phase_all", I32, (320, b), dev)
    _build.require(run_rows, "run_rows", torch.bool, (n_frames, b), dev)
    for name in ("win128", "fwr", "fws"):
        x = getattr(t, name)
        _build.require(x, f"table {name}", I32, x.shape, dev)
    out = torch.empty((n_frames * 80, b), dtype=I32, device=dev)
    pend_hist = torch.empty((5 * 40, b), dtype=I32, device=dev)
    pend_q = torch.empty((5, b), dtype=I32, device=dev)
    _build.launch(
        "aecm_frames_step", dev.index, ptrs.buffer_info()[0], len(ptrs),
        far_frames.data_ptr(), noisy_frames.data_ptr(),
        phase_all.data_ptr(), run_rows.data_ptr(), t.win128.data_ptr(),
        t.fwr.data_ptr(), t.fws.data_ptr(), out.data_ptr(),
        pend_hist.data_ptr(), pend_q.data_ptr(), b, far_head, mult,
        frames_per_chunk)
    _FRAMES.launches += 1
    return core, out, pend_hist, pend_q


frames_kernel_call.launches = 0   # launches of the CUDA kernel
_FRAMES = frames_kernel_call      # the counter's owner, whatever rebinds the name
