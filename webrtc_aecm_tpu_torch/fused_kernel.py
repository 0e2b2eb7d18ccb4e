"""The frames kernel: CUDA wrapper around csrc/frames.cu.

Replaces the TPU kernel `_frames_kernel_call` (webrtc_aecm_tpu/fused.py:
1595, pallas_call at :1708, body `frames_step` :1283 -> `_process_block_f`
:1037): the whole AECM core for one serving step of n_frames frames, in the
circular far-history mode.  The plain version is fused.frames_step.

Design: one CUDA thread per stream runs the step's 5-slot block schedule
(re-blocking, windowed 128-point FFTs, delay estimator, aligned far fetch,
energies/VAD, step size, NLMS, suppression gain, Wiener/NLP, CNG,
IFFT/overlap-add, 80-sample emit) as straight-line integer code.  The state
keeps the JAX package's lane-major (rows, B) layout, so thread b reading
row r of a leaf coalesces with its neighbours.  The state is updated in
place, as input_output_aliases does for the TPU kernel; the two far-history
leaves are read-only and the step's new blocks come out in pend_hist and
pend_q for the caller to append.

What bounds it on the card: latency of a long dependent chain per thread.
At B = 4096 streams the grid has 4096 threads, about one warp per SM, so
each SM runs little more than a single warp and memory latency is barely
hidden; the per-thread working arrays (FFT buffers, 65-bin spectra, the
block outputs) live in local memory.  Spreading bins across the threads of
a warp is the next step once a measurement asks for it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._tree import tree_leaves_with_path

I32 = torch.int32


def _core_leaves(core):
    """[(path, tensor)] in CoreState field order, nested tuples flattened:
    the order of `enum Leaf` in csrc/frames.cu."""
    return tree_leaves_with_path(core)


@functools.lru_cache(maxsize=1)
def _leaf_layout():
    """(rows, dtype) of each core leaf, in kernel order, from a fresh
    one-stream state."""
    from .fused import create_fused
    one = create_fused(1, 16000, device="cpu")
    return tuple((x.shape[0], x.dtype) for _, x in _core_leaves(one.core))


def frames_kernel_call(core, t, far_frames, noisy_frames, phase_all,
                       run_rows, mult: int, n_frames: int,
                       frames_per_chunk: int, far_head: int):
    """fused.frames_step on CPU tensors; the CUDA frames kernel on CUDA
    tensors, which updates every core leaf in place except far_history and
    far_q_domains.  Returns (core, out, pend_hist, pend_q)."""
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
    leaves = _core_leaves(core)
    for (path, x), (rows, dtype) in zip(leaves, _leaf_layout()):
        if (x.device != dev or not x.is_contiguous() or x.dtype != dtype
                or tuple(x.shape) != (rows, b)):
            raise ValueError(f"core leaf {path} must be a contiguous "
                             f"({rows}, {b}) {dtype} tensor on {dev}")
    if core.de_near.binary_history.shape[0] != 1:
        raise NotImplementedError("lookahead capacity > 1")
    ins = [x.to(I32).contiguous() for x in
           (far_frames, noisy_frames, phase_all, run_rows)]
    for x, rows in zip(ins, (n_frames * 80, n_frames * 80, 320, n_frames)):
        if x.shape != (rows, b):
            raise ValueError(f"input of shape {tuple(x.shape)}, expected "
                             f"({rows}, {b})")
    out = torch.empty((n_frames * 80, b), dtype=I32, device=dev)
    pend_hist = torch.empty((5 * 40, b), dtype=I32, device=dev)
    pend_q = torch.empty((5, b), dtype=I32, device=dev)
    ptrs = (ctypes.c_void_p * len(leaves))(*[x.data_ptr()
                                             for _, x in leaves])
    lib = _build.load_library()
    tabs = [x.to(I32).contiguous() for x in (t.win128, t.fwr, t.fws)]
    for x in tabs:
        if x.device != dev:
            raise ValueError(f"tables must be on {dev}")
    err = lib.aecm_frames_step(
        ptrs, len(leaves), ins[0].data_ptr(), ins[1].data_ptr(),
        ins[2].data_ptr(), ins[3].data_ptr(), tabs[0].data_ptr(),
        tabs[1].data_ptr(), tabs[2].data_ptr(), out.data_ptr(),
        pend_hist.data_ptr(), pend_q.data_ptr(), b, int(far_head),
        int(mult), int(frames_per_chunk),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "aecm_frames_step")
    _FRAMES.launches += 1
    return core, out, pend_hist, pend_q


frames_kernel_call.launches = 0   # launches of the CUDA kernel
_FRAMES = frames_kernel_call      # the counter's owner, whatever rebinds the name
