"""The jitter-ring kernels: CUDA kernel wrappers with their launch counters.

Three kernels of csrc/ring.cu, each behind one wrapper here:

* `ring_multi_pass` (and `ring_pass`, its cps = 1 form), the fused serving
  step's pass, described below;
* `ring_write` and `ring_read`, the batch-major engine's write and read
  behind ops/ring_buffer.write / read / read_frames.  Each does the
  per-stream pointer arithmetic and the data pass in one launch, and
  `ring_read` serves every 80-sample frame of a Process call, so a 10 ms
  chunk launches one of each at 8 and at 16 kHz.

CPU tensors take the plain versions (`ring_multi_pass_plain` here,
`write_plain` and `read_frames_plain` in ops/ring_buffer.py); CUDA tensors
launch the kernel or raise.  A wrapper converts nothing: it checks each
argument by attribute reads (`_build.require`) and raises on one that is
not of the kernel's type, contiguous and on the ring's device.  No wrapper
synchronises or reads a tensor's value on the host.

`ring_multi_pass` replaces the TPU kernels `ring_multi_pass_tpu`
(webrtc_aecm_tpu/ops/pallas_ring.py:306, `_multi_pass_kernel` :211) and
`ring_pass_tpu` (:169, `_pass_kernel` :93), which the JAX code states are
the same pass at cps chunks and at one chunk.  One kernel covers both: cps
is a runtime argument.

For c = 0..cps-1: a wrapped write of chunk c's far samples into the int16
jitter ring at wpos[c] (n_write[c] of them: the ring may clamp a write),
then a wrapped gather of n samples at rpos[c]; chunk c's gather sees writes
0..c only.  The ring is updated in place on the kernel path.

What bounds it on the card: memory latency, not bandwidth.  Per stream a
step writes at most cps*160 int16 samples and reads cps*160; the TPU kernel
streamed the whole 8 KB ring row through VMEM, the CUDA kernel touches only
the samples it writes and reads.  One warp serves one stream, so the warp's
lanes read and write consecutive samples of one row (coalesced), and the
per-stream positions need no uniform/divergent split or replay.
"""
from __future__ import annotations

import torch

from .. import _build
from . import ring_buffer as rbuf

I32 = torch.int32


def ring_multi_pass_plain(data, wpos, values, n_write, rpos, n_read: int):
    """Plain version (any device): returns (new ring, gathered (B,
    cps*n_read) int32); `data` is not modified."""
    from .. import fused
    return fused._ring_write_gather_multi(data, wpos, values, n_write, rpos,
                                          n_read)


def _multi_pass(data, wpos, values, n_write, rpos, n_read: int):
    """The checks and the launch of ring_multi_pass / ring_pass; returns
    (ring, gathered, whether the CUDA kernel was launched)."""
    dev = data.device
    if data.ndim != 2 or wpos.ndim != 2:
        raise ValueError("ring must be (B, C) and the positions (cps, B)")
    (b, cap), cps = data.shape, wpos.shape[0]
    _build.require(data, "ring", torch.int16, (b, cap), dev)
    for name, x in (("wpos", wpos), ("n_write", n_write), ("rpos", rpos)):
        _build.require(x, name, I32, (cps, b), dev)
    _build.require(values, "values", I32, (b, cps * n_read), dev)
    if dev.type == "cpu":
        return ring_multi_pass_plain(data, wpos, values, n_write, rpos,
                                     n_read) + (False,)
    if dev.type != "cuda":
        raise RuntimeError(f"no ring kernel for device {dev}")
    gathered = torch.empty((b, cps * n_read), dtype=I32, device=dev)
    _build.launch("aecm_ring_multi_pass", dev.index, data.data_ptr(),
                  wpos.data_ptr(), n_write.data_ptr(), rpos.data_ptr(),
                  values.data_ptr(), gathered.data_ptr(), b, cap, cps,
                  n_read)
    return data, gathered, True


def ring_multi_pass(data, wpos, values, n_write, rpos, n_read: int):
    """cps ring passes (write chunk c, gather chunk c, in order).
    wpos/n_write/rpos (cps, B) int32; values (B, cps*n_read) int32; data
    (B, C) int16.  CPU tensors take the plain version; CUDA tensors launch
    csrc/ring.cu, which updates `data` in place and returns it.  Returns
    (ring, gathered (B, cps*n_read) int32)."""
    data, gathered, launched = _multi_pass(data, wpos, values, n_write,
                                           rpos, n_read)
    _RING.launches += launched
    return data, gathered


def ring_pass(data, wpos, values, n_write, rpos, n_read: int):
    """The one-chunk pass (the TPU package's ring_pass_tpu), the fused
    10 ms real-time step's: wpos, n_write, rpos (B,) int32, values (B,
    n_read); the same kernel at cps = 1, counted apart."""
    data, gathered, launched = _multi_pass(data, wpos[None], values,
                                           n_write[None], rpos[None], n_read)
    _PASS.launches += launched
    return data, gathered


ring_multi_pass.launches = 0   # launches of the CUDA kernel, per wrapper
ring_pass.launches = 0
_RING, _PASS = ring_multi_pass, ring_pass   # the counters' owners


# ---------------------------------------------------------------------------
# The batch-major engine's write and read.  They replace `ring_write_tpu`
# (pallas_ring.py:379, `_write_kernel` :356) and `ring_gather_tpu` (:56,
# `_gather_kernel` :36), which the JAX package reaches through the
# custom_vmap rules of ops/ring_buffer.py (`_contig_write_vmap`,
# `_read_vmap`), and the pointer arithmetic that the JAX functions `write`,
# `read` and `move_read_ptr` do around them.  At serving sizes each moves a
# few hundred bytes per stream: the launch bounds them, not the bandwidth,
# so each is one launch with nothing around it (see csrc/ring.cu).
# ---------------------------------------------------------------------------

def _require_ring(data, read_pos, write_pos, rw_wrap):
    if data.ndim != 2:
        raise ValueError("ring must be a (B, C) tensor")
    dev, b = data.device, data.shape[0]
    _build.require(data, "ring", torch.int16, data.shape, dev)
    _build.require(read_pos, "read_pos", I32, (b,), dev)
    _build.require(write_pos, "write_pos", I32, (b,), dev)
    _build.require(rw_wrap, "rw_wrap", I32, (b,), dev)


def ring_write(data, read_pos, write_pos, rw_wrap, values):
    """WebRtc_WriteBuffer on a batch of rings, pointers and all: per ring
    n_write = min(free space, n), data[b, (write_pos[b] + j) mod C] =
    (int16) values[b, j] for j < n_write (the C store's wrap), and the new
    write_pos / rw_wrap (a write that passes the end wraps and sets
    DIFF_WRAP; one that ends at it rests at C).

    data (B, C) int16; read_pos, write_pos, rw_wrap (B,) int32; values
    (B, n) int32 with unit inner stride (rows may be a column slice of a
    longer signal).  Returns (ring, write_pos, rw_wrap), the pointers
    always new tensors.  CPU tensors take `ring_buffer.write_plain`, which
    returns a new ring; CUDA tensors launch `aecm_ring_write`, which
    updates `data` in place and returns it."""
    _require_ring(data, read_pos, write_pos, rw_wrap)
    dev, (b, cap) = data.device, data.shape
    if (values.dtype != I32 or values.ndim != 2 or values.shape[0] != b
            or values.device != dev or values.stride(1) != 1):
        raise ValueError(f"values must be ({b}, n) int32 with unit inner "
                         f"stride on {dev}; got {tuple(values.shape)} "
                         f"{values.dtype}, strides {values.stride()}, on "
                         f"{values.device}")
    if dev.type == "cpu":
        return rbuf.write_plain(data, read_pos, write_pos, rw_wrap, values)
    if dev.type != "cuda":
        raise RuntimeError(f"no ring_write kernel for device {dev}")
    new_write_pos = torch.empty_like(write_pos)
    new_rw_wrap = torch.empty_like(rw_wrap)
    _build.launch("aecm_ring_write", dev.index, data.data_ptr(),
                  read_pos.data_ptr(), write_pos.data_ptr(),
                  rw_wrap.data_ptr(), values.data_ptr(), values.stride(0),
                  new_write_pos.data_ptr(), new_rw_wrap.data_ptr(), b, cap,
                  values.shape[1])
    _WRITE.launches += 1
    return data, new_write_pos, new_rw_wrap


def ring_read(data, read_pos, write_pos, rw_wrap, gate, count: int,
              n_frames: int, whole_frames: bool = True):
    """n_frames reads of `count` samples in a row, pointers and all (see
    `ring_buffer.read_frames` for the function).  data (B, C) int16;
    read_pos, write_pos, rw_wrap (B,) int32; gate (B,) bool or None.
    Returns (frames (B, n_frames, count) int32, have_data (B, n_frames)
    bool, read_pos, rw_wrap), all new tensors; nothing is updated in place.
    CPU tensors take `ring_buffer.read_frames_plain`; CUDA tensors launch
    `aecm_ring_read`."""
    _require_ring(data, read_pos, write_pos, rw_wrap)
    dev, (b, cap) = data.device, data.shape
    if gate is not None:
        _build.require(gate, "gate", torch.bool, (b,), dev)
    if dev.type == "cpu":
        return rbuf.read_frames_plain(data, read_pos, write_pos, rw_wrap,
                                      gate, count, n_frames, whole_frames)
    if dev.type != "cuda":
        raise RuntimeError(f"no ring_read kernel for device {dev}")
    frames = torch.empty((b, n_frames, count), dtype=I32, device=dev)
    have_data = torch.empty((b, n_frames), dtype=torch.bool, device=dev)
    new_read_pos = torch.empty_like(read_pos)
    new_rw_wrap = torch.empty_like(rw_wrap)
    _build.launch("aecm_ring_read", dev.index, data.data_ptr(),
                  read_pos.data_ptr(), write_pos.data_ptr(),
                  rw_wrap.data_ptr(),
                  None if gate is None else gate.data_ptr(),
                  frames.data_ptr(), have_data.data_ptr(),
                  new_read_pos.data_ptr(), new_rw_wrap.data_ptr(), b, cap,
                  count, n_frames, int(whole_frames))
    _READ.launches += 1
    return frames, have_data, new_read_pos, new_rw_wrap


ring_write.launches = 0   # launches of the CUDA kernels
ring_read.launches = 0
_WRITE, _READ = ring_write, ring_read
