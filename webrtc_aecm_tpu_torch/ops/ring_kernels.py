"""The jitter-ring data passes: CUDA kernel wrappers and their plain versions.

Three kernels of csrc/ring.cu, each a wrapper with a launch counter here:

* `ring_multi_pass` (and `ring_pass`, its cps = 1 form), the fused serving
  step's pass, described below;
* `ring_write` and `ring_gather`, the batch-major engine's data passes
  behind ops/ring_buffer.write / read (see their docstrings).

CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise.

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

from . import ring_buffer as rbuf

I32 = torch.int32


def ring_multi_pass_plain(data, wpos, values, n_write, rpos, n_read: int):
    """Plain version (any device): returns (new ring, gathered (B,
    cps*n_read) int32); `data` is not modified."""
    from .. import fused
    return fused._ring_write_gather_multi(data, wpos, values, n_write, rpos,
                                          n_read)


def _check(data, wpos, values, n_write, rpos, n_read):
    b, _ = data.shape
    cps = wpos.shape[0]
    if data.dtype != torch.int16 or not data.is_contiguous():
        raise ValueError("ring must be a contiguous (B, C) int16 tensor")
    for name, x in (("wpos", wpos), ("n_write", n_write), ("rpos", rpos)):
        if x.shape != (cps, b) or x.dtype != I32 or x.device != data.device:
            raise ValueError(f"{name} must be ({cps}, {b}) int32 on "
                             f"{data.device}")
    if (values.shape != (b, cps * n_read) or values.dtype != I32
            or values.device != data.device):
        raise ValueError(f"values must be ({b}, {cps * n_read}) int32")


def ring_multi_pass(data, wpos, values, n_write, rpos, n_read: int):
    """cps ring passes (write chunk c, gather chunk c, in order).
    wpos/n_write/rpos (cps, B) int32; values (B, cps*n_read) int32; data
    (B, C) int16.  CPU tensors take the plain version; CUDA tensors launch
    csrc/ring.cu, which updates `data` in place and returns it.  Returns
    (ring, gathered (B, cps*n_read) int32)."""
    if data.device.type == "cpu":
        return ring_multi_pass_plain(data, wpos, values, n_write, rpos,
                                     n_read)
    if data.device.type != "cuda":
        raise RuntimeError(f"no ring kernel for device {data.device}")
    from .. import _build
    wpos, n_write, rpos = (x.to(I32).contiguous()
                           for x in (wpos, n_write, rpos))
    values = values.to(I32).contiguous()
    _check(data, wpos, values, n_write, rpos, n_read)
    b, cap = data.shape
    gathered = torch.empty((b, wpos.shape[0] * n_read), dtype=I32,
                           device=data.device)
    lib = _build.load_library()
    err = lib.aecm_ring_multi_pass(
        data.data_ptr(), wpos.data_ptr(), n_write.data_ptr(),
        rpos.data_ptr(), values.data_ptr(), gathered.data_ptr(),
        b, cap, wpos.shape[0], n_read,
        torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(err, "aecm_ring_multi_pass")
    _RING.launches += 1
    return data, gathered


ring_multi_pass.launches = 0   # launches of the CUDA kernel
_RING = ring_multi_pass        # the counter's owner, whatever rebinds the name


def ring_pass(data, wpos, values, n_write, rpos, n_read: int):
    """The one-chunk pass (the TPU package's ring_pass_tpu): wpos, n_write,
    rpos (B,), values (B, n_read); the same kernel at cps = 1."""
    return ring_multi_pass(data, wpos[None], values, n_write[None],
                           rpos[None], n_read)


# ---------------------------------------------------------------------------
# The batch-major engine's passes.  They replace `ring_write_tpu`
# (pallas_ring.py:379, `_write_kernel` :356) and `ring_gather_tpu` (:56,
# `_gather_kernel` :36), which the JAX package reaches through the
# custom_vmap rules of ops/ring_buffer.py (`_contig_write_vmap`,
# `_read_vmap`).  At serving sizes each moves a few hundred bytes per
# stream: the launch and the memory latency bound them, not the bandwidth.
# ---------------------------------------------------------------------------

def _check_ring(data, pos, name):
    if data.dtype != torch.int16 or data.ndim != 2 or not data.is_contiguous():
        raise ValueError(f"{name}: ring must be a contiguous (B, C) int16 "
                         "tensor")
    if pos.shape != data.shape[:1] or pos.device != data.device:
        raise ValueError(f"{name}: positions must be ({data.shape[0]},) on "
                         f"{data.device}")


def _cuda_only(data, name):
    if data.device.type != "cuda":
        raise RuntimeError(f"no {name} kernel for device {data.device}")


def ring_gather(data, pos, n: int):
    """out[b, j] = data[b, (pos[b] + j) mod C] for j < n: data (B, C)
    int16, pos (B,) int32 in [0, C] -> (B, n) int16.  CPU tensors take the
    plain `ring_buffer._contig_read`; CUDA tensors launch
    `aecm_ring_gather`."""
    _check_ring(data, pos, "ring_gather")
    if data.device.type == "cpu":
        return rbuf._contig_read(data, pos, n)
    _cuda_only(data, "ring_gather")
    from .. import _build
    pos = pos.to(I32).contiguous()
    b, cap = data.shape
    out = torch.empty((b, n), dtype=data.dtype, device=data.device)
    lib = _build.load_library()
    err = lib.aecm_ring_gather(
        data.data_ptr(), pos.data_ptr(), out.data_ptr(), b, cap, n,
        torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(err, "aecm_ring_gather")
    _GATHER.launches += 1
    return out


def ring_write(data, pos, values, n_write):
    """data[b, (pos[b] + j) mod C] = (int16) values[b, j] for j <
    n_write[b]: data (B, C) int16, pos and n_write (B,) int32 (pos in [0,
    C], n_write in [0, n]), values (B, n) int32, wrapped to int16 as the C
    store does.  CPU tensors take the plain `ring_buffer._contig_write`,
    which returns a new ring; CUDA tensors launch `aecm_ring_write`, which
    updates `data` in place and returns it."""
    _check_ring(data, pos, "ring_write")
    if (n_write.shape != pos.shape or values.ndim != 2
            or values.shape[0] != data.shape[0]
            or values.device != data.device
            or n_write.device != data.device):
        raise ValueError(f"ring_write: n_write must be ({data.shape[0]},) "
                         f"and values ({data.shape[0]}, n) on {data.device}")
    if data.device.type == "cpu":
        return rbuf._contig_write(data, pos, values, n_write)
    _cuda_only(data, "ring_write")
    from .. import _build
    pos, n_write = (x.to(I32).contiguous() for x in (pos, n_write))
    values = values.to(I32).contiguous()
    b, cap = data.shape
    lib = _build.load_library()
    err = lib.aecm_ring_write(
        data.data_ptr(), pos.data_ptr(), n_write.data_ptr(),
        values.data_ptr(), b, cap, values.shape[1],
        torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(err, "aecm_ring_write")
    _WRITE.launches += 1
    return data


ring_gather.launches = 0   # launches of the CUDA kernels
ring_write.launches = 0
_GATHER, _WRITE = ring_gather, ring_write
