"""Fixed-shape ring buffer: pointer math and the plain data passes.

Port of webrtc_aecm_tpu/ops/ring_buffer.py (reference: aecm/ring_buffer.
{h,c}).  The pointer functions work on any leading batch shape; `write` and
`read` take a batch of rings, data (B, C) and pointers (B,), the JAX
functions under `jax.vmap`.  Their data passes go through the wrappers of
ops/ring_kernels.py (`ring_write`, `ring_gather`): the CUDA kernels on the
card, the plain `_contig_write`/`_contig_read` below on the CPU.

Semantics replicated exactly, including partial writes clamped to free
space, negative `move_read_ptr` (buffer stuffing) clamped to free space, the
SAME_WRAP/DIFF_WRAP tracking, and a read/write position that comes to rest
exactly at `capacity` without wrapping (ring_buffer.c:196).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _device
from . import spl

I32 = torch.int32

SAME_WRAP = 0
DIFF_WRAP = 1


class RingBuffer(NamedTuple):
    data: torch.Tensor       # (..., capacity)
    read_pos: torch.Tensor   # (...) int32
    write_pos: torch.Tensor  # (...) int32
    rw_wrap: torch.Tensor    # (...) int32, SAME_WRAP / DIFF_WRAP

    @property
    def capacity(self) -> int:
        return self.data.shape[-1]


def create(capacity: int, dtype=I32, device=None) -> RingBuffer:
    """WebRtc_CreateBuffer + WebRtc_InitBuffer (ring_buffer.c:53-85) for
    one ring."""
    device = _device.resolve(device)
    z = torch.zeros((), dtype=I32, device=device)
    return RingBuffer(data=torch.zeros((capacity,), dtype=dtype,
                                       device=device),
                      read_pos=z, write_pos=z.clone(),
                      rw_wrap=torch.full((), SAME_WRAP, dtype=I32,
                                         device=device))


def init(rb: RingBuffer) -> RingBuffer:
    """WebRtc_InitBuffer (ring_buffer.c:75-85): empty rings, zeroed data,
    of rb's shapes and device."""
    z = torch.zeros_like(rb.read_pos)
    return RingBuffer(data=torch.zeros_like(rb.data), read_pos=z,
                      write_pos=z.clone(),
                      rw_wrap=torch.full_like(rb.rw_wrap, SAME_WRAP))


def available_read(rb: RingBuffer):
    """WebRtc_available_read (ring_buffer.c:213-223)."""
    cap = rb.capacity
    same = rb.write_pos - rb.read_pos
    diff = cap - rb.read_pos + rb.write_pos
    return torch.where(rb.rw_wrap == SAME_WRAP, same, diff).to(I32)


def available_write(rb: RingBuffer):
    """WebRtc_available_write (ring_buffer.c:225-231)."""
    return (rb.capacity - available_read(rb)).to(I32)


def move_read_ptr(rb: RingBuffer, element_count) -> RingBuffer:
    """WebRtc_MoveReadPtr (ring_buffer.c:176-211); the count may be
    negative."""
    cap = rb.capacity
    free = available_write(rb)
    readable = available_read(rb)
    ec = torch.as_tensor(element_count, dtype=I32, device=readable.device)
    ec = torch.maximum(torch.minimum(ec, readable), -free)
    read_pos = rb.read_pos + ec
    over = read_pos > cap
    under = read_pos < 0
    read_pos = torch.where(over, read_pos - cap, read_pos)
    read_pos = torch.where(under, read_pos + cap, read_pos)
    rw_wrap = torch.where(over, SAME_WRAP, rb.rw_wrap)
    rw_wrap = torch.where(under, DIFF_WRAP, rw_wrap)
    return rb._replace(read_pos=read_pos.to(I32), rw_wrap=rw_wrap.to(I32))


def write(rb: RingBuffer, values) -> RingBuffer:
    """WebRtc_WriteBuffer (ring_buffer.c:142-174) on a batch of rings:
    data (B, C), values (B, n) int32, n static.  The write is clamped to
    each ring's free space.  On the card the data pass (ring_kernels.
    ring_write) updates rb.data in place: use the returned ring."""
    from . import ring_kernels
    cap = rb.capacity
    n_write = available_write(rb).clamp(max=values.shape[-1])
    margin = cap - rb.write_pos
    wrapped = n_write > margin
    data = ring_kernels.ring_write(rb.data, rb.write_pos, values, n_write)
    return rb._replace(
        data=data,
        write_pos=torch.where(wrapped, n_write - margin,
                              rb.write_pos + n_write).to(I32),
        rw_wrap=torch.where(wrapped, DIFF_WRAP, rb.rw_wrap).to(I32))


def read(rb: RingBuffer, count: int):
    """WebRtc_ReadBuffer (ring_buffer.c:97-140) on a batch of rings;
    `count` is static.  Returns (values (B, count) int32, new ring).
    Samples past each ring's readable count are zeroed here, outside the
    data pass (the C API leaves them unspecified)."""
    from . import ring_kernels
    n_read = available_read(rb).clamp(max=count)
    gathered = ring_kernels.ring_gather(rb.data, rb.read_pos, count)
    mask = torch.arange(count, device=n_read.device) < n_read[..., None]
    values = torch.where(mask, gathered.to(I32), 0)
    return values, move_read_ptr(rb, n_read)


def _contig_write(data, pos, values, n_write):
    """Batched wrapped write: row b gets values[b, :n_write[b]] at
    [pos[b], pos[b] + n_write[b]) mod C.  data (B, C); pos, n_write (B,);
    values (B, n) int32, stored with the C cast to data's type.  Returns a
    new tensor.  The plain version of ring_kernels.ring_write."""
    cap = data.shape[-1]
    n = values.shape[-1]
    offset = torch.remainder(
        torch.arange(cap, device=data.device)[None, :] - pos[:, None].long(),
        cap)
    vals = spl.to_w16(values).to(data.dtype)
    placed = torch.gather(vals, 1, offset.clamp(max=n - 1))
    return torch.where(offset < n_write[:, None].long(), placed, data)


def _contig_read(data, pos, count: int):
    """Batched wrapped read of `count` values at [pos, pos + count) mod C:
    data (B, C), pos (B,) -> (B, count) of data's type.  The plain version
    of ring_kernels.ring_gather."""
    cap = data.shape[-1]
    idx = torch.remainder(
        pos[:, None].long() + torch.arange(count, device=data.device)[None, :],
        cap)
    return torch.gather(data, 1, idx)
