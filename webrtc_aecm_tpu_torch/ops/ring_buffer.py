"""Fixed-shape ring buffer: pointer math and the plain data passes.

Port of webrtc_aecm_tpu/ops/ring_buffer.py (reference: aecm/ring_buffer.
{h,c}).  The pointer functions work on any leading batch shape; the data
passes `_contig_write`/`_contig_read` are the batched (B, C) forms, the
plain versions behind the jitter-ring kernel (ops/ring_kernels.py).

Semantics replicated exactly, including partial writes clamped to free
space, negative `move_read_ptr` (buffer stuffing) clamped to free space, the
SAME_WRAP/DIFF_WRAP tracking, and a read/write position that comes to rest
exactly at `capacity` without wrapping (ring_buffer.c:196).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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
    """WebRtc_CreateBuffer + WebRtc_InitBuffer (ring_buffer.c:53-85)."""
    z = torch.zeros((), dtype=I32, device=device)
    return RingBuffer(data=torch.zeros((capacity,), dtype=dtype,
                                       device=device),
                      read_pos=z, write_pos=z.clone(),
                      rw_wrap=torch.full((), SAME_WRAP, dtype=I32,
                                         device=device))


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


def _contig_write(data, pos, values, n_write):
    """Batched wrapped write: row b gets values[b, :n_write[b]] at
    [pos[b], pos[b] + n_write[b]) mod C.  data (B, C); pos, n_write (B,);
    values (B, n) int32, stored with the C cast to data's type.  Returns a
    new tensor."""
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
    data (B, C), pos (B,) -> (B, count) of data's type."""
    cap = data.shape[-1]
    idx = torch.remainder(
        pos[:, None].long() + torch.arange(count, device=data.device)[None, :],
        cap)
    return torch.gather(data, 1, idx)
