"""Fixed-shape ring buffer: pointer math and the plain data passes.

Port of webrtc_aecm_tpu/ops/ring_buffer.py (reference: aecm/ring_buffer.
{h,c}).  The pointer functions work on any leading batch shape; `write`,
`read` and `read_frames` take a batch of rings, data (B, C) and pointers
(B,), the JAX functions under `jax.vmap`.  Here each runs its plain
version (`write_plain`, `read_frames_plain`) on every device.

Semantics replicated exactly, including partial writes clamped to free
space, negative `move_read_ptr` (buffer stuffing) clamped to free space, the
SAME_WRAP/DIFF_WRAP tracking, and a read/write position that comes to rest
exactly at `capacity` without wrapping (ring_buffer.c:196).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _device
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
    ec = _device.as_int32(element_count, readable.device)
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
    data (B, C) int16, values (B, n) int32, n static.  The write is clamped
    to each ring's free space (write_plain)."""
    data, write_pos, rw_wrap = write_plain(*rb, values)
    return RingBuffer(data, rb.read_pos, write_pos, rw_wrap)


def read_frames(rb: RingBuffer, count: int, n_frames: int, gate=None,
                whole_frames: bool = True):
    """n_frames reads of `count` samples in a row, each starting where the
    one before left the read pointer: the reads of one WebRtcAecm_Process
    call (echo_control_mobile.cc:357-380), by read_frames_plain.  Per ring and frame: have_data = (readable //
    count > 0) and gate; the frame holds min(readable, count) samples from
    the read position and zeros after them; the read pointer then advances
    by that many (WebRtc_MoveReadPtr), where have_data if whole_frames (as
    Process does), else wherever the gate is true (WebRtc_ReadBuffer).
    gate: (B,) bool, or None for all true.  Returns (frames (B, n_frames,
    count) int32, have_data (B, n_frames) bool, new ring)."""
    frames, have_data, read_pos, rw_wrap = read_frames_plain(
        *rb, gate, count, n_frames, whole_frames)
    return frames, have_data, RingBuffer(rb.data, read_pos, rb.write_pos,
                                         rw_wrap)


def read(rb: RingBuffer, count: int):
    """WebRtc_ReadBuffer (ring_buffer.c:97-140) on a batch of rings;
    `count` is static.  Returns (values (B, count) int32, new ring): the
    one-frame form of read_frames.  Samples past each ring's readable count
    are zero (the C API leaves them unspecified)."""
    frames, _, rb = read_frames(rb, count, 1, whole_frames=False)
    return frames[:, 0], rb


def write_plain(data, read_pos, write_pos, rw_wrap, values):
    """The ring write, all of it: the clamp
    to the free space, the store and the new write pointers.  Returns (new
    ring, write_pos, rw_wrap); `data` is not modified."""
    rb = RingBuffer(data, read_pos, write_pos, rw_wrap)
    n_write = available_write(rb).clamp(max=values.shape[-1])
    margin = rb.capacity - write_pos
    wrapped = n_write > margin
    return (_contig_write(data, write_pos, values, n_write),
            torch.where(wrapped, n_write - margin,
                        write_pos + n_write).to(I32),
            torch.where(wrapped, DIFF_WRAP, rw_wrap).to(I32))


def read_frames_plain(data, read_pos, write_pos, rw_wrap, gate, count: int,
                      n_frames: int, whole_frames: bool = True):
    """The frame reads, all of it: per frame
    the readable count, have_data, the gather, the zeros past the readable
    count and the pointer advance.  Returns (frames (B, n_frames, count)
    int32, have_data (B, n_frames) bool, read_pos, rw_wrap)."""
    rb = RingBuffer(data, read_pos, write_pos, rw_wrap)
    if gate is None:
        gate = torch.ones_like(read_pos, dtype=torch.bool)
    j = torch.arange(count, device=data.device)
    frames, haves = [], []
    for _ in range(n_frames):
        readable = available_read(rb)
        have = (torch.div(readable, count, rounding_mode="floor") > 0) & gate
        n_read = readable.clamp(max=count)
        gathered = _contig_read(data, rb.read_pos, count)
        frames.append(torch.where(j < n_read[:, None], gathered.to(I32), 0))
        haves.append(have)
        moved = move_read_ptr(rb, n_read)
        go = have if whole_frames else gate
        rb = rb._replace(
            read_pos=torch.where(go, moved.read_pos, rb.read_pos),
            rw_wrap=torch.where(go, moved.rw_wrap, rb.rw_wrap))
    return (torch.stack(frames, dim=1), torch.stack(haves, dim=1),
            rb.read_pos, rb.rw_wrap)


def _contig_write(data, pos, values, n_write):
    """Batched wrapped write: row b gets values[b, :n_write[b]] at
    [pos[b], pos[b] + n_write[b]) mod C.  data (B, C); pos, n_write (B,);
    values (B, n) int32, stored with the C cast to data's type.  Returns a
    new tensor.  The data pass of write_plain."""
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
    data (B, C), pos (B,) -> (B, count) of data's type.  The data pass of
    read_frames_plain."""
    cap = data.shape[-1]
    idx = torch.remainder(
        pos[:, None].long() + torch.arange(count, device=data.device)[None, :],
        cap)
    return torch.gather(data, 1, idx)
