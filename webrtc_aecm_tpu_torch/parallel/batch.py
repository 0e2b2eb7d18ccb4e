"""Batched AECM: N independent streams with a leading stream axis.

Port of webrtc_aecm_tpu/parallel/batch.py, the batch-major serving engine:
every leaf of the `control.AecmState` carries a leading (n_streams,) axis
and each operation runs all streams at once (the JAX package vmaps its
per-stream functions).  `make_chunk_step` gives the real-time step, one
10 ms chunk (BufferFarend then Process); `run_streams` loops it over whole
signals.

On CUDA tensors each chunk launches the jitter-ring kernels of
ops/ring_kernels.py once each, at 8 and at 16 kHz: one `ring_write`
(BufferFarend's write with its pointer arithmetic) and one `ring_read`
(every 80-sample frame that Process reads, with the counts, the zeroing,
have_data and the pointer advance).  Everything else is plain PyTorch.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from .. import _device, control
from .._tree import tree_map
from ..tracing import span

I32 = torch.int32


def create_batch(n_streams: int, sample_rate: int = 8000,
                 cng_mode: int = 1, echo_mode: int = 3,
                 device=None) -> control.AecmState:
    """N freshly Create+Init'ed instances as one state with (n_streams,
    ...) leaves (contiguous copies, not broadcast views), on `device` (the
    CUDA card unless the caller asks for another).  All streams start
    identical (the reference's Create+Init is deterministic,
    aecm_core.cc:179-473)."""
    one = control.set_config(control.create(sample_rate, device=device),
                             cng_mode, echo_mode)
    return tree_map(lambda leaf: leaf.expand((n_streams,) + leaf.shape
                                             ).contiguous(), one)


def _per_stream(x, n: int, like):
    return _device.as_int32(x, like.device).expand(n)


def set_config_batch(state: control.AecmState, cng_mode,
                     echo_mode) -> control.AecmState:
    """Per-stream WebRtcAecm_set_config; cng_mode / echo_mode are scalars
    (all streams) or (n_streams,)."""
    n = state.ec_startup.shape[0]
    return control.set_config(state,
                              _per_stream(cng_mode, n, state.ec_startup),
                              _per_stream(echo_mode, n, state.ec_startup))


def buffer_farend_batch(state: control.AecmState, farend,
                        mult: int = 1) -> control.AecmState:
    """WebRtcAecm_BufferFarend for every stream; farend (n_streams,
    80 * mult), converted to int32 here if it is of another type.  A
    column slice of a longer int32 signal goes to the write kernel as it
    is (rows strided, unit inner stride)."""
    return control.buffer_farend(state, torch.as_tensor(
        farend, device=state.ec_startup.device).to(I32), mult)


def process_batch(state: control.AecmState, nearend_noisy, nearend_clean,
                  out_len: int, ms_in_sndcard_buf, sample_rate: int):
    """WebRtcAecm_Process for every stream: nearend_noisy/clean
    (n_streams, out_len) (clean may be None); ms_in_sndcard_buf a scalar
    or (n_streams,).  Returns (state, out (n_streams, out_len), warn
    (n_streams,))."""
    dev = state.ec_startup.device
    clean = (None if nearend_clean is None
             else torch.as_tensor(nearend_clean, device=dev).to(I32))
    return control.process(
        state, torch.as_tensor(nearend_noisy, device=dev).to(I32), clean,
        out_len, ms_in_sndcard_buf, sample_rate)


class ChunkStep(nn.Module):
    """One 10 ms serving step for a batch: BufferFarend then Process (the
    per-chunk loop of the reference demo, main.cc:124-141, batched), the
    counterpart of the JAX package's make_chunk_step.

    forward(state, far, noisy, ms) -> (state, out, warn), or with
    has_clean forward(state, far, noisy, clean, ms): far / noisy / clean
    (n_streams, chunk) int16-range, chunk = 80 at 8 kHz and 160 at 16 kHz;
    ms a scalar or (n_streams,).  The inputs are moved to the step's
    device, which must be the state's.

    The step consumes its input state: on the card the jitter-ring write
    updates the ring in place (the ring's pointers are always new
    tensors).  Use the returned state."""

    def __init__(self, sample_rate: int, has_clean: bool = False,
                 device=None):
        super().__init__()
        if sample_rate not in (8000, 16000):
            raise ValueError("sample_rate must be 8000 or 16000")
        self.sample_rate = sample_rate
        self.has_clean = has_clean
        self.mult = sample_rate // 8000
        self.out_len = min(160, sample_rate // 100)
        self.device = _device.resolve(device)

    def forward(self, state: control.AecmState, far, noisy, *rest):
        if len(rest) != 1 + self.has_clean:
            raise TypeError("expected (state, far, noisy, "
                            + ("clean, " if self.has_clean else "")
                            + "ms)")
        clean, ms = rest if self.has_clean else (None, rest[0])
        if state.ec_startup.device != self.device:
            raise ValueError(f"the state is on {state.ec_startup.device}, "
                             f"the step on {self.device}")
        state = buffer_farend_batch(state, far, self.mult)
        return process_batch(state, noisy, clean, self.out_len, ms,
                             self.sample_rate)


def make_chunk_step(sample_rate: int, has_clean: bool = False,
                    device=None) -> ChunkStep:
    """The real-time entry point: a ChunkStep to call every 10 ms."""
    return ChunkStep(sample_rate, has_clean, device)


@functools.lru_cache(maxsize=8)
def _chunk_step(sample_rate: int, has_clean: bool, device):
    """run_streams' ChunkStep, compiled (compiled.py: one CUDA graph per
    input signature on the card, the JAX package's jitted scan body); it
    donates its state, which the loop passes back.  Kept, as jit keeps its
    cache: each signature holds a copy of a state in its static buffers."""
    from ..compiled import compile_step
    return compile_step(ChunkStep(sample_rate, has_clean, device),
                        donate=True, name=f"batch-major {sample_rate} Hz"
                        f"{', clean' if has_clean else ''}")


def run_streams(state: control.AecmState, far, near, sample_rate: int,
                ms_in_sndcard_buf=40, clean=None):
    """Whole signals for a batch of streams, one ChunkStep per 10 ms chunk,
    on the state's device.

    far / near / clean: (n_streams, n_samples) int16-range (clean may be
    None); samples past the last whole chunk are dropped.
    ms_in_sndcard_buf: a scalar, (n_streams,), (n_chunks,) or (n_chunks,
    n_streams).  Returns (final state, out (n_streams, n_chunks * chunk)
    int32).  The input state is not modified (the loop runs on a copy), and
    what it returns is its own.  Each chunk replays one compiled ChunkStep
    (compiled.py: captured once per input signature as a CUDA graph on the
    card; eager under compiled.disable_graphs() and on the CPU)."""
    with span("run"):
        dev = state.ec_startup.device
        chunk = min(160, sample_rate // 100)
        with span("run.inputs"):
            far = torch.as_tensor(far, device=dev).to(I32)
            near = torch.as_tensor(near, device=dev).to(I32)
            n_streams, n_samples = near.shape
            n_chunks = n_samples // chunk
            ms = torch.as_tensor(ms_in_sndcard_buf, dtype=I32, device=dev)
            if ms.ndim == 0 or (ms.ndim == 1 and ms.shape[0] == n_streams):
                ms_t = ms.expand(n_chunks, n_streams)
            elif ms.ndim == 1:
                ms_t = ms[:, None].expand(n_chunks, n_streams)
            else:
                ms_t = ms
            if clean is not None:
                clean = torch.as_tensor(clean, device=dev).to(I32)
            st = tree_map(lambda x: x.clone(), state)

        step = _chunk_step(sample_rate, clean is not None, dev)
        outs = []
        for c in range(n_chunks):
            cols = slice(c * chunk, (c + 1) * chunk)
            extra = () if clean is None else (clean[:, cols],)
            st, out, _ = step(st, far[:, cols], near[:, cols], *extra,
                              ms_t[c])
            outs.append(out)
        with span("run.outputs"):
            out = (torch.cat(outs, dim=-1) if outs
                   else near.new_zeros((n_streams, 0)))
            return tree_map(lambda x: x.clone(), st), out
