"""The benchmark's plain reference: WebRTC AECM in plain PyTorch.

A frozen copy of the port's batch-major plain path (control.py, core.py,
delay_estimator.py, ops/fft.py, ops/spl.py, ops/ring_buffer.py, tables.py,
defines.py), with the jitter ring's CUDA kernels replaced by their plain
versions.  It imports nothing of the port and takes nothing the port made:
it starts every stream from Init and works out each output from the
generated audio alone.  `Reference` runs a batch of streams one 10 ms chunk
at a time (BufferFarend then Process, the reference demo's loop,
main.cc:124-141); on the card each group of chunks is one CUDA graph of
these same operations, captured and replayed, so that the reference's
thousands of small operations a chunk do not pay a Python launch each.
"""
from __future__ import annotations

import torch

from . import control, core
from ._tree import tree_leaves, tree_map

I32 = torch.int32
CHUNKS_PER_GRAPH = 8


def create_batch(n_streams: int, sample_rate: int, device, cng_mode: int = 1,
                 echo_mode: int = 3) -> control.AecmState:
    """n_streams freshly Create+Init'ed instances, then set_config'ed,
    leaves (n_streams, ...)."""
    one = control.set_config(control.create(sample_rate, device=device),
                             cng_mode, echo_mode)
    return tree_map(lambda leaf: leaf.expand((n_streams,) + leaf.shape
                                             ).contiguous(), one)


def chunk_step(state, far, near, ms, sample_rate: int, opts, clean=None):
    """One 10 ms chunk for every stream: far, near (B, chunk) int32, ms
    (B,) int32, clean (B, chunk) int32 or None (one near input).  Returns
    (state, out (B, chunk) int32, warn (B,))."""
    mult = sample_rate // 8000
    chunk = min(160, sample_rate // 100)
    state = control.buffer_farend(state, far, mult)
    return control.process(state, near, clean, chunk, ms, sample_rate, opts)


class Reference:
    """n_streams streams of WebRTC AECM from Init (with cng_mode and
    echo_mode set), fed chunk by chunk.

    run(far, near, ms, clean=None) takes (n_chunks, B, chunk) int16 or
    int32 audio on any device (clean: the clean near input of two, or None)
    and ms (B,), and returns (out (n_chunks, B, chunk) int32, warn
    (n_chunks, B) int32) on the host; every call of one Reference has a
    clean input or none.  It computes the exact
    magnitudes only; the benchmark's control is the program's own
    abs_approx path (control.py)."""

    def __init__(self, n_streams: int, sample_rate: int, device,
                 cng_mode: int = 1, echo_mode: int = 3):
        self.device = torch.device(device)
        self.rate = sample_rate
        self.chunk = min(160, sample_rate // 100)
        self.opts = core.Options()
        self.state = create_batch(n_streams, sample_rate, self.device,
                                  cng_mode, echo_mode)
        self.k = CHUNKS_PER_GRAPH if self.device.type == "cuda" else 1
        self._graph = None

    def _chunks(self, state, far, near, ms, clean):
        outs, warns = [], []
        for i in range(far.shape[0]):
            state, out, warn = chunk_step(
                state, far[i], near[i], ms, self.rate, self.opts,
                None if clean is None else clean[i])
            outs.append(out)
            warns.append(warn)
        return state, torch.stack(outs), torch.stack(warns)

    def _capture(self, ms, has_clean: bool):
        """A graph of self.k chunks on static buffers (far, near, and the
        clean near when there is one); the state it ends with is copied
        back into the buffers it starts from."""
        b = self.state.ec_startup.shape[0]
        shape = (self.k, b, self.chunk)
        self._far = torch.zeros(shape, dtype=I32, device=self.device)
        self._near = torch.zeros(shape, dtype=I32, device=self.device)
        self._clean = (torch.zeros(shape, dtype=I32, device=self.device)
                       if has_clean else None)
        self._ms = ms.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):      # one-time constants, off graph
            copy = tree_map(lambda x: x.clone(), self.state)
            self._chunks(copy, self._far, self._near, self._ms, self._clean)
        torch.cuda.current_stream(self.device).wait_stream(side)
        del copy
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            new, self._out, self._warn = self._chunks(
                self.state, self._far, self._near, self._ms, self._clean)
            _write_back(self.state, new)

    def run(self, far, near, ms, clean=None):
        far, near, clean = (None if x is None else
                            torch.as_tensor(x).to(self.device, I32)
                            for x in (far, near, clean))
        ms = torch.as_tensor(ms).to(self.device, I32)
        n = far.shape[0]
        outs, warns = [], []
        if self.device.type != "cuda":
            self.state, out, warn = self._chunks(self.state, far, near, ms,
                                                 clean)
            return out.cpu(), warn.cpu()
        if self._graph is None:
            self._capture(ms, clean is not None)
        self._ms.copy_(ms)
        for lo in range(0, n - n % self.k, self.k):
            self._far.copy_(far[lo:lo + self.k])
            self._near.copy_(near[lo:lo + self.k])
            if clean is not None:
                self._clean.copy_(clean[lo:lo + self.k])
            self._graph.replay()
            outs.append(self._out.clone())
            warns.append(self._warn.clone())
        if n % self.k:                      # the tail, eagerly
            lo = n - n % self.k
            new, out, warn = self._chunks(
                self.state, far[lo:], near[lo:], self._ms,
                None if clean is None else clean[lo:])
            _write_back(self.state, new)
            outs.append(out)
            warns.append(warn)
        return torch.cat(outs).cpu(), torch.cat(warns).cpu()


def _write_back(dst_tree, src_tree):
    """Copy a step's new state into the state it started from, leaf by
    leaf; a new leaf that shares memory with a leaf written is copied
    first."""
    dst = tree_leaves(dst_tree)
    src = tree_leaves(src_tree)
    written = {d.untyped_storage().data_ptr() for d in dst}
    src = [s.clone() if s is not d and s.untyped_storage().data_ptr()
           in written else s for s, d in zip(src, dst)]
    for s, d in zip(src, dst):
        if s is not d:
            d.copy_(s)
