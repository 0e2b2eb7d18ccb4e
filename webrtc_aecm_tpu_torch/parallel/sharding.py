"""Several devices: the stream axis split over a list of devices.

Port of webrtc_aecm_tpu/parallel/sharding.py.  AECM streams are
independent (the reference has no coupling between instances), so serving
on several devices is data parallelism over the stream axis with zero
collectives: each device of a 1-D mesh holds its slice of the streams'
state, in the engine's own layout, and runs its own step on it (its own
frames and ring launches, on its own current stream, inside
`torch.cuda.device(d)`).  Nothing synchronises the devices, so launches on
different cards overlap.  The audio is split in the step, and the outputs
come back concatenated on the stream axis on the mesh's first device: a
copy, not a collective.

Where the JAX package places one sharded array, the port keeps a list of
per-device pieces, one per mesh entry; `gather_streams` joins them again.
A mesh may name a device more than once (a card that
`torch.cuda.device_count()` reports, or "cpu" for the tests): each entry
is one shard.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence

import torch

from .. import _device
from .._tree import tree_map

STREAM_AXIS = "streams"
I32 = torch.int32


class Mesh(NamedTuple):
    """A 1-D mesh on the stream axis: the devices, in shard order."""
    devices: tuple
    axis_name: str = STREAM_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = STREAM_AXIS) -> Mesh:
    """A 1-D mesh over every CUDA device (or the given devices), named for
    the stream axis.  Unlike a JAX mesh it takes a device more than once
    (each entry is a shard), and "cuda" without an index means the current
    card.  Raises without a card unless only CPU devices are named."""
    if devices is None:
        _device.resolve(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = _device.resolve(d)
        if d.type == "cuda":
            index = torch.cuda.current_device() if d.index is None \
                else d.index
            if index >= torch.cuda.device_count():
                raise ValueError(f"no CUDA device {index}: "
                                 f"{torch.cuda.device_count()} visible")
            d = torch.device("cuda", index)
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(out), axis_name)


class StreamSharding(NamedTuple):
    """How a tensor lies over a mesh: split on `axis` (its stream axis) into
    mesh.size equal slices, slice k on mesh.devices[k].  The JAX package's
    NamedSharding(mesh, P(streams)) is axis 0."""
    mesh: Mesh
    axis: int = 0

    def split(self, x) -> list:
        """x's slices, each a contiguous copy on its device (a kernel may
        update a shard in place; x is never touched)."""
        x = torch.as_tensor(x)
        n, k = x.shape[self.axis], self.mesh.size
        if n % k:
            raise ValueError(f"{n} streams do not divide over a mesh of "
                             f"{k} devices")
        m = n // k
        return [x.narrow(self.axis, i * m, m).to(
                    d, copy=True, memory_format=torch.contiguous_format)
                for i, d in enumerate(self.mesh.devices)]

    def gather(self, pieces, device=None):
        """The slices joined on the stream axis, on `device` (the mesh's
        first device unless given)."""
        device = self.mesh.devices[0] if device is None else device
        return torch.cat([p.to(device) for p in pieces], dim=self.axis)


def stream_sharding(mesh: Mesh, axis_name: str = STREAM_AXIS
                    ) -> StreamSharding:
    """Split the leading (stream) axis; the JAX package's NamedSharding
    with P(streams).  axis_name must be the mesh's."""
    _check_axis(mesh, axis_name)
    return StreamSharding(mesh, 0)


def _check_axis(mesh: Mesh, axis_name: str):
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not "
                         f"{axis_name!r}")


def _split_tree(tree, mesh: Mesh, axis: int) -> list:
    """[tree on mesh.devices[k] with every leaf's slice k on `axis`]."""
    pieces = tree_map(StreamSharding(mesh, axis).split, tree)
    return [tree_map(lambda p, k=k: p[k], pieces) for k in range(mesh.size)]


def gather_streams(shards, mesh: Mesh, spec=0, device=None):
    """The inverse of shard_streams / shard_streams_fused: one tree with
    every leaf's shards joined on its stream axis, on `device` (the mesh's
    first device unless given).  spec is the stream axis of every leaf
    (0 for batch-leading trees) or a prefix tree of axes, as
    fused_state_spec gives.  The JAX package needs no such call: a sharded
    array is one array there."""
    if isinstance(spec, int):
        sh = StreamSharding(mesh, spec)
        return tree_map(lambda *xs: sh.gather(xs, device), *shards)
    return type(spec)(*(gather_streams([s[i] for s in shards], mesh,
                                       spec[i], device)
                        for i in range(len(spec))))


def shard_streams(tree, mesh: Mesh, axis_name: str = STREAM_AXIS) -> list:
    """Place every leaf of a batched tree with its stream axis split over
    the mesh: a list of mesh.size trees, tree k on mesh.devices[k] holding
    the k-th slice of the streams.  Each leaf of a batched `AecmState` (and
    each audio tensor) has shape (n_streams, ...); n_streams must divide
    by the mesh size (ValueError otherwise)."""
    _check_axis(mesh, axis_name)
    return _split_tree(tree, mesh, 0)


def fused_state_spec(axis_name: str = STREAM_AXIS):
    """The stream axis of each part of a FusedState: control leaves are
    batch-leading (B, ...), axis 0; core leaves are lane-major (rows, B),
    axis 1.  The JAX package returns the same prefix tree of
    PartitionSpecs, FusedState(ctrl=P(streams), core=P(None, streams))."""
    from .. import fused
    return fused.FusedState(ctrl=0, core=1)


def shard_streams_fused(fstate, mesh: Mesh,
                        axis_name: str = STREAM_AXIS) -> list:
    """Place a FusedState with its stream axis split (mixed layouts, as
    fused_state_spec says): a list of mesh.size FusedStates."""
    from .. import fused
    _check_axis(mesh, axis_name)
    spec = fused_state_spec(axis_name)
    return [fused.FusedState(ctrl=c, core=k) for c, k in zip(
        _split_tree(fstate.ctrl, mesh, spec.ctrl),
        _split_tree(fstate.core, mesh, spec.core))]


def on_device(device):
    """`torch.cuda.device(device)` for a card, nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedStep:
    """One step per mesh entry, each over its device's slice of the
    streams: step(shards, far, noisy[, clean], ms) -> (shards, out, warn).
    The audio ((n_streams, chunk), batch-leading) is split here; ms is a
    scalar or (n_streams,); out and warn come back joined on the mesh's
    first device.  Each shard's step runs with its device current."""

    def __init__(self, steps, mesh: Mesh, has_clean: bool):
        self.steps = steps
        self.mesh = mesh
        self.n_audio = 3 if has_clean else 2

    def __call__(self, shards, *args):
        if len(args) != self.n_audio + 1:
            raise TypeError(f"expected (shards, {self.n_audio} audio "
                            "tensors, ms)")
        sh = StreamSharding(self.mesh, 0)
        audio = [sh.split(x) for x in args[:-1]]
        ms = torch.as_tensor(args[-1], dtype=I32)
        ms = ([ms] * self.mesh.size if ms.ndim == 0 else sh.split(ms))
        new, outs, warns = [], [], []
        for k, (step, dev) in enumerate(zip(self.steps, self.mesh.devices)):
            with on_device(dev):
                st, out, warn = step(shards[k], *(a[k] for a in audio),
                                     ms[k].to(dev))
            new.append(st)
            outs.append(out)
            warns.append(warn)
        return new, sh.gather(outs), sh.gather(warns)


def make_sharded_step(sample_rate: int, mesh: Mesh, has_clean: bool = False,
                      axis_name: str = STREAM_AXIS) -> ShardedStep:
    """The batch-major 10 ms step (parallel.batch.ChunkStep), one per mesh
    device, over shard_streams' pieces.  Where the JAX package jits one
    shard_map program, the port calls each device's step in turn; the
    state stays on its devices between calls, and only the audio moves."""
    from .batch import make_chunk_step
    _check_axis(mesh, axis_name)
    return ShardedStep([make_chunk_step(sample_rate, has_clean, device=d)
                        for d in mesh.devices], mesh, has_clean)


def make_sharded_step_fused(sample_rate: int, mesh: Mesh,
                            use_kernel=None, has_clean: bool = False,
                            axis_name: str = STREAM_AXIS) -> ShardedStep:
    """The fused 10 ms step (fused.make_fused_chunk_step: one frames and
    one ring launch per device a step on the card), one per mesh device,
    over shard_streams_fused's pieces; audio batch-leading (B, chunk).
    use_kernel=None takes the kernels (CUDA tensors launch them, CPU
    tensors take the plain versions)."""
    from .. import fused
    _check_axis(mesh, axis_name)
    return ShardedStep([fused.make_fused_chunk_step(
        sample_rate, has_clean=has_clean,
        use_kernel=True if use_kernel is None else use_kernel, device=d)
        for d in mesh.devices], mesh, has_clean)
