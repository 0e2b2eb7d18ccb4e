"""Compiled steps: the port's counterpart of `jax.jit` for fixed-shape steps.

The JAX package runs each serving call as one compiled program (a jitted
step, or a `lax.scan` of one).  Here a step is captured once per input
signature into a `torch.cuda.CUDAGraph` on the card and replayed from then
on, so that a call costs one graph launch instead of the eager glue's
hundreds of small launches from Python.

`compile_step(fn, carry=..., donate=...)` returns a `CompiledStep`, called
like `fn`.  Its cache is keyed like jit's: the shape, dtype and device of
every tensor leaf of the arguments (nested NamedTuples, tuples, lists and
dicts), plus the values of every other leaf (ints, bools, None: the
"static" arguments, such as a step's chunk count or `debug`).  The first
call of a key

  1. copies the tensor leaves into the key's static input buffers
     (contiguous tensors that keep their addresses for the graph's life),
  2. runs a warm-up of `fn` on copies of them on a side stream, so that the
     caller's state is not advanced: it builds the kernels and makes the C
     side's one-time host calls (the frames kernel's shared-memory opt-in,
     its occupancy query), which must never happen first inside a capture,
  3. captures `fn` on the static buffers with `torch.cuda.graph`, and
  4. replays it.

Every later call copies each tensor leaf into its static buffer (the copy
is skipped when the leaf already *is* that buffer) and replays.  `carry`
names the outputs that are the new value of an argument (the state): the
graph writes them back into that argument's static buffers, so the next
call's state is already in place.  Other outputs are cloned out of the
graph's buffers, so that nothing a caller holds changes under a later call.
The carried outputs are cloned too unless `donate=True`, which returns the
static buffers themselves (the JAX package's donation): an owner that
passes them back at the next call (AecmPipeline, AecmInstance, the loops
of run_streams_fused / run_streams) skips the copy, and must know that the
next call overwrites them.

A replay runs no Python, so the kernel wrappers' launch counters
(fused_kernel.frames_kernel_call.launches, ops/ring_kernels.py) cannot
count it: the capture records how many launches of each kernel the graph
holds, and each replay adds them.  The warm-up and the capture count
nothing.  Each step counts its replays (`replays`; on the CPU's
static-buffer path, the runs of the body in their place), and names its
stages with tracing.py's spans (`aecm.compiled.*`); tracing.counters()
sums the counters over every live step.

A failed capture or replay raises and names the step; nothing falls back
to the eager step on the card.  `disable_graphs()` (as `jax.disable_jit()`)
runs the eager step instead, for tests and timing.  On the CPU the eager
step runs unless the caller asks for the static-buffer path with
`static_buffers_on_cpu()`: the same body, run eagerly without capture, so
that the CPU tests cover every line but the capture and the replay.

Inside a step nothing may read a tensor on the host (`.item()`, `int()`,
`bool()`, a data-dependent shape) or make a tensor from host data
(`torch.tensor`, `torch.as_tensor` of a number or an array): either one
synchronises or copies from pageable memory, and both break a capture.
Constants are made once per device (fused.Tables, core._consts,
_device.const), and the host's data enters through the static input
buffers.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple, Optional

import torch

from . import tracing

_mode = threading.local()     # .graphs (bool), .cpu_static (bool)


def graphs_enabled() -> bool:
    return getattr(_mode, "graphs", True)


@contextlib.contextmanager
def disable_graphs():
    """Within the block every compiled step runs its eager function, as
    under `jax.disable_jit()`."""
    old = graphs_enabled()
    _mode.graphs = False
    try:
        yield
    finally:
        _mode.graphs = old


@contextlib.contextmanager
def static_buffers_on_cpu():
    """Within the block a compiled step on the CPU runs its static-buffer
    path (inputs copied into static buffers, the body run eagerly on them,
    the state written back, the outputs cloned out) instead of the eager
    function: what the card captures, without the capture."""
    old = getattr(_mode, "cpu_static", False)
    _mode.cpu_static = True
    try:
        yield
    finally:
        _mode.cpu_static = old


# ---------------------------------------------------------------------------
# Trees: NamedTuples, tuples, lists and dicts of tensors and static values
# ---------------------------------------------------------------------------

class _Static(NamedTuple):
    """A leaf that is not a tensor: part of the cache key."""
    value: object


def _flatten(tree, leaves: list):
    """Append tree's leaves to `leaves`; return its structure, hashable, with
    each tensor leaf's shape, dtype and device (the cache key)."""
    if torch.is_tensor(tree):
        leaves.append(tree)
        return ("T", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree),) + tuple(_flatten(x, leaves) for x in tree)
    if isinstance(tree, (tuple, list)):
        return (type(tree),) + tuple(_flatten(x, leaves) for x in tree)
    if isinstance(tree, dict):
        return (dict, tuple(tree)) + tuple(_flatten(tree[k], leaves)
                                           for k in tree)
    try:
        hash(tree)
    except TypeError:
        raise TypeError(f"a compiled step takes tensors and hashable static "
                        f"values; got a {type(tree).__name__}") from None
    leaves.append(_Static(tree))
    return ("V", type(tree), tree)


def _unflatten(spec, leaves):
    """Rebuild a tree of `spec` from an iterator of leaves."""
    kind = spec[0]
    if kind == "T":
        return next(leaves)
    if kind == "V":
        return next(leaves).value
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2:])}
    kids = [_unflatten(s, leaves) for s in spec[1:]]
    if hasattr(kind, "_fields"):
        return kind(*kids)
    return kind(kids)


def _n_leaves(spec) -> int:
    if spec[0] in ("T", "V"):
        return 1
    return sum(_n_leaves(s) for s in spec[2 if spec[0] is dict else 1:])


def _kids(spec):
    return spec[2:] if spec[0] is dict else spec[1:]


def _span(spec, path) -> slice:
    """The leaves of the subtree at `path` (indices into spec's children,
    None for the whole tree) as a slice of the flat leaf list."""
    if path is None:
        return slice(0, _n_leaves(spec))
    kids = _kids(spec)
    lo = sum(_n_leaves(s) for s in kids[:path])
    return slice(lo, lo + _n_leaves(kids[path]))


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------

def _counts():
    return [w.launches for w in tracing.LAUNCH_COUNTERS]


def _set_counts(counts):
    for w, n in zip(tracing.LAUNCH_COUNTERS, counts):
        w.launches = n


_pools = {}    # CUDA device index -> the memory pool every graph there shares


def _pool(device: torch.device):
    """One memory pool per card for all graphs: each graph's outputs stay
    referenced and replays run one after another on the caller's stream, so
    the intermediates of one graph may reuse another's."""
    if device.index not in _pools:
        _pools[device.index] = torch.cuda.graph_pool_handle()
    return _pools[device.index]


# ---------------------------------------------------------------------------
# The compiled step
# ---------------------------------------------------------------------------

class _Entry:
    """One signature's static buffers, its graph (None on the CPU), the
    structure of its outputs and the launches the graph holds."""

    def __init__(self, static_in):
        self.static_in = static_in
        self.graph = None
        self.out_leaves = None
        self.out_spec = None
        self.carried = None     # [(input leaves, output leaves)] slices
        self.donated = None     # output leaves returned as static buffers
        self.launches = ()      # (kernel wrapper, launches in the graph)
        self.capture_s = 0.0


class CompiledStep:
    """`fn` compiled per input signature (see the module docstring).

    carry: pairs (argument index, output path) where the output at that
    path is the argument's new value; the path is an index into fn's output
    tuple, or None when fn returns the new value itself.  donate: return the
    carried outputs as the static buffers themselves rather than clones."""

    def __init__(self, fn, carry=((0, 0),), donate: bool = False,
                 name: Optional[str] = None):
        self.fn = fn
        self.carry = tuple(carry)
        self.donate = donate
        self.name = name or getattr(fn, "__name__", type(fn).__name__)
        self._entries = {}
        self.replays = 0
        tracing.live_steps.add(self)

    @property
    def n_graphs(self) -> int:
        """Graphs captured (static-buffer entries on the CPU): one per
        signature."""
        return len(self._entries)

    @property
    def capture_seconds(self) -> float:
        """Host seconds spent on the warm-ups and captures so far."""
        return sum(e.capture_s for e in self._entries.values())

    def __call__(self, *args):
        with tracing.span("compiled.key"):
            leaves = []
            spec = _flatten(args, leaves)
            dev = next((x.device for x in leaves if torch.is_tensor(x)),
                       None)
            eager = (not graphs_enabled() or dev is None
                     or (dev.type == "cpu"
                         and not getattr(_mode, "cpu_static", False)))
            entry = None if eager else self._entries.get(spec)
        if eager:
            return self.fn(*args)
        if dev.type not in ("cuda", "cpu"):
            raise RuntimeError(f"compiled step {self.name}: no graphs on "
                               f"{dev}")
        if entry is None:
            with tracing.span("compiled.capture"):
                entry = self._first_call(spec, leaves, dev)
        else:
            with tracing.span("compiled.copy_in"):
                for buf, x in zip(entry.static_in, leaves):
                    if torch.is_tensor(x) and x is not buf:
                        buf.copy_(x)
            with tracing.span("compiled.replay"):
                self._replay(entry, spec)
        with tracing.span("compiled.outputs"):
            return self._result(entry)

    def _replay(self, entry: _Entry, spec):
        """Replay the graph, and count the replay and the launches the
        graph holds; on the CPU run the body in the replay's place."""
        if entry.graph is None:
            self._body(entry, spec)
        else:
            try:
                entry.graph.replay()
            except Exception as e:
                raise RuntimeError(f"compiled step {self.name}: the replay "
                                   f"failed: {e}") from e
            for w, n in entry.launches:
                w.launches += n
        self.replays += 1

    def _body(self, entry: _Entry, spec):
        """fn on the static buffers, the carried outputs written back into
        them: what the graph holds."""
        static = entry.static_in
        out = self.fn(*_unflatten(spec, iter(static)))
        out_leaves = []
        out_spec = _flatten(out, out_leaves)
        carried = [(_span(spec, arg), _span(out_spec, path))
                   for arg, path in self.carry]
        pairs = []
        for (arg, path), (at, to) in zip(self.carry, carried):
            dst, src = static[at], out_leaves[to]
            if len(src) != len(dst):
                raise ValueError(f"compiled step {self.name}: output {path} "
                                 f"does not match argument {arg}")
            pairs += [(s, d) for s, d in zip(src, dst)
                      if torch.is_tensor(d) and s is not d]
        # an output that shares memory with a buffer written before it is
        # read is copied first
        written = {d.untyped_storage().data_ptr() for _, d in pairs}
        pairs = [(s.clone() if s.untyped_storage().data_ptr() in written
                  else s, d) for s, d in pairs]
        for s, d in pairs:
            d.copy_(s)
        entry.out_leaves, entry.out_spec = out_leaves, out_spec
        entry.carried = carried
        entry.donated = {i for _, to in carried if self.donate
                         for i in range(to.start, to.stop)}

    def _first_call(self, spec, leaves, dev) -> _Entry:
        """Static buffers for a new signature, all on the step's device
        (that of its first tensor; a tensor elsewhere is copied in at each
        call); on the card the warm-up, the capture and the first replay,
        on the CPU the body once."""
        t0 = time.perf_counter()
        entry = _Entry([torch.empty(x.shape, dtype=x.dtype, device=dev
                                    ).copy_(x) if torch.is_tensor(x) else x
                        for x in leaves])
        if dev.type == "cpu":
            self._replay(entry, spec)
            self._entries[spec] = entry
            return entry
        before = _counts()
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                copies = [x.clone() if torch.is_tensor(x) else x
                          for x in entry.static_in]
                self.fn(*_unflatten(spec, iter(copies)))
            torch.cuda.current_stream(dev).wait_stream(side)
            del copies
            warm = _counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=_pool(dev)):
                self._body(entry, spec)
            entry.launches = tuple(
                (w, a - b) for w, a, b in zip(tracing.LAUNCH_COUNTERS,
                                              _counts(), warm) if a != b)
        except Exception as e:
            _set_counts(before)
            raise RuntimeError(f"compiled step {self.name}: the capture "
                               f"failed: {e}") from e
        _set_counts(before)
        entry.graph = graph
        entry.capture_s = time.perf_counter() - t0
        self._entries[spec] = entry
        self._replay(entry, spec)
        return entry

    def _result(self, entry: _Entry):
        """fn's output: carried leaves from the static buffers (themselves
        when donating), every other tensor cloned out of the graph's."""
        out = list(entry.out_leaves)
        for at, to in entry.carried:
            out[to] = entry.static_in[at]
        out = [x.clone() if torch.is_tensor(x) and (
                   i not in entry.donated) else x for i, x in enumerate(out)]
        return _unflatten(entry.out_spec, iter(out))


def compile_step(fn, carry=((0, 0),), donate: bool = False,
                 name: Optional[str] = None) -> CompiledStep:
    """`fn` captured per input signature and replayed (see the module
    docstring).  The default carry is a step `fn(state, ...) -> (state,
    ...)`."""
    return CompiledStep(fn, carry, donate, name)
