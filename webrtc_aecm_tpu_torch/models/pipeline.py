"""AecmPipeline: the flagship batched streaming echo-cancellation model.

Port of webrtc_aecm_tpu/models/pipeline.py.  One object owns N concurrent
AECM streams (the reference's "N instances", echo_control_mobile.cc:89-99)
and exposes the two serving shapes:

  * `step(far, near[, clean], ms)`: one 10 ms real-time step for all
    streams;
  * `run(far, near[, clean], ms)`: whole signals.

Two engines, bit-exact with each other: "fused" (fused.py: the lane-major
state, one frames kernel and one ring kernel per step on the card; `step`
is the one-chunk step with the newest-first far history, `run` is
run_streams_fused) and "xla", the JAX package's name kept for the
batch-major engine (parallel/batch.py: one ChunkStep per 10 ms), so that
code moving between the packages changes nothing.  "auto" takes the fused
engine on the card and the batch-major one on the CPU, as the JAX package
takes the fused one on a TPU only.  With `mesh=` (parallel/sharding.py)
the streams split over the mesh's devices: each holds its slice of the
state in the engine's layout and runs its own step; the outputs come back
on the mesh's first device.

The serving calls are compiled, as the JAX package jits them
(compiled.py): `step` replays its 10 ms step, captured once per input
signature as a CUDA graph on the card (one a shard with a mesh), and keeps
its state in the graph's buffers (donation: `self.state` is those buffers
after a step, and the next step updates them in place); `run` replays the
engine's step chunk by chunk and keeps the state it returns.  `load`,
`reset_streams`, `set_config` and `init_echo_paths` stay eager (the JAX
package jits them too, but they are one-off calls); the state they set is
copied into the graph's buffers at the next step.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _device, control, convert
from .. import fused as fused_mod
from .._tree import tree_map
from ..compiled import compile_step
from ..parallel import batch as pbatch
from ..parallel import sharding as psharding
from ..tracing import span

I32 = torch.int32


class AecmPipeline:
    """Batched AECM serving pipeline.

    Args:
      n_streams: number of concurrent independent streams.
      sample_rate: 8000 or 16000.
      cng_mode / echo_mode: runtime config, per AecmConfig
        (echo_control_mobile.h:32-35); scalars apply to all streams.
      engine: "fused", "xla" (the batch-major engine) or "auto".
      device: where the state lives (the CUDA card unless the caller asks
        for another); with a mesh, its first device, which is the default.
      mesh: keyword only, a `parallel.sharding.Mesh` (make_mesh); the state
        and the audio split on the stream axis over its devices
        (n_streams must divide by its size).  The JAX signature has mesh
        fifth; here engine and device keep their places and mesh follows.
    """

    def __init__(self, n_streams: int, sample_rate: int = 16000,
                 cng_mode: int = 1, echo_mode: int = 3,
                 engine: str = "auto", device=None, *, mesh=None):
        if sample_rate not in (8000, 16000):
            raise ValueError("sample_rate must be 8000 or 16000")
        if mesh is not None:
            if n_streams % mesh.size:
                raise ValueError(f"n_streams {n_streams} does not divide "
                                 f"over a mesh of {mesh.size} devices")
            if device is not None and \
                    torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.devices[0]}")
            device = mesh.devices[0]
        self.mesh = mesh
        self.device = _device.resolve(device)
        if engine == "auto":
            engine = "fused" if self.device.type == "cuda" else "xla"
        if engine not in ("fused", "xla"):
            raise ValueError("engine must be 'fused', 'xla', or 'auto'")
        self.n_streams = n_streams
        self.sample_rate = sample_rate
        self.chunk = min(160, sample_rate // 100)
        self.engine = engine
        self._set_canonical(pbatch.create_batch(
            n_streams, sample_rate, cng_mode, echo_mode, device=self.device))
        self._step = {}

    # -- engine layout adapters ---------------------------------------------
    def _canonical(self) -> control.AecmState:
        """The batch-leading AecmState view of the current state (with a
        mesh, the shards gathered on the first device)."""
        state = self.state
        if self.mesh is not None:
            state = psharding.gather_streams(
                state, self.mesh, psharding.fused_state_spec()
                if self.engine == "fused" else 0)
        if self.engine == "fused":
            return fused_mod.from_fused_state(state)
        return state

    def _set_canonical(self, state: control.AecmState) -> None:
        if self.engine == "fused":
            state = fused_mod.to_fused_state(state)
            if self.mesh is not None:
                state = psharding.shard_streams_fused(state, self.mesh)
        elif self.mesh is not None:
            state = psharding.shard_streams(state, self.mesh)
        self.state = state

    # -- config -------------------------------------------------------------
    def set_config(self, cng_mode, echo_mode) -> None:
        """Per-stream WebRtcAecm_set_config (scalars or (n_streams,))."""
        self._set_canonical(pbatch.set_config_batch(
            self._canonical(), cng_mode, echo_mode))

    def get_echo_paths(self) -> np.ndarray:
        """(n_streams, 65) stored channels (WebRtcAecm_GetEchoPath,
        batched)."""
        return control.get_echo_path(self._canonical()).cpu().numpy(
        ).astype(np.int16)

    def init_echo_paths(self, echo_paths) -> None:
        """Restore stored channels; echo_paths: (65,) or (n_streams, 65)."""
        ep = torch.as_tensor(np.asarray(echo_paths), dtype=I32,
                             device=self.device).expand(self.n_streams, 65)
        self._set_canonical(control.init_echo_path(self._canonical(), ep))

    # -- checkpoint / resume --------------------------------------------------
    def save(self, path: str) -> None:
        """Checkpoint the full serving state (all streams) to an .npz file
        in the JAX package's format (convert.save_checkpoint), which its
        AecmPipeline.load reads."""
        convert.save_checkpoint(path, self._canonical(), self.sample_rate)

    def load(self, path: str) -> None:
        """Resume from a checkpoint written by save() here or in the JAX
        package; its (n_streams, sample_rate) must be this pipeline's."""
        self._set_canonical(convert.load_checkpoint(
            path, self._canonical(), self.sample_rate, self.device))

    def reset_streams(self, indices) -> None:
        """Re-Init selected streams in place (a caller hung up, a new call
        took the slot) without touching the other streams' state;
        WebRtcAecm_Init on those slots (echo_control_mobile.cc:142-191),
        with the default config {cngMode=on, echoMode=3}."""
        mask = np.zeros((self.n_streams,), bool)
        mask[np.asarray(indices)] = True
        m = torch.as_tensor(mask, device=self.device)
        fresh = pbatch.create_batch(self.n_streams, self.sample_rate,
                                    device=self.device)

        def sel(new, cur):
            return torch.where(m.view((-1,) + (1,) * (cur.ndim - 1)), new,
                               cur)
        self._set_canonical(tree_map(sel, fresh, self._canonical()))

    # -- serving ------------------------------------------------------------
    def _get_step(self, has_clean: bool):
        """The 10 ms step, compiled (compiled.py: captured once per input
        signature as a CUDA graph on the card, as the JAX package jits it),
        donating its state: self.state is then the graph's state buffers,
        which the next step overwrites in place."""
        if has_clean not in self._step:
            if self.mesh is not None:
                make = (psharding.make_sharded_step_fused
                        if self.engine == "fused"
                        else psharding.make_sharded_step)
                self._step[has_clean] = make(self.sample_rate, self.mesh,
                                             has_clean=has_clean,
                                             donate=True)
            elif self.engine == "fused":
                self._step[has_clean] = compile_step(
                    fused_mod.make_fused_chunk_step(
                        self.sample_rate, has_clean=has_clean,
                        device=self.device), donate=True,
                    name="AecmPipeline.step (fused)")
            else:
                self._step[has_clean] = compile_step(
                    pbatch.make_chunk_step(self.sample_rate, has_clean,
                                           device=self.device),
                    donate=True, name="AecmPipeline.step (batch-major)")
        return self._step[has_clean]

    def _audio(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, device=self.device).to(I32)

    def step(self, far, near, clean=None, ms_in_sndcard_buf=40):
        """One 10 ms step: far/near[/clean] (n_streams, chunk) -> (out
        (n_streams, chunk) int32, warn (n_streams,)); BufferFarend +
        Process per stream (main.cc:124-141 demo loop, batched).  The step
        is compiled and donates its state (_get_step): afterwards
        self.state holds the graph's state buffers, which the next step
        updates in place."""
        with span("step"):
            with span("step.inputs"):
                ms = _device.as_int32(ms_in_sndcard_buf, self.device).expand(
                    self.n_streams)
                audio = [self._audio(x) for x in (far, near) + (
                    () if clean is None else (clean,))]
            fn = self._get_step(clean is not None)
            self.state, out, warn = fn(self.state, *audio, ms)
        return out, warn

    def run(self, far, near, clean=None, ms_in_sndcard_buf=40):
        """Whole signals: (n_streams, n_samples) -> out (n_streams,
        n_chunks * chunk) int32; samples past the last whole chunk are
        dropped (the reference demo does the same, main.cc:121-123).  It
        replays the engine's compiled step chunk by chunk (run_streams_fused
        / run_streams, which convert the audio to int32) and keeps the
        state it returns, its own copy."""
        run = (fused_mod.run_streams_fused if self.engine == "fused"
               else pbatch.run_streams)
        if self.mesh is None:
            self.state, out = run(self.state, far, near, self.sample_rate,
                                  ms_in_sndcard_buf, clean=clean)
            return out
        far, near = self._audio(far), self._audio(near)
        clean = None if clean is None else self._audio(clean)
        # each device runs its slice; ms goes to (n_chunks, n_streams)
        # so that it splits on the stream axis
        n_chunks = near.shape[-1] // self.chunk
        ms = torch.as_tensor(ms_in_sndcard_buf, dtype=I32)
        if ms.ndim == 1 and ms.shape[0] != self.n_streams:
            ms = ms[:, None]
        ms = ms.expand(n_chunks, self.n_streams)
        by_stream = psharding.StreamSharding(self.mesh, 0)
        pieces = [by_stream.split(x) for x in (far, near)] + (
            [] if clean is None else [by_stream.split(clean)])
        ms = psharding.StreamSharding(self.mesh, 1).split(ms)
        new, outs = [], []
        for k, dev in enumerate(self.mesh.devices):
            with psharding.on_device(dev):
                st, out = run(self.state[k], pieces[0][k], pieces[1][k],
                              self.sample_rate, ms[k],
                              clean=None if clean is None else pieces[2][k])
            new.append(st)
            outs.append(out)
        self.state = new
        return by_stream.gather(outs)
