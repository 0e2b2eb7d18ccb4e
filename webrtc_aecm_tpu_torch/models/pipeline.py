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
takes the fused one on a TPU only.  There is no `mesh` argument: several
cards are ROADMAP.md Queue 1 item 12.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _device, control, convert
from .. import fused as fused_mod
from .._tree import tree_map
from ..parallel import batch as pbatch

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
        for another).
    """

    def __init__(self, n_streams: int, sample_rate: int = 16000,
                 cng_mode: int = 1, echo_mode: int = 3,
                 engine: str = "auto", device=None):
        if sample_rate not in (8000, 16000):
            raise ValueError("sample_rate must be 8000 or 16000")
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
        """The batch-leading AecmState view of the current state."""
        if self.engine == "fused":
            return fused_mod.from_fused_state(self.state)
        return self.state

    def _set_canonical(self, state: control.AecmState) -> None:
        self.state = (fused_mod.to_fused_state(state)
                      if self.engine == "fused" else state)

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
        if has_clean not in self._step:
            if self.engine == "fused":
                self._step[has_clean] = fused_mod.make_fused_chunk_step(
                    self.sample_rate, has_clean=has_clean,
                    device=self.device)
            else:
                self._step[has_clean] = pbatch.make_chunk_step(
                    self.sample_rate, has_clean, device=self.device)
        return self._step[has_clean]

    def _audio(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, device=self.device).to(I32)

    def step(self, far, near, clean=None, ms_in_sndcard_buf=40):
        """One 10 ms step: far/near[/clean] (n_streams, chunk) -> (out
        (n_streams, chunk) int32, warn (n_streams,)); BufferFarend +
        Process per stream (main.cc:124-141 demo loop, batched)."""
        ms = torch.as_tensor(ms_in_sndcard_buf, dtype=I32,
                             device=self.device).expand(self.n_streams)
        fn = self._get_step(clean is not None)
        extra = () if clean is None else (self._audio(clean),)
        self.state, out, warn = fn(self.state, self._audio(far),
                                   self._audio(near), *extra, ms)
        return out, warn

    def run(self, far, near, clean=None, ms_in_sndcard_buf=40):
        """Whole signals: (n_streams, n_samples) -> out (n_streams,
        n_chunks * chunk) int32; samples past the last whole chunk are
        dropped (the reference demo does the same, main.cc:121-123)."""
        far, near = self._audio(far), self._audio(near)
        clean = None if clean is None else self._audio(clean)
        if self.engine == "fused":
            self.state, out = fused_mod.run_streams_fused(
                self.state, far, near, self.sample_rate, ms_in_sndcard_buf,
                clean=clean)
        else:
            self.state, out = pbatch.run_streams(
                self.state, far, near, self.sample_rate, ms_in_sndcard_buf,
                clean=clean)
        return out
