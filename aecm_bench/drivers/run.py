"""The bulk drive: `AecmPipeline.run` on recorded pairs, call after call.

Every call hands the pipeline `bulk_call_s` seconds of every stream (far,
near, and the clean near where the configuration has two near inputs), the
next slice of the scene pool on the card (a view: the pipeline converts it
to int32 itself), and the pipeline carries the state from call to call.
The window runs whole calls, each waited for, until `--seconds` have
passed; the rate counts all the audio of all the calls over all the time.
The compared streams' outputs are kept on the card after each call.
"""
from __future__ import annotations

import time

import torch

from .. import scenes as scenes_mod
from . import capture_seconds, steps_called

perf = time.perf_counter


class Driver:
    def __init__(self, cell, seed: int, seconds: float, device, tracer):
        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device, self.tracer = cell, seed, device, \
            tracer
        self.seconds = seconds
        self.rate = cfg["sample_rate"]
        self.chunk = cfg["chunk_samples"]
        self.n = tr["n_streams"]
        self.call_len = int(round(cfg["bulk_call_s"] * self.rate))
        self.warm = tr["warmup_calls"]
        self.trace_s = tr["trace_s"]
        self.idx = cell.compared_streams(seed)
        self.program_patch = None

    def setup(self) -> dict:
        from webrtc_aecm_tpu_torch.models import AecmPipeline
        cfg, tr = self.cell.config, self.cell.traffic
        marks = [perf()]
        self.pool = scenes_mod.make_scenes(
            scenes_mod.SceneParams.from_traffic(tr), self.n, self.rate,
            cfg["scene_period_s"], self.seed, self.device,
            cfg["near_inputs"])
        self._sync()
        marks.append(perf())
        n_samples = self.pool.far.shape[1]
        if n_samples % self.call_len:
            raise ValueError(f"a call of {self.call_len} samples does not "
                             f"divide the scene period of {n_samples}")
        self.n_slices = n_samples // self.call_len
        self.idx_d = torch.as_tensor(self.idx, device=self.device)
        self.pipe = AecmPipeline(self.n, self.rate, cfg["cng_mode"],
                                 cfg["echo_mode"], engine="auto",
                                 device=self.device)
        if self.program_patch is not None:
            self.program_patch(self)
        self.kept = []
        marks.append(perf())
        with steps_called() as steps:
            for c in range(self.warm):
                t = perf()
                self._call(c)
                self._sync()
                self.warm_call_s = perf() - t
        marks.append(perf())
        self.setup_parts = dict(zip(
            ("scenes_s", "pipeline_s", "warmup_s"),
            (b - a for a, b in zip(marks, marks[1:]))))
        return {"capture_s": capture_seconds(steps)}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _call(self, c: int):
        s = (c % self.n_slices) * self.call_len
        cols = slice(s, s + self.call_len)
        clean = self.pool.clean
        with self.tracer.span("run_call"):
            out = self.pipe.run(self.pool.far[:, cols], self.pool.near[:, cols],
                                clean=None if clean is None
                                else clean[:, cols],
                                ms_in_sndcard_buf=self.pool.ms)
        with self.tracer.span("keep"):
            self.kept.append(out.index_select(0, self.idx_d))

    def window(self) -> dict:
        tr = self.tracer
        calls = 0
        last = self.warm_call_s
        t_start = perf()
        while True:
            # trace the calls that should end in the last trace_s seconds
            t_call = perf()
            if t_call - t_start + last >= self.seconds - self.trace_s:
                tr.start()
            self._call(self.warm + calls)
            with tr.span("sync"):
                self._sync()
            calls += 1
            now = perf()
            last = now - t_call
            if now - t_start >= self.seconds:
                break
        window_s = now - t_start
        tr.stop()
        audio_s = calls * self.call_len / self.rate
        return {
            "metrics": {"streams_rt": self.n * audio_s / window_s},
            "notes": {"calls": calls, "window_s": window_s,
                      "call_s_mean": window_s / calls,
                      **self.setup_parts},
            "attempted": calls * self.n,
            "steps_traced": None,
        }

    def host_spans(self) -> dict:
        return {}

    def free(self):
        self.kept = [k.cpu() for k in self.kept]
        del self.pipe
        self.ref_audio = tuple(None if x is None else
                               x.index_select(0, self.idx_d).cpu()
                               for x in self.pool)
        del self.pool

    def compared(self):
        """(program out (K, S, chunk), None, reference inputs: far, near (K,
        S, chunk) int16, ms (S,), clean (K, S, chunk) int16 or None), K the
        chunks of every call run."""
        far, near, ms, clean = self.ref_audio
        n_calls = len(self.kept)
        s = far.shape[0]
        out = torch.cat(self.kept, dim=1)                 # (S, calls * L)
        k = out.shape[1] // self.chunk

        def slices(x):
            if x is None:
                return None
            parts = [x[:, (c % self.n_slices) * self.call_len:
                       (c % self.n_slices + 1) * self.call_len]
                     for c in range(n_calls)]
            return torch.cat(parts, dim=1).view(s, k, self.chunk
                                                ).transpose(0, 1)
        prog = out.view(s, k, self.chunk).transpose(0, 1).numpy()
        return prog, None, (slices(far), slices(near), ms, slices(clean))
