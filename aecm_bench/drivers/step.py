"""The real-time drive: `AecmPipeline.step` every 10 ms, open loop.

Ticks are due on a fixed schedule from the window's start; a tick that
comes late starts at once, and its latency counts from when it was due.
Each tick copies every stream's 10 ms of far and near audio, and of the
clean near audio where the configuration has two near inputs (int16, from
a pinned host pool laid out tick by tick), to the card, calls the step, and
copies the output (int32) and the warning flags back to pinned host memory,
as a server does; the latency ends when they are on the host.  The
compared streams' outputs are kept from the host copy after each tick.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import scenes as scenes_mod
from . import capture_seconds, steps_called

perf = time.perf_counter


def wait_until(due: float) -> bool:
    """Sleep, then spin the last 3 ms, until `due`; True when the loop came
    to it late (nothing to wait for)."""
    if perf() >= due:
        return True
    left = due - perf()
    if left > 0.004:
        time.sleep(left - 0.003)
    while perf() < due:
        pass
    return False


class Driver:
    def __init__(self, cell, seed: int, seconds: float, device, tracer):
        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device, self.tracer = cell, seed, device, \
            tracer
        self.rate = cfg["sample_rate"]
        self.chunk = cfg["chunk_samples"]
        self.n = tr["n_streams"]
        self.tick_s = tr["tick_ms"] / 1000
        self.warm = tr["warmup_ticks"]
        self.n_window = int(round(seconds / self.tick_s))
        self.n_trace = min(self.n_window, int(round(tr["trace_s"] /
                                                    self.tick_s)))
        self.idx = cell.compared_streams(seed)
        self.program_patch = None

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> dict:
        from webrtc_aecm_tpu_torch.models import AecmPipeline
        cfg, tr = self.cell.config, self.cell.traffic
        marks = [perf()]
        sc = scenes_mod.make_scenes(
            scenes_mod.SceneParams.from_traffic(tr), self.n, self.rate,
            cfg["scene_period_s"], self.seed, self.device,
            cfg["near_inputs"])
        self.period = sc.far.shape[1] // self.chunk
        pin = self.device.type == "cuda"
        if pin:
            torch.cuda.synchronize(self.device)
        marks.append(perf())
        # the channels: far, near, and the clean near of two near inputs
        audio = (sc.far, sc.near) + (() if sc.clean is None else (sc.clean,))
        self.pool = torch.empty((self.period, len(audio), self.n, self.chunk),
                                dtype=torch.int16, pin_memory=pin)
        step = 50
        for a in range(0, self.period, step):
            b = min(self.period, a + step)
            cols = slice(a * self.chunk, b * self.chunk)
            for j, x in enumerate(audio):
                self.pool[a:b, j].copy_(x[:, cols].reshape(
                    self.n, b - a, self.chunk).transpose(0, 1))
        idx = torch.as_tensor(self.idx, device=self.device)
        self.ref_audio = tuple(None if x is None else
                               x.index_select(0, idx).cpu() for x in sc)
        self.ms = sc.ms
        channels = len(audio)
        del sc, audio
        marks.append(perf())
        self.pipe = AecmPipeline(self.n, self.rate, cfg["cng_mode"],
                                 cfg["echo_mode"], engine="auto",
                                 device=self.device)
        if self.program_patch is not None:
            self.program_patch(self)
        self.in_d = torch.empty((channels, self.n, self.chunk),
                                dtype=torch.int16, device=self.device)
        # the step's keyword for the clean near input, none for one input
        self.clean_kw = {"clean": self.in_d[2]} if channels == 3 else {}
        self.stream = (torch.cuda.current_stream(self.device) if pin
                       else None)
        total = self.warm + self.n_window
        self.rec_out = np.zeros((total, len(self.idx), self.chunk), np.int32)
        self.rec_warn = np.zeros((total, len(self.idx)), np.int32)
        self.h_out = None
        marks.append(perf())
        with steps_called() as steps:
            for k in range(self.warm):
                self._tick(k)
        marks.append(perf())
        self.setup_parts = dict(zip(
            ("scenes_s", "pool_s", "pipeline_s", "warmup_s"),
            (b - a for a, b in zip(marks, marks[1:]))))
        return {"capture_s": capture_seconds(steps)}

    def _tick(self, k: int):
        """Tick k: copy in, step, copy out, wait for the output on the host;
        returns (host seconds in step, time the output was on the host)."""
        span = self.tracer.span
        with span("copy_in"):
            self.in_d.copy_(self.pool[k % self.period], non_blocking=True)
        t0 = perf()
        with span("step_call"):
            out, warn = self.pipe.step(self.in_d[0], self.in_d[1],
                                       ms_in_sndcard_buf=self.ms,
                                       **self.clean_kw)
        t1 = perf()
        if self.h_out is None:
            pin = self.stream is not None
            self.h_out = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=pin)
            self.h_warn = torch.empty(warn.shape, dtype=warn.dtype,
                                      pin_memory=pin)
            self.h_out_np, self.h_warn_np = self.h_out.numpy(), \
                self.h_warn.numpy()
        with span("copy_out"):
            self.h_out.copy_(out, non_blocking=True)
            self.h_warn.copy_(warn, non_blocking=True)
        with span("sync"):
            if self.stream is not None:
                self.stream.synchronize()
        done = perf()
        np.take(self.h_out_np, self.idx, axis=0, out=self.rec_out[k])
        self.rec_warn[k] = self.h_warn_np[self.idx]
        return t1 - t0, done

    # -- the window -----------------------------------------------------------
    def window(self) -> dict:
        n, tr = self.n_window, self.tracer
        lat = np.empty(n)
        host = np.empty(n)
        woke = []
        trace_from = n - self.n_trace
        t_start = perf()
        for i in range(n):
            if i == trace_from:
                tr.start()
            due = t_start + i * self.tick_s
            with tr.span("wait_tick"):
                was_late = wait_until(due)
            if not was_late:
                woke.append(perf() - due)
            with tr.span("service"):
                host[i], done = self._tick(self.warm + i)
            lat[i] = done - due
        tr.stop()
        self.host = host
        woke = np.asarray(woke) if woke else np.zeros(1)
        tenth = max(1, n // 10)
        return {
            "metrics": {"rt_p50_ms": float(np.median(lat) * 1e3),
                        "rt_p95_ms": float(np.percentile(lat, 95) * 1e3)},
            "notes": {"ticks": n,
                      "rt_p99_ms": float(np.percentile(lat, 99) * 1e3),
                      "rt_max_ms": float(lat.max() * 1e3),
                      "over_deadline": int((lat > self.tick_s).sum()),
                      "first_tenth_mean_ms": float(lat[:tenth].mean() * 1e3),
                      "last_tenth_mean_ms": float(lat[-tenth:].mean() * 1e3),
                      "generator_late_p99_us": float(
                          np.percentile(woke, 99) * 1e6),
                      "generator_late_max_us": float(woke.max() * 1e6),
                      "step_host_us_mean": float(host.mean() * 1e6),
                      **self.setup_parts},
            "attempted": n * self.n,
            "steps_traced": self.n_trace,
        }

    def host_spans(self) -> dict:
        """What the harness timed on the host, for the readers: the host
        seconds of every window tick's call into the step."""
        return {"step_host_s": self.host}

    # -- after the window -----------------------------------------------------
    def free(self):
        del self.pipe, self.pool, self.in_d, self.ms, self.clean_kw
        self.h_out = self.h_warn = self.h_out_np = self.h_warn_np = None

    def compared(self):
        """(program out (K, S, chunk), program warn (K, S) or None, reference
        inputs: far, near (K, S, chunk) int16, ms (S,), clean (K, S, chunk)
        int16 or None)."""
        far, near, ms, clean = self.ref_audio
        k = self.rec_out.shape[0]
        s = far.shape[0]
        ticks = torch.arange(k) % self.period

        def chunks(x):
            if x is None:
                return None
            return x.view(s, self.period, self.chunk)[:, ticks].transpose(0, 1)
        return self.rec_out, self.rec_warn, (chunks(far), chunks(near), ms,
                                             chunks(clean))
