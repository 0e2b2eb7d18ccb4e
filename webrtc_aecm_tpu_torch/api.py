"""Public AECM API: the port of webrtc_aecm_tpu/api.py (echo_control_mobile.h).

Two surfaces:

  * Functional: `control.create/buffer_farend/process/...` re-exported
    here; state in, state out, on one stream's state as `create` makes it
    (the JAX package's sequence: create -> buffer_farend(s, far) ->
    process(s, near, None, n, ms, fs) -> (s, out (n,), warning)), or on a
    batch (leaves with a leading stream axis; `parallel.batch.create_batch`
    makes one).
  * `AecmInstance`: a stateful handle mirroring the reference lifecycle
    Create/Init/BufferFarend/Process/set_config/GetEchoPath
    (aecm/echo_control_mobile.h:46-202), with the same error codes for
    argument validation, over the batch-major engine on a batch of one.
    On the card each 10 ms chunk launches the jitter-ring write and read
    kernels once each.

Sample-domain convention: int16 PCM passed as numpy arrays; internally
int32-held int16-range fixed point.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _device, control
from . import core as core_mod
from . import defines as D
from . import delay_estimator as de
from .parallel import batch as pbatch

# Error codes (echo_control_mobile.h:23-30)
AECM_UNSPECIFIED_ERROR = D.AECM_UNSPECIFIED_ERROR
AECM_UNSUPPORTED_FUNCTION_ERROR = D.AECM_UNSUPPORTED_FUNCTION_ERROR
AECM_UNINITIALIZED_ERROR = D.AECM_UNINITIALIZED_ERROR
AECM_NULL_POINTER_ERROR = D.AECM_NULL_POINTER_ERROR
AECM_BAD_PARAMETER_ERROR = D.AECM_BAD_PARAMETER_ERROR
AECM_BAD_PARAMETER_WARNING = D.AECM_BAD_PARAMETER_WARNING

create = control.create
buffer_farend = control.buffer_farend
process = control.process
set_config = control.set_config
get_echo_path = control.get_echo_path
init_echo_path = control.init_echo_path
AecmState = control.AecmState

I32 = torch.int32


def echo_path_size_bytes() -> int:
    """WebRtcAecm_echo_path_size_bytes (echo_control_mobile.cc:530-532)."""
    return D.PART_LEN1 * 2


class AecmError(RuntimeError):
    def __init__(self, code: int):
        super().__init__(f"AECM error {code}")
        self.code = code


class AecmInstance:
    """Stateful handle over the functional API (one echo-cancelled stream).

    Mirrors the reference lifecycle: construction = Create+Init, then
    `buffer_farend(far)` + `process(near_noisy, near_clean, ms)` per 10 ms.
    The state is a batch of one on `device` (the CUDA card unless the
    caller asks for another).
    """

    def __init__(self, sample_rate: int = 8000, cng_mode: int = 1,
                 echo_mode: int = 3, abs_approx: bool = False,
                 robust_validation: bool = False, device=None):
        if sample_rate not in (8000, 16000):
            raise AecmError(AECM_BAD_PARAMETER_ERROR)
        self.sample_rate = sample_rate
        self.mult = sample_rate // 8000
        self.device = _device.resolve(device)
        self.opts = core_mod.Options(abs_approx=abs_approx,
                                     robust_validation=robust_validation)
        self.state = pbatch.create_batch(1, sample_rate, device=self.device)
        if robust_validation:
            de_near, _ = de.enable_robust_validation(
                self.state.core.de_near, 1)
            self.state = self.state._replace(
                core=self.state.core._replace(de_near=de_near))
        self.set_config(cng_mode, echo_mode)

    def set_control(self, delay: int = -1, nlp_flag: int = 1) -> None:
        """WebRtcAecm_Control (aecm_core.cc:477-482): fix the far/near
        delay (in 64-sample blocks; -1 re-enables the estimator) and
        toggle the NLP stage."""
        self.state = self.state._replace(
            core=core_mod.set_control(self.state.core, delay, nlp_flag))

    def delay_quality(self) -> float:
        """WebRtc_last_delay_quality (delay_estimator_wrapper.cc:513-517):
        reliability in [0, 1] of the current delay estimate."""
        return float(de.last_delay_quality(self.state.core.de_near)[0])

    # -- config ------------------------------------------------------------
    def set_config(self, cng_mode: int, echo_mode: int) -> None:
        """WebRtcAecm_set_config validation + apply."""
        if cng_mode not in (0, 1) or not (0 <= echo_mode <= 4):
            raise AecmError(AECM_BAD_PARAMETER_ERROR)
        self.state = pbatch.set_config_batch(self.state, cng_mode, echo_mode)

    def get_echo_path(self) -> np.ndarray:
        return control.get_echo_path(self.state)[0].cpu().numpy().astype(
            np.int16)

    def init_echo_path(self, echo_path) -> None:
        echo_path = np.asarray(echo_path)
        if echo_path.size != D.PART_LEN1:
            raise AecmError(AECM_BAD_PARAMETER_ERROR)
        self.state = control.init_echo_path(self.state, torch.as_tensor(
            echo_path.astype(np.int32).reshape(1, D.PART_LEN1),
            device=self.device))

    # -- streaming ---------------------------------------------------------
    def _validate_len(self, n: int) -> None:
        if n not in (80, 160):
            raise AecmError(AECM_BAD_PARAMETER_ERROR)

    def _row(self, x):
        return torch.as_tensor(np.asarray(x).astype(np.int32).reshape(1, -1),
                               device=self.device)

    def get_buffer_farend_error(self, farend, n_samples: int = None) -> int:
        """WebRtcAecm_GetBufferFarendError (echo_control_mobile.cc:195-213):
        standalone validation, 0 when BufferFarend would accept the call
        (construction = Create+Init, so the uninitialized case cannot
        arise)."""
        if farend is None:
            return AECM_NULL_POINTER_ERROR
        if n_samples is None:
            n_samples = np.asarray(farend).shape[-1]
        if n_samples not in (80, 160):
            return AECM_BAD_PARAMETER_ERROR
        return 0

    def buffer_farend(self, farend) -> None:
        """WebRtcAecm_BufferFarend (+ GetBufferFarendError validation)."""
        err = self.get_buffer_farend_error(farend)
        if err != 0:
            raise AecmError(err)
        self.state = pbatch.buffer_farend_batch(self.state,
                                                self._row(farend), self.mult)

    def process(self, nearend_noisy, nearend_clean, ms_in_sndcard_buf: int,
                debug: bool = False):
        """WebRtcAecm_Process.  Returns (out int16 ndarray, warning code);
        with debug=True also a dict of per-block debug taps (hnl, supGain,
        step size, delay, VAD, energies, delay quality) as numpy arrays of
        shape (n_frames, 2 blocks, ...)."""
        if nearend_noisy is None:
            raise AecmError(AECM_NULL_POINTER_ERROR)
        n = np.asarray(nearend_noisy).shape[-1]
        self._validate_len(n)
        clean = (None if nearend_clean is None
                 else self._row(nearend_clean))
        res = control.process(
            self.state, self._row(nearend_noisy), clean, n,
            int(ms_in_sndcard_buf), self.sample_rate,
            self.opts._replace(debug=debug))
        self.state, out, warn = res[:3]
        out = out[0].cpu().numpy().astype(np.int16)
        if debug:
            return out, int(warn[0]), {k: v[0].cpu().numpy()
                                       for k, v in res[3].items()}
        return out, int(warn[0])

    # -- bulk helper (the demo-CLI loop, main.cc:97-147) ---------------------
    def run_file_pair(self, far_pcm, near_pcm, ms_in_sndcard_buf: int = 40):
        """File-to-file processing: per 10 ms, BufferFarend then Process.

        Mirrors aecProcess (main.cc:97-147): frame size = min(160, fs/100),
        output overwrites the near signal in place.
        """
        far_pcm = np.asarray(far_pcm, dtype=np.int16)
        near_pcm = np.asarray(near_pcm, dtype=np.int16)
        samples = min(160, self.sample_rate // 100)
        n_chunks = len(near_pcm) // samples
        out = near_pcm.copy()
        for i in range(n_chunks):
            sl = slice(i * samples, (i + 1) * samples)
            self.buffer_farend(far_pcm[sl])
            o, _ = self.process(out[sl], None, ms_in_sndcard_buf)
            out[sl] = o
        return out
