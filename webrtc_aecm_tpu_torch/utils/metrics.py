"""Echo-cancellation quality metrics.

The reference ships no metrics (its only observability is #ifdef AEC_DEBUG
PCM taps, echo_control_mobile.cc:105-136); ERLE is the standard figure of
merit for AEC and the project's north-star quality gate ("ERLE within 1 dB
of the C reference", BASELINE.md).

A copy of webrtc_aecm_tpu/utils/metrics.py (the port imports nothing of
the JAX package); keep the two alike.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def erle_db(near: np.ndarray, out: np.ndarray,
            far: Optional[np.ndarray] = None,
            far_active_threshold: float = 100.0,
            skip_samples: int = 0) -> float:
    """Overall ERLE: 10·log10(P_near / P_out) over far-active samples.

    Args:
      near: microphone signal (echo + local), int16-range.
      out: echo-canceller output.
      far: optional far-end signal; when given, only samples where the
        far-end RMS (per 10 ms window) exceeds `far_active_threshold` count —
        ERLE is only defined while echo is actually present.
      skip_samples: leading samples to exclude (startup/convergence).
    """
    near = np.asarray(near, np.float64)[skip_samples:]
    out = np.asarray(out, np.float64)[skip_samples:]
    if far is not None:
        far = np.asarray(far, np.float64)[skip_samples:]
        win = 80
        n = len(far) // win
        rms = np.sqrt(np.mean(
            far[:n * win].reshape(n, win) ** 2, axis=1))
        mask = np.repeat(rms > far_active_threshold, win)
        near = near[:n * win][mask]
        out = out[:n * win][mask]
    p_near = np.mean(near ** 2) + 1e-10
    p_out = np.mean(out ** 2) + 1e-10
    return float(10.0 * np.log10(p_near / p_out))


def segment_erle_db(near: np.ndarray, out: np.ndarray,
                    frame: int = 160) -> np.ndarray:
    """Per-frame ERLE time series (dB), useful for convergence plots."""
    near = np.asarray(near, np.float64)
    out = np.asarray(out, np.float64)
    n = len(near) // frame
    pn = np.mean(near[:n * frame].reshape(n, frame) ** 2, axis=1) + 1e-10
    po = np.mean(out[:n * frame].reshape(n, frame) ** 2, axis=1) + 1e-10
    return 10.0 * np.log10(pn / po)
