"""Host-side utilities: WAV I/O, quality metrics, the demo CLI.

The port of webrtc_aecm_tpu/utils: small native-Python replacements for the
reference's harness pieces (dr_wav.h's WAV loader, timing.h's wall clock,
main.cc's demo).  They run on the host, outside the serving path; `wav` and
`metrics` are numpy-only copies of the JAX package's modules, and `cli`
drives the port's AecmPipeline.
"""
from .wav import read_wav_int16, write_wav_int16
from .metrics import erle_db, segment_erle_db

__all__ = ["read_wav_int16", "write_wav_int16", "erle_db", "segment_erle_db"]
