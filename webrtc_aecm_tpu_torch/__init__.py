"""PyTorch + CUDA port of the AECM serving engines and their public API.

A second package beside the JAX reference `webrtc_aecm_tpu`: the fused
lane-major engine (fused.py: 8 and 16 kHz, any chunks per step, the 10 ms
real-time step, a single or a clean near input) and the batch-major engine
(parallel/batch.py), the public entry points `AecmInstance` (api.py) and
`AecmPipeline` (models/pipeline.py, on one device or split over several
with `mesh=`, parallel/sharding.py), the host utilities and the demo CLI
(utils/, `python -m webrtc_aecm_tpu_torch far.wav near.wav`), in PyTorch,
with the TPU kernels rewritten as CUDA C++ for Hopper (csrc/).  The steps
that the JAX package jits are compiled here (compiled.py: captured once
per input signature as a CUDA graph on the card and replayed).  The entry
points build on the CUDA card unless the caller passes device="cpu".  It
imports torch and numpy, never jax.
"""
from . import api
from . import compiled
from . import control
from . import core
from . import defines
from . import delay_estimator
from . import models
from . import parallel
from . import utils
from .api import AecmInstance, AecmState
from .fused import (FusedAecm, FusedState, create_fused,  # noqa: F401
                    make_fused_chunk_step, run_streams_fused)
from .models import AecmPipeline

__all__ = [
    "api", "compiled", "control", "core", "defines", "delay_estimator",
    "models", "parallel", "utils", "AecmInstance", "AecmState",
    "AecmPipeline",
]
