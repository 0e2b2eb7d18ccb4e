"""PyTorch + CUDA port of the AECM serving engines.

A second package beside the JAX reference `webrtc_aecm_tpu`: the fused
lane-major engine (fused.py: 16 kHz, 2 chunks per step, circular far
history) and the batch-major engine (parallel/batch.py: 8 and 16 kHz, with
or without a clean near input), in PyTorch, with the TPU kernels rewritten
as CUDA C++ for Hopper (csrc/).  The entry points build on the CUDA card
unless the caller passes device="cpu".  It imports torch and numpy, never
jax.
"""
from .fused import (FusedAecm, FusedState, create_fused,  # noqa: F401
                    run_streams_fused)
