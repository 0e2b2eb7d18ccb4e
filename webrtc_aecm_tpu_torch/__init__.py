"""PyTorch + CUDA port of the fused AECM serving path.

A second package beside the JAX reference `webrtc_aecm_tpu`: the same fused
lane-major state and step (16 kHz, 2 chunks per step, circular far
history), in PyTorch, with the TPU kernels rewritten as CUDA C++ for Hopper
(csrc/).  It imports torch and numpy, never jax.
"""
from .fused import (FusedAecm, FusedState, create_fused,  # noqa: F401
                    run_streams_fused)
