"""Model-level pipelines: the ready-to-serve AECM configuration.

The reference's "model" is a single fixed pipeline (far jitter buffer ->
delay estimator -> NLMS channel -> Wiener/NLP -> CNG, aecm_core_c.cc:
368-711), packaged here as `AecmPipeline`, the flagship serving object:
batched, streaming in 10 ms steps or whole signals, on either engine.
"""
from .pipeline import AecmPipeline

__all__ = ["AecmPipeline"]
