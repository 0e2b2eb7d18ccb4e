"""Batch and multi-device parallelism for AECM stream serving.

The port of webrtc_aecm_tpu/parallel: N independent calls are one batched
state with a leading stream axis (batch.py, the batch-major engine), and
the stream axis splits over several devices with zero collectives
(sharding.py).  The names are the JAX package's.
"""
from .batch import (
    create_batch,
    set_config_batch,
    buffer_farend_batch,
    process_batch,
    make_chunk_step,
    run_streams,
)
from .sharding import (
    make_mesh,
    stream_sharding,
    shard_streams,
    make_sharded_step,
    fused_state_spec,
    shard_streams_fused,
    make_sharded_step_fused,
    gather_streams,
)

__all__ = [
    "create_batch", "set_config_batch", "buffer_farend_batch",
    "process_batch", "make_chunk_step", "run_streams",
    "make_mesh", "stream_sharding", "shard_streams", "make_sharded_step",
    "fused_state_spec", "shard_streams_fused", "make_sharded_step_fused",
    "gather_streams",
]
