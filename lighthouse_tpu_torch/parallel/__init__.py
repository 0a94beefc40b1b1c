"""Multi-shard BLS batch verification: the counterpart of
``lighthouse_tpu/parallel`` (``sharded_verify``, ``ring``).  The dispatcher
(``parallel/dispatcher.py`` of the reference) moves with the node path."""
from .sharded_verify import (
    DEFAULT_MESH_MIN_SETS,
    Mesh,
    device_xmd_ok,
    firehose_fn,
    get_mesh,
    make_mesh,
    mesh_stats,
    mesh_wanted,
    multi_fn,
    reset_mesh_stats,
    shard_inputs,
    sharded_verify_batch_fn,
    sharded_verify_with_fallback,
    sharded_verify_with_fallback_async,
)
from .ring import ring_reduce_fp12, ring_sum_g2, ring_verify_batch_fn

__all__ = [
    "DEFAULT_MESH_MIN_SETS", "Mesh", "device_xmd_ok", "firehose_fn",
    "get_mesh", "make_mesh", "mesh_stats", "mesh_wanted", "multi_fn",
    "reset_mesh_stats", "ring_reduce_fp12", "ring_sum_g2",
    "ring_verify_batch_fn", "shard_inputs", "sharded_verify_batch_fn",
    "sharded_verify_with_fallback", "sharded_verify_with_fallback_async",
]
