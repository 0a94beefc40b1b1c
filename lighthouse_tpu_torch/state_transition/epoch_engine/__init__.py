"""The epoch engine of the PyTorch/CUDA port: registry-wide epoch
processing over a struct-of-arrays snapshot (``soa.py``) on two CUDA
kernels (``cuda/kernel.py``, ``csrc/k_epoch.cu``), and the batched
swap-or-not shuffle (``shuffle.py``) on the hash engine.

Entry point: ``api.try_process_epoch(state, types, preset, spec)`` — True
when the engine processed the epoch (the post-state equals the scalar
``per_epoch`` path's byte for byte), False when the caller should run the
scalar path (backend "python", a registry under the threshold, the base
fork, a genesis-edge epoch or a state outside the uint64 envelope).  A
fault restores the justification snapshot and raises.
"""
from .api import (  # noqa: F401
    configure,
    engine_status,
    last_stage_rows,
    reset_engine,
    try_process_epoch,
)
