"""Tensor conventions and argument checks shared by the kernel wrappers.

32-bit words (limbs, SHA-256 words) travel as ``int32`` tensors holding
their uint32 bit patterns; the plain PyTorch versions compute on ``int64``
tensors masked to 32 bits (this torch has no shifts or additions for
``uint32`` on the CPU).  A wrapper checks each argument with ``check``,
runs the plain version when its tensors lie on the CPU (``on_cpu``) and
launches its CUDA kernel when they lie on a card.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def to_i64(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 non-negative words."""
    return t.to(torch.int64) & M32


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns."""
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


def check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_aligned(name: str, *ts) -> None:
    """Kernels that load 16 bytes a thread need 16-byte aligned data."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data not 16-byte aligned")


def resolve_device(device, who: str) -> torch.device:
    """The device an entry point runs on: the card (``device=None``)
    unless the caller asks for the CPU, where the plain versions run.  A
    CUDA device without a card raises: there is no fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device (pass device='cpu' to run "
                           "the plain versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: unsupported device {dev}")
    return dev


def on_cpu(device: torch.device) -> bool:
    """True for the CPU (the plain version runs), False for a CUDA device
    (the kernel launches); anything else is refused."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cpu"


def empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)
