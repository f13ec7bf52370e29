"""What every kernel wrapper shares: the device decision, argument checks and
the ctypes call conventions.

A wrapper runs its plain PyTorch version only when its tensors lie on the
CPU.  On CUDA tensors it launches its kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

VOIDP = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version).  Raises on a mix of devices or any other device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors must share one device, got {devices}")
    kind = devices.pop().type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind == "cuda"


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Raise unless ``t`` has ``dtype``, ``shape`` (when given), is
    contiguous and 16-byte aligned; return it."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
    return t


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {err}")
