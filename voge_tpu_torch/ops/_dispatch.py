"""What every kernel wrapper shares: the device decision, argument checks and
the ctypes call conventions.

A wrapper runs its plain PyTorch version only when its tensors lie on the
CPU.  On CUDA tensors it launches its kernel or raises; it never falls back.

The launch path is kept short, since at the port's shapes many kernels run for
microseconds: :func:`bind` hands out each C entry with its ``argtypes`` set
once (a dict lookup after the first call, no lock), :func:`stream` reads the
raw handle of the current stream without building a ``torch.cuda.Stream``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import torch

from voge_tpu_torch._build import load

VOIDP = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float

_bound: dict = {}                 # (library, symbol) -> ctypes function
_bind_lock = threading.Lock()


def bind(lib: str, symbol: str, argtypes: Sequence, restype=INT):
    """The C entry ``symbol`` of ``csrc/<lib>.cu``, built and loaded at its
    first call, with ``argtypes`` and ``restype`` assigned that once."""
    fn = _bound.get((lib, symbol))
    if fn is not None:
        return fn
    with _bind_lock:
        fn = _bound.get((lib, symbol))
        if fn is None:
            fn = getattr(load(lib), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _bound[(lib, symbol)] = fn
    return fn


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version).  Raises on a mix of devices or any other device."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if dev is None:
            dev = t.device
        elif t.device != dev:
            devices = {x.device for x in tensors if x is not None}
            raise ValueError(f"tensors must share one device, got {devices}")
    if dev is None:
        raise ValueError("tensors must share one device, got none")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev.type == "cuda"


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Raise unless ``t`` has ``dtype``, ``shape`` (when given), is
    contiguous and 16-byte aligned; return it."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() & 15:
        raise ValueError(f"{name}: must be 16-byte aligned")
    return t


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    """The raw handle of the current stream of ``device``, a tensor's CUDA
    device (so its index is set).  PyTorch's own generated code (Inductor)
    reads it this way; ``torch.cuda.current_stream`` builds a Stream object a
    call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {err}")
