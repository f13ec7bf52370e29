"""Where the port puts the tensors it creates.

The port runs on the card unless the caller asks for the CPU: every
constructor or converter that turns numpy arrays, lists or scalars into
tensors takes ``device=None`` meaning ``torch.device("cuda")``.  A tensor
argument keeps its device.  Nothing probes ``torch.cuda.is_available()`` to
fall back: without a card, a caller who does not pass ``device="cpu"`` gets
PyTorch's own error.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = torch.device("cuda")


def resolve_device(device=None, *inputs) -> torch.device:
    """``device`` when given; else the device of the first tensor among
    ``inputs``; else :data:`DEFAULT_DEVICE` (the card).  Allocates nothing."""
    if device is not None:
        return torch.device(device)
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    return DEFAULT_DEVICE


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device``, with ``cuda`` without an index
    naming the current card, so that two spellings of one device compare
    equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
