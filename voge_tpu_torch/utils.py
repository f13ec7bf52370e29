"""Small math helpers (counterpart of ``voge_tpu/utils.py``)."""
from __future__ import annotations

import torch


def eye_like(tensor: torch.Tensor) -> torch.Tensor:
    """Identity matrices broadcast to ``tensor``'s batch shape."""
    n = tensor.shape[-1]
    eye = torch.eye(n, dtype=tensor.dtype, device=tensor.device)
    return eye.expand(tensor.shape[:-2] + (n, n))


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..., 3, 3) matrices, with the same
    term order as ``voge_tpu.utils.inv3x3``."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    rows = torch.stack([A, D, G, B, E, H, C, F, I], dim=-1) / det[..., None]
    return rows.reshape(m.shape)
