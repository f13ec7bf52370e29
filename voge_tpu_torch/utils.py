"""Small math helpers (counterpart of ``voge_tpu/utils.py``)."""
from __future__ import annotations

import torch

from voge_tpu_torch._device import resolve_device


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


def _pad_index(target_shape, ind: torch.Tensor, dim: int) -> torch.Tensor:
    """``ind`` with trailing singleton dims, expanded to ``target_shape``
    beyond ``dim`` (``torch.gather`` with an expanded index)."""
    ind_pad = ind.reshape(ind.shape + (1,) * (len(target_shape) - (dim + 1)))
    return ind_pad.expand(tuple(ind.shape[: dim + 1]) + tuple(target_shape[dim + 1:]))


def _expand_leading(target: torch.Tensor, ind: torch.Tensor, dim: int) -> torch.Tensor:
    """``target`` with its size-1 dims before ``dim`` expanded to ``ind``'s."""
    lead = tuple(ind.shape[k] if target.shape[k] == 1 else target.shape[k]
                 for k in range(dim))
    return target.expand(lead + tuple(target.shape[dim:]))


def ind_sel(target: torch.Tensor, ind: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Broadcast-aware gather along ``dim`` (reference ``Utils.py:13-31``):
    ``target`` ``[... (k or 1), n, ...]``, ``ind`` ``[... (k), M]`` ->
    ``[... (k), M, ...]``."""
    if ind.ndim <= dim:
        raise ValueError(f"index must have the target dim {dim}, got shape {tuple(ind.shape)}")
    target = _expand_leading(target, ind, dim)
    return torch.gather(target, dim, _pad_index(target.shape, ind.long(), dim))


def ind_fill(target: torch.Tensor, ind: torch.Tensor, src, dim: int = 1) -> torch.Tensor:
    """Broadcast-aware scatter along ``dim`` (reference ``Utils.py:34-56``;
    overwrite).  Returns a new tensor; ``src`` is a tensor broadcast to the
    padded index, or a scalar."""
    if ind.ndim <= dim:
        raise ValueError(f"index must have the target dim {dim}, got shape {tuple(ind.shape)}")
    target = _expand_leading(target, ind, dim)
    ind_pad = _pad_index(target.shape, ind.long(), dim)
    if isinstance(src, torch.Tensor):
        src = src.to(target.dtype).expand(ind_pad.shape)
    else:
        src = torch.full(ind_pad.shape, src, dtype=target.dtype, device=target.device)
    return target.scatter(dim, ind_pad, src)


def inverse_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x + sum(x) - cumsum(x)`` along ``dim`` (reference ``Aggregation.py:7``)."""
    return x + x.sum(dim, keepdim=True) - x.cumsum(dim)


def rotation_theta(theta, dtype=torch.float32, device=None) -> torch.Tensor:
    """In-plane (z-axis) rotation matrices (n, 3, 3) from angles: a float or
    a tensor of shape (n,) / (n, 1, 1) (reference ``Utils.py:336-359``).
    ``device=None``: the device of ``theta`` when it is a tensor, else the
    card (``_device.resolve_device``)."""
    theta = torch.as_tensor(theta, dtype=dtype,
                            device=resolve_device(device, theta)).reshape(-1)
    cos, sin = torch.cos(theta), torch.sin(theta)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    rows = torch.stack([cos, -sin, zeros, sin, cos, zeros, zeros, zeros, ones], dim=-1)
    return rows.reshape(-1, 3, 3)
