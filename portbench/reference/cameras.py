"""Plain camera model of the reference, in any floating dtype and
differentiable: PyTorch3D's look-at convention (``x_view = x_world @ R + T``,
the camera looking along +z), screen-space pinhole rays in the mirrored
convention ``x_screen = px - fx * x_view / z_view``, and VoGE's in-plane
rotation.  Written from those conventions; it imports nothing of the program.
"""
from __future__ import annotations

import torch


def _normalize(v: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(eps)


def look_at(dist: torch.Tensor, elev: torch.Tensor, azim: torch.Tensor,
            theta: torch.Tensor | None = None):
    """(R (n, 3, 3), T (n, 3)) of cameras on a sphere about the origin,
    angles in radians, looking at the origin with +y up; ``theta`` rotates
    the camera in its image plane (``R @ Rz(theta)``, T unchanged)."""
    C = torch.stack([dist * torch.cos(elev) * torch.sin(azim), dist * torch.sin(elev),
                     dist * torch.cos(elev) * torch.cos(azim)], -1)
    up = torch.zeros_like(C)
    up[:, 1] = 1.0
    z = _normalize(-C)
    x = _normalize(torch.linalg.cross(up, z, dim=-1))
    y = _normalize(torch.linalg.cross(z, x, dim=-1))
    R = torch.stack((x, y, z), dim=1).transpose(1, 2)
    T = -torch.einsum("nij,nj->ni", R.transpose(1, 2), C)
    if theta is not None:
        c, s = torch.cos(theta), torch.sin(theta)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        Rz = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], -1).reshape(-1, 3, 3)
        R = R @ Rz
    return R, T


def rays(R: torch.Tensor, T: torch.Tensor, focal: torch.Tensor, principal: torch.Tensor,
         hw: tuple[int, int]):
    """(unit world directions (B, H * W, 3) through every pixel centre, row
    by row, camera centres (B, 3)) of cameras (R, T, focal (B, 2), principal
    (B, 2)); the centre C solves ``C @ R + T = 0``."""
    H, W = hw
    kw = dict(dtype=focal.dtype, device=focal.device)
    jj = torch.arange(W, **kw) + 0.5
    ii = torch.arange(H, **kw) + 0.5
    x = ((principal[:, 0, None, None] - jj[None, None, :]) / focal[:, 0, None, None]).expand(-1, H, W)
    y = ((principal[:, 1, None, None] - ii[None, :, None]) / focal[:, 1, None, None]).expand(-1, H, W)
    d_view = torch.stack([x, y, torch.ones_like(x)], -1).reshape(R.shape[0], H * W, 3)
    Rinv = torch.linalg.inv(R)
    d = d_view @ Rinv
    centres = -torch.einsum("bj,bji->bi", T, Rinv)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True), centres
