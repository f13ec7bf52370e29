"""Ray generation (counterpart of ``voge_tpu/rays.py``): unit world-space
directions through every pixel centre plus per-camera origins, in the
mirrored screen convention of :mod:`voge_tpu_torch.cameras`."""
from __future__ import annotations

from typing import Tuple

import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import camera_centers
from voge_tpu_torch.utils import inv3x3


def pixel_dirs_view(image_size: Tuple[int, int], focal: torch.Tensor,
                    principal: torch.Tensor) -> torch.Tensor:
    """View-space (unnormalised) directions ``((px - j - 0.5) / fx,
    (py - i - 0.5) / fy, 1)``, shape (B, H, W, 3)."""
    H, W = int(image_size[0]), int(image_size[1])
    kw = dict(dtype=focal.dtype, device=focal.device)
    jj = torch.arange(W, **kw) + 0.5
    ii = torch.arange(H, **kw) + 0.5
    x = (principal[:, 0, None, None] - jj[None, None, :]) / focal[:, 0, None, None]
    y = (principal[:, 1, None, None] - ii[None, :, None]) / focal[:, 1, None, None]
    B = focal.shape[0]
    x = x.expand(B, H, W)
    y = y.expand(B, H, W)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def camera_rays(R: torch.Tensor, T: torch.Tensor, focal: torch.Tensor,
                principal: torch.Tensor, image_size: Tuple[int, int]):
    """(rays (B, H, W, 3) unit world directions, origins (B, 3))."""
    d_view = pixel_dirs_view(image_size, focal, principal)
    d_world = torch.einsum("bhwj,bji->bhwi", d_view, inv3x3(R))
    d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    return d_world, camera_centers(R, T)


def get_ray_camera_space(img_size, principle, focal, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Camera-space pinhole ray grid (H, W, 3) of unit directions (the
    reference's ``Aggregation.py:11-27`` helper, in its legacy negated-xy
    convention with integer pixel coordinates; the renderer itself uses
    :func:`camera_rays`).  ``device``: None for the device of a tensor
    argument, else the card (``_device.resolve_device``)."""
    dev = resolve_device(device, principle, focal)
    focal = torch.as_tensor(focal, dtype=dtype, device=dev).reshape(-1)
    if focal.shape[0] == 1:
        focal = focal.expand(2)
    principle = torch.as_tensor(principle, dtype=dtype, device=dev)
    h, w = img_size
    i = torch.arange(h, dtype=dtype, device=dev)[:, None] * torch.ones((1, w), dtype=dtype,
                                                                       device=dev)
    j = torch.ones((h, 1), dtype=dtype, device=dev) * torch.arange(w, dtype=dtype,
                                                                  device=dev)[None, :]
    dirs = torch.stack([-(j - principle[1]) / focal[1], -(i - principle[0]) / focal[0],
                        torch.ones_like(i)], dim=-1)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
