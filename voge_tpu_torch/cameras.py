"""Pinhole camera model with PyTorch3D conventions (counterpart of
``voge_tpu/cameras.py``).

- world to view is the row-vector transform ``x_view = x_world @ R + T``;
- the camera looks along +z in view space;
- screen-space cameras (``in_ndc=False``, the only kind supported) project
  with the mirrored convention ``x_screen = px - fx * x_view / z_view``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.utils import inv3x3


def _as_batched(x, last_dim: int, dtype, device) -> torch.Tensor:
    """Scalars / sequences / tensors -> (N, last_dim)."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    if x.ndim == 0:
        x = x.reshape(1, 1)
    elif x.ndim == 1:
        x = x[:, None]
    if x.shape[-1] == 1 and last_dim > 1:
        x = x.expand(x.shape[:-1] + (last_dim,))
    if x.shape[-1] != last_dim:
        raise ValueError(f"expected last dim {last_dim}, got {tuple(x.shape)}")
    return x


def camera_position_from_spherical_angles(
    distance, elevation, azimuth, degrees: bool = True,
    at=((0.0, 0.0, 0.0),), dtype=torch.float32, device=None,
) -> torch.Tensor:
    """Camera centres ``x = d cos(e) sin(a), y = d sin(e), z = d cos(e) cos(a)``
    (+ ``at``).  ``device=None``: a tensor argument's device, else the card
    (``_device.resolve_device``)."""
    device = resolve_device(device, distance, elevation, azimuth, at)
    vals = [torch.as_tensor(v, dtype=dtype, device=device).reshape(-1)
            for v in (distance, elevation, azimuth)]
    n = max(v.shape[0] for v in vals)
    dist, elev, azim = (v.expand(n) for v in vals)
    if degrees:
        elev = elev * (math.pi / 180.0)
        azim = azim * (math.pi / 180.0)
    x = dist * torch.cos(elev) * torch.sin(azim)
    y = dist * torch.sin(elev)
    z = dist * torch.cos(elev) * torch.cos(azim)
    return torch.stack([x, y, z], dim=-1) + torch.as_tensor(
        at, dtype=dtype, device=device)


def look_at_rotation(camera_position, at=((0.0, 0.0, 0.0),),
                     up=((0.0, 1.0, 0.0),), dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Rotation R (N, 3, 3) with ``x_view = x_world @ R`` pointing the camera
    at ``at`` (PyTorch3D ``look_at_rotation``).  ``device=None``: a tensor
    argument's device, else the card (``_device.resolve_device``)."""
    device = resolve_device(device, camera_position, at, up)
    C = torch.as_tensor(camera_position, dtype=dtype, device=device)
    C = C.reshape(-1, 3)
    at = torch.as_tensor(at, dtype=dtype, device=device).expand(C.shape)
    up = torch.as_tensor(up, dtype=dtype, device=device).expand(C.shape)

    def normalize(v, eps=1e-5):
        return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(eps)

    z_axis = normalize(at - C)
    x_axis = normalize(torch.linalg.cross(up, z_axis, dim=-1))
    y_axis = normalize(torch.linalg.cross(z_axis, x_axis, dim=-1))
    # degenerate case: up parallel to z -> replace the x axis
    is_close = torch.all(
        torch.isclose(x_axis, torch.zeros_like(x_axis), atol=5e-3),
        dim=-1, keepdim=True,
    )
    replacement = normalize(torch.linalg.cross(y_axis, z_axis, dim=-1))
    x_axis = torch.where(is_close, replacement, x_axis)
    R = torch.stack((x_axis, y_axis, z_axis), dim=1)  # rows = axes
    return R.transpose(1, 2)                          # columns = axes


def look_at_view_transform(
    dist=1.0, elev=0.0, azim=0.0, degrees: bool = True,
    eye: Optional[Sequence] = None, at=((0.0, 0.0, 0.0),),
    up=((0.0, 1.0, 0.0),), dtype=torch.float32, device=None,
):
    """(R, T) for cameras looking at ``at`` (PyTorch3D-compatible).
    ``device=None``: a tensor argument's device, else the card
    (``_device.resolve_device``); pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device, eye, dist, elev, azim, at, up)
    if eye is not None:
        C = torch.as_tensor(eye, dtype=dtype, device=device).reshape(-1, 3)
    else:
        C = camera_position_from_spherical_angles(
            dist, elev, azim, degrees=degrees, at=at, dtype=dtype,
            device=device,
        )
    R = look_at_rotation(C, at, up, dtype=dtype, device=device)
    T = -torch.einsum("nij,nj->ni", R.transpose(1, 2), C)
    return R, T


class PerspectiveCameras:
    """Batch of screen-space pinhole cameras (the subset of
    ``pytorch3d.renderer.PerspectiveCameras`` the renderer uses).  ``R``,
    ``T``, ``focal`` and ``principal`` are plain tensors and may be
    reassigned, as the renderer does from its call kwargs.  ``device=None``:
    the device of a tensor among ``R``, ``T``, ``focal_length``,
    ``principal_point``, else the card (``_device.resolve_device``); pass
    ``device="cpu"`` for the CPU."""

    def __init__(
        self,
        focal_length: Union[float, Sequence, torch.Tensor] = 1.0,
        principal_point=((0.0, 0.0),),
        R: Optional[torch.Tensor] = None,
        T: Optional[torch.Tensor] = None,
        image_size=((256, 256),),
        in_ndc: bool = False,
        dtype=torch.float32,
        device=None,
    ):
        self._in_ndc = bool(in_ndc)
        self.dtype = dtype
        self.device = resolve_device(device, R, T, focal_length, principal_point)
        self.focal_length = _as_batched(focal_length, 2, dtype, self.device)
        self.principal_point = _as_batched(principal_point, 2, dtype, self.device)
        if isinstance(image_size, int):
            image_size = ((image_size, image_size),)
        hw = torch.as_tensor(image_size).reshape(-1, 2).tolist()
        self.image_size = tuple(tuple(int(v) for v in p) for p in hw)
        n_r = 1 if R is None else torch.as_tensor(R).reshape(-1, 3, 3).shape[0]
        n = max(self.focal_length.shape[0], self.principal_point.shape[0], n_r)
        eye = torch.eye(3, dtype=dtype, device=self.device)
        self.R = (eye.expand(n, 3, 3) if R is None else torch.as_tensor(
            R, dtype=dtype, device=self.device).reshape(-1, 3, 3))
        self.T = (torch.zeros(n, 3, dtype=dtype, device=self.device)
                  if T is None else torch.as_tensor(
                      T, dtype=dtype, device=self.device).reshape(-1, 3))

    def in_ndc(self) -> bool:
        return self._in_ndc

    @property
    def focal(self):
        return self.focal_length

    @focal.setter
    def focal(self, value):
        self.focal_length = _as_batched(value, 2, self.dtype, self.device)

    @property
    def principal(self):
        return self.principal_point

    @principal.setter
    def principal(self, value):
        self.principal_point = _as_batched(value, 2, self.dtype, self.device)

    def to(self, device) -> "PerspectiveCameras":
        self.device = torch.device(device)
        for name in ("R", "T", "focal_length", "principal_point"):
            setattr(self, name, getattr(self, name).to(self.device))
        return self

    def __len__(self):
        return self.R.shape[0]

    def batched_params(self, batch: Optional[int] = None):
        """(R, T, focal, principal) broadcast to a common batch size."""
        n = batch if batch is not None else max(
            self.R.shape[0], self.T.shape[0],
            self.focal_length.shape[0], self.principal_point.shape[0],
        )
        return (self.R.expand(n, 3, 3), self.T.expand(n, 3),
                self.focal_length.expand(n, 2),
                self.principal_point.expand(n, 2))

    def get_camera_center(self) -> torch.Tensor:
        R, T, _, _ = self.batched_params()
        return camera_centers(R, T)


def camera_centers(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """World-space camera centres C with ``C @ R + T = 0``, through an
    explicit inverse as the reference does (``RayTracing.py:45``)."""
    return -torch.einsum("bj,bji->bi", T, inv3x3(R))
