"""Carry scenes and cameras over from numpy arrays: the arrays a
``voge_tpu`` object exposes (``np.asarray(g.verts)``) or a saved scene
(``voge_tpu.checkpoint.save_scene``'s ``.npz``), without importing JAX."""
from __future__ import annotations

import numpy as np
import torch

from voge_tpu_torch.cameras import PerspectiveCameras
from voge_tpu_torch.meshes import GaussianMeshes


def scene_from_numpy(verts, sigmas, colors=None, device="cpu"):
    """(GaussianMeshes with float32 verts / sigmas on ``device``, colours as a
    float32 tensor or None)."""
    g = GaussianMeshes(np.array(verts, np.float32),
                       np.array(sigmas, np.float32), device=device)
    if colors is not None:
        colors = torch.as_tensor(np.array(colors, np.float32), device=device)
    return g, colors


def cameras_from_numpy(R, T, focal, principal, image_size, device="cpu"):
    """Screen-space ``PerspectiveCameras`` on ``device``."""
    return PerspectiveCameras(
        focal_length=np.asarray(focal, np.float32),
        principal_point=np.asarray(principal, np.float32),
        R=np.asarray(R, np.float32), T=np.asarray(T, np.float32),
        image_size=image_size, device=device,
    )
