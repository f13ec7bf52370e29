"""A fixed-radius point cloud: ``n_points`` uniform in [-1, 1]^3 from the
seed, each a Gaussian of radius ``radius`` (VoGE's
``fixed_pointcloud_converter``: inverse sigma 1 / (r^2 / (2 ln(1 / p)))).
Made on the device in one call."""
from __future__ import annotations

import math

import torch

from portbench.scenes import generator


def make(cfg: dict, seed: int, device):
    n = cfg["n_points"]
    verts = torch.rand((n, 3), generator=generator(seed, device), device=device) * 2 - 1
    isig = 1 / (cfg["radius"] ** 2 / (2 * math.log(1 / cfg["percentage"])) + 1e-10)
    return verts, torch.full((n,), isig, dtype=torch.float32, device=device)
