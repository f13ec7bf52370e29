"""VoGE's ``Converter/Cuboid.py`` surface sampling: both z faces carry full
grids, the four walls the interior z rows, each dropping one vertical edge
column so the seams are covered once; one isotropic inverse sigma from the
grid's edge length.  Deterministic: every seed renders the same scene, so
the seed does not move the work."""
from __future__ import annotations

import math

import numpy as np
import torch


def _face(fast, slow, fixed, order):
    F, S = np.meshgrid(fast, slow)
    cols = {order[0]: F.ravel(), order[1]: S.ravel(), order[2]: np.full(F.size, fixed)}
    return np.stack([cols["x"], cols["y"], cols["z"]], axis=1)


def cuboid(ranges, number_vertices: int, percentage: float):
    """(verts (N, 3), inverse sigmas (N,)) as float64 numpy arrays."""
    lo, hi = [r[0] for r in ranges], [r[1] for r in ranges]
    w, h, d = (b - a for a, b in zip(lo, hi))
    edge = ((w * h + h * d + w * d) * 2 / (number_vertices * 2) * 2) ** 0.5
    xs, ys, zs = (a + np.linspace(0, s, int(s / edge + 1)) for a, s in zip(lo, (w, h, d)))
    z_in = zs[1:-1]
    verts = np.concatenate([
        _face(xs, ys, zs[0], "xyz"), _face(xs, ys, zs[-1], "xyz"),
        _face(xs[:-1], z_in, ys[0], "xzy"), _face(xs[1:], z_in, ys[-1], "xzy"),
        _face(ys[1:], z_in, xs[0], "yzx"), _face(ys[:-1], z_in, xs[-1], "yzx"),
    ])
    sigma = edge ** 2 / (2 * math.log(1 / percentage)) + 1e-10
    return verts, np.full(verts.shape[0], 1 / sigma)


def make(cfg: dict, seed: int, device):
    v, s = cuboid(cfg["ranges"], cfg["number_vertices"], cfg["percentage"])
    return (torch.as_tensor(v, dtype=torch.float32, device=device),
            torch.as_tensor(s, dtype=torch.float32, device=device))
