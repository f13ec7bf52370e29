"""Procedural cuboid scene (counterpart of ``voge_tpu/converter/cuboid.py``
and the reference ``VoGE/Converter/Cuboid.py``): the same numpy point set in
the same order, with one isotropic inverse sigma from the grid edge length."""
from __future__ import annotations

import numpy as np

from voge_tpu_torch.meshes import GaussianMeshes


def _grid_samples(x_range, y_range, z_range, number_vertices):
    w = x_range[1] - x_range[0]
    h = y_range[1] - y_range[0]
    d = z_range[1] - z_range[0]
    total_area = (w * h + h * d + w * d) * 2
    # two triangles' worth of surface area per sampled vertex
    mesh_size = total_area / (number_vertices * 2)
    edge_length = (mesh_size * 2) ** 0.5
    x_samples = x_range[0] + np.linspace(0, w, int(w / edge_length + 1))
    y_samples = y_range[0] + np.linspace(0, h, int(h / edge_length + 1))
    z_samples = z_range[0] + np.linspace(0, d, int(d / edge_length + 1))
    return x_samples, y_samples, z_samples, edge_length


def _face_points(fast, slow, fixed, axes):
    """All (fast x slow) grid points of one face, ``fast`` varying within a
    row; ``axes`` maps (fast, slow, fixed) onto the x, y, z columns."""
    F, S = np.meshgrid(fast, slow)
    cols = {axes[0]: F.ravel(), axes[1]: S.ravel(),
            axes[2]: np.full(F.size, fixed)}
    return np.stack([cols["x"], cols["y"], cols["z"]], axis=1)


def cuboid_gauss(x_range, y_range, z_range, number_vertices,
                 percentage: float = 0.5, colors=None, as_obj: bool = False,
                 device=None):
    """Sample a cuboid surface as isotropic Gaussians: both z faces carry
    full grids, the four side walls interior-z rows, each dropping one
    vertical edge column so the seams are covered once.

    :return: (verts (N, 3), isigma (N,) [, colors (N, 3)]) as numpy arrays,
        or a :class:`GaussianMeshes` (float32, on ``device``; None: the
        card, ``_device.resolve_device``) in place of the first two when
        ``as_obj=True``.
    """
    xs, ys, zs, edge_length = _grid_samples(x_range, y_range, z_range,
                                            number_vertices)
    z_in = zs[1:-1]
    faces = [
        _face_points(xs, ys, zs[0], "xyz"),
        _face_points(xs, ys, zs[-1], "xyz"),
        _face_points(xs[:-1], z_in, ys[0], "xzy"),
        _face_points(xs[1:], z_in, ys[-1], "xzy"),
        _face_points(ys[1:], z_in, xs[0], "yzx"),
        _face_points(ys[:-1], z_in, xs[-1], "yzx"),
    ]
    verts = np.concatenate(faces, axis=0)
    sigma = (edge_length ** 2) / (2 * np.log(1 / percentage)) + 1e-10
    isigmas = np.ones(verts.shape[0]) * (1 / sigma)

    out = (verts, isigmas)
    if as_obj:
        out = (GaussianMeshes(verts.astype(np.float32),
                              isigmas.astype(np.float32), device=device),)
    if colors is not None:
        out_colors = np.concatenate(
            [np.repeat(c[None, :], f.shape[0], axis=0)
             for f, c in zip(faces, colors)], axis=0,
        )
        out = out + (out_colors,)
    return out[0] if len(out) == 1 else out
