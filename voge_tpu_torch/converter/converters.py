"""Mesh -> Gaussian converters (counterpart of the first part of
``voge_tpu/converter/converters.py``, itself a numpy re-implementation of
the reference ``VoGE/Converter/Converters.py``): the per-vertex mean edge
length and ``naive_vertices_converter``.  numpy in, numpy out, as in
``voge_tpu``; torch tensors are accepted as input."""
from __future__ import annotations

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def get_vert_edge_length(verts: np.ndarray, faces: np.ndarray,
                         default_l: float = 1e-3) -> np.ndarray:
    """Mean distance from each vertex to its unique adjacent vertices
    (itself included in the set but not in the denominator; reference
    ``Converters.py:10-32``), float64.  Each face links each of its vertices
    with the face's first three vertices."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    n = verts.shape[0]
    if faces.size == 0:
        return np.ones(n) * default_l
    k = faces.shape[1]
    src = np.repeat(faces.reshape(-1), 3)
    dst = np.tile(faces[:, :3], (1, k)).reshape(-1)
    pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
    src_u, dst_u = pairs[:, 0], pairs[:, 1]
    dist = np.linalg.norm(verts[src_u] - verts[dst_u], axis=1)
    len_sum = np.zeros(n)
    np.add.at(len_sum, src_u, dist)
    cnt = np.zeros(n, dtype=np.int64)
    np.add.at(cnt, src_u, 1)
    out = np.ones(n) * default_l
    has = cnt > 0
    out[has] = len_sum[has] / np.maximum(cnt[has] - 1, 1)
    return out


def _default_l(vertices: np.ndarray) -> float:
    return (10.0 * np.sum((vertices.max(axis=0) - vertices.min(axis=0)) ** 2) ** 0.5
            / vertices.shape[0])


def naive_vertices_converter(vertices, faces, percentage: float = 0.5,
                             max_sig_rate: float = -1):
    """Mesh -> isotropic Gaussians, sigma = len^2 / (2 ln(1/p)) (reference
    ``Converters.py:74-95``).

    :return: (verts (N, 3) float32, inverse sigma (N,) float32, None)
    """
    vertices, faces = _to_numpy(vertices), _to_numpy(faces)
    average_len = get_vert_edge_length(vertices, faces, _default_l(vertices))
    sigma = (average_len ** 2) / (2 * np.log(1 / percentage)) + 1e-10
    isigma = 1 / sigma
    if max_sig_rate > 0:
        thr = np.mean(isigma) * max_sig_rate
        isigma[isigma > thr] = thr
    return vertices.astype(np.float32), isigma.astype(np.float32), None
