"""Mesh / pointcloud -> Gaussian converters (counterpart of
``voge_tpu/converter/converters.py``, itself a numpy re-implementation of
the reference ``VoGE/Converter/Converters.py``).  numpy in, numpy out, as in
``voge_tpu``; torch tensors are accepted as input, and
:func:`to_gaussian_mesh` puts the result on a device as a scene.

``voge_tpu`` speeds two of these up with a C++ helper (``voge_tpu/native``).
The port has no such helper: the per-vertex edge length is the vectorised
numpy of :func:`get_vert_edge_length`, and the k-nearest-neighbour distance
of ``naive_point_cloud_converter`` is :func:`knn_mean_dist`, a chunked
``torch.cdist`` + ``topk`` on the card (a k-NN over points is PyTorch's own
idiom and no TPU kernel)."""
from __future__ import annotations

import os

import numpy as np
import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.meshes import GaussianMeshes


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


def _look_at_rotation_np(camera_position: np.ndarray, at=(0.0, 0.0, 0.0),
                         up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """numpy ``look_at_rotation`` in float64 (see
    :func:`voge_tpu_torch.cameras.look_at_rotation`)."""
    cp = np.atleast_2d(np.asarray(camera_position, dtype=np.float64))
    at = np.broadcast_to(np.asarray(at, dtype=np.float64), cp.shape)
    up = np.broadcast_to(np.asarray(up, dtype=np.float64), cp.shape)

    def normalize(v, eps=1e-5):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), eps)

    z_axis = normalize(at - cp)
    x_axis = normalize(np.cross(up, z_axis))
    y_axis = normalize(np.cross(z_axis, x_axis))
    is_close = np.all(np.isclose(x_axis, 0.0, atol=5e-3), axis=-1, keepdims=True)
    x_axis = np.where(is_close, normalize(np.cross(y_axis, z_axis)), x_axis)
    return np.swapaxes(np.stack((x_axis, y_axis, z_axis), axis=1), 1, 2)


def normal_mesh_converter(vertices, faces, normals, percentage: float = 0.5,
                          shape_ratio: float = 0.5, max_sig_rate: float = -1,
                          auto_fix: bool = True):
    """Mesh -> anisotropic Gaussians flattened along the vertex normal
    (reference ``Converters.py:35-71``).

    :return: (verts (N, 3) float32, inverse sigma (N, 3, 3) float32, None)
    """
    vertices, faces, normals = (_to_numpy(x) for x in (vertices, faces, normals))
    average_len = get_vert_edge_length(vertices, faces, _default_l(vertices))
    isigma_base = 1 / ((average_len ** 2) / (2 * np.log(1 / percentage)) + 1e-10)
    nrm2 = (normals ** 2).sum(-1)
    if not (nrm2.max() < 1.1 and nrm2.min() > 0.9):
        raise ValueError("normals must be unit length")
    base_ = (np.array([[1, 0, 0], [0, 1, 0], [0, 0, shape_ratio]])[None, ...]
             * isigma_base.reshape((-1, 1, 1)))
    rotations_matrix = _look_at_rotation_np(-normals)
    isigma = rotations_matrix @ base_ @ rotations_matrix.transpose(0, 2, 1)
    if auto_fix:
        dets = np.linalg.det(isigma)
        isigma[dets == 0] = np.eye(3)[None, ...] * isigma_base[dets == 0].reshape((-1, 1, 1))
    if max_sig_rate > 0:
        thr = np.mean(isigma) * max_sig_rate
        isigma[isigma > thr] = thr
    return vertices.astype(np.float32), isigma.astype(np.float32), None


# entries of the (rows, N) distance block knn_mean_dist holds at once: 1 GiB of float32
_KNN_CHUNK_ELEMS = 1 << 28


@torch.no_grad()
def knn_mean_dist(points: torch.Tensor, k: int, thr_max: float) -> torch.Tensor:
    """Clipped mean distance of each point to its ``k`` nearest points, itself
    among them at distance 0 (``voge_tpu/converter/converters.py:176-182``,
    the reference's ``topk(largest=False)`` over the full row): each of the k
    distances is clipped at ``thr_max`` times their mean.

    Rows of the (N, N) distance matrix are taken ``_KNN_CHUNK_ELEMS / N`` at
    a time, on the device of ``points``.

    :param points: (N, 3) float32; :return: (N,) float32
    """
    n = points.shape[0]
    k = min(int(k), n)
    rows = max(1, _KNN_CHUNK_ELEMS // max(n, 1))
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    for s in range(0, n, rows):
        # exact differences: the matrix-product form loses the small distances
        d = torch.cdist(points[s:s + rows], points,
                        compute_mode="donot_use_mm_for_euclid_dist")
        part = d.topk(k, dim=1, largest=False).values
        cap = part.mean(dim=1, keepdim=True) * thr_max
        out[s:s + rows] = torch.minimum(part, cap).mean(dim=1)
    return out


def naive_point_cloud_converter(points, percentage: float = 0.5, n_nearest: int = 4,
                                thr_max: float = 2, device=None):
    """Pointcloud -> isotropic Gaussians from the clipped k-NN mean distance
    (reference ``Converters.py:98-122``; note ``4 ln(1/p)`` where the mesh
    converters use ``2 ln(1/p)``, as the reference has it).

    :param device: where the k-NN runs: None is the device of ``points``
        when it is a tensor, else the card (``_device.resolve_device``);
        pass ``device="cpu"`` for the CPU
    :return: (points (N, 3) float32, inverse sigma (N,) float32, None)
    """
    device = resolve_device(device, points)
    points = _to_numpy(points).astype(np.float32)
    average_len = knn_mean_dist(torch.as_tensor(points, device=device), n_nearest, thr_max)
    sigma = average_len.cpu().numpy().astype(np.float64) ** 2 / (4 * np.log(1 / percentage)) + 1e-8
    return points, (1 / sigma).astype(np.float32), None


def fixed_pointcloud_converter(points, radius, percentage: float = 0.5):
    """Fixed-radius pointcloud -> Gaussians (reference ``Converters.py:125-139``).

    :param radius: a float, or per-point radii (N,)
    :return: (points (N, 3) float32, inverse sigma (N,) float32, None)
    """
    points = _to_numpy(points)
    if not isinstance(radius, float):
        radius = _to_numpy(radius)
    isigma = np.ones(points.shape[0]) / (
        (np.asarray(radius) ** 2) / (2 * np.log(1 / percentage)) + 1e-10)
    return points.astype(np.float32), isigma.astype(np.float32), None


def convert_path(source_path, destiny_path, convert_function, filter_=None):
    """Convert every file under a directory tree (reference
    ``Converters.py:142-155``); ``filter_`` applies to the top level only,
    as in the reference."""
    os.makedirs(destiny_path, exist_ok=True)
    for this_name in os.listdir(source_path):
        this_source_path = os.path.join(source_path, this_name)
        this_destiny_path = os.path.join(destiny_path, this_name)
        if os.path.isfile(this_source_path):
            if filter_ is not None and not filter_(this_name):
                continue
            convert_function(this_source_path, this_destiny_path)
        else:
            convert_path(this_source_path, this_destiny_path, convert_function)


class ComposedConverter:
    """loader -> converter -> saver pipeline (reference ``Converters.py:158-173``)."""

    def __init__(self, loader, saver, converter, **kwargs):
        self.loader = loader
        self.saver = saver
        self.converter = converter
        self.kwargs = kwargs

    def __call__(self, source_path, destiny_path):
        get = self.loader(source_path)
        if not isinstance(get, tuple):
            get = (get,)
        get = self.converter(*get, **self.kwargs)
        if not isinstance(get, tuple):
            get = (get,)
        self.saver(destiny_path, *get)


def to_gaussian_mesh(converter, **kwargs):
    """Wrap a converter to return a :class:`GaussianMeshes` (the analog of
    the reference's ``pytorch3d2gaussian``, ``Converters.py:176-194``).  The
    wrapped function takes (vertices, faces) for mesh converters or
    (points,) for pointcloud converters, plus ``GaussianMeshes``' keyword
    arguments (``gradianted_args``, ``device``: None is the card)."""

    def wrapper(*arrays, **mesh_kwargs):
        verts, sigmas, radians = converter(*arrays, **kwargs)
        return GaussianMeshes(
            np.asarray(verts, dtype=np.float32), np.asarray(sigmas, dtype=np.float32),
            None if radians is None else np.asarray(radians, dtype=np.float32),
            **mesh_kwargs)

    return wrapper


# the reference's name; works on raw arrays, not pytorch3d structures
pytorch3d2gaussian = to_gaussian_mesh
