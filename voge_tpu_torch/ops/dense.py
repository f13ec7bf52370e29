"""Dense (all rays x all Gaussians) ray tracing, counterpart of
``voge_tpu/ops/dense.py`` (reference ``RayTracing.py:97-123``, backed there by
``voge_ray_tracing_ray.cu``).

For a ray r (unit direction from the camera centre) and a Gaussian with
camera-centred mean mu and "inverse sigma" Lambda (the renderer passes
Lambda = 2 Sigma^-1):

    hit_length     t* = (mu^T Lambda r) / (r^T Lambda r)
    hit_activation a  = d^T Lambda d,  d = mu - t* r
    hit_dsd           = r^T Lambda r

(reference ``ray_trace_voge.cu:184-193``; the activation in the compensated
residual form, equal to ``mu^T Lambda mu - (mu^T Lambda r)^2 / (r^T Lambda
r)`` without its cancellation).  Plain differentiable PyTorch in the inputs'
dtype (float32 or float64), on their device, built on the dense select's
hit values and select (``ops/dense_select.py``: one implementation of both).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.ops.dense_select import (
    _gauss_feature_cols, _ray_features, hit_tensors, nearest_k,
)

_INF = 1e8  # reference RayTracing.py:9


def expand_isigmas(sigmas, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """float / (P,) / (P, 3, 3) -> (P, 3, 3) (reference ``RayTracing.py:98-101``),
    on ``device`` (None: the tensor's own, else the card,
    ``_device.resolve_device``)."""
    device = resolve_device(device, sigmas)
    if isinstance(sigmas, (float, int)):
        return (torch.eye(3, dtype=dtype, device=device) * sigmas).expand(n, 3, 3)
    sigmas = torch.as_tensor(sigmas, device=device)
    if sigmas.ndim == 1:
        return sigmas[:, None, None] * torch.eye(3, dtype=sigmas.dtype,
                                                 device=sigmas.device)[None]
    return sigmas


def hit_values(mus: torch.Tensor, isigmas: torch.Tensor,
               rays: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hit_length, hit_activation, hit_dsd) for every (ray, Gaussian) pair.

    :param mus: (..., P, 3) camera-centred means
    :param isigmas: (..., P, 3, 3)
    :param rays: (..., N, 3) unit directions
    :return: three tensors of shape (..., N, P)
    """
    return hit_tensors(_ray_features(rays), _gauss_feature_cols(mus, isigmas))


def ray_trace_voge_ray(mus: torch.Tensor, sigmas, rays: torch.Tensor):
    """Brute-force (N rays x P Gaussians) hit tensors (reference
    ``RayTracing.py:97-108``, whose ``sigmas`` are inverse sigmas).

    :param mus: (P, 3); :param sigmas: float | (P,) | (P, 3, 3); :param rays: (N, 3)
    :return: (hit_len, hit_act, hit_dsd), each (N, P)
    """
    if mus.ndim != 2 or mus.shape[1] != 3 or rays.ndim != 2 or rays.shape[1] != 3:
        raise ValueError(f"expected mus (P, 3) and rays (N, 3), got {tuple(mus.shape)} "
                         f"and {tuple(rays.shape)}")
    isigmas = expand_isigmas(sigmas, mus.shape[0], mus.dtype, mus.device)
    if isigmas.shape != (mus.shape[0], 3, 3):
        raise ValueError(f"isigmas: expected ({mus.shape[0]}, 3, 3), got {tuple(isigmas.shape)}")
    return hit_values(mus, isigmas, rays)


def find_nearest_k(hit_len_in, hit_act_in, hit_dsd_in, K: int, thr: float):
    """Per-ray threshold and top-K-nearest selection over dense hit tensors
    (reference ``RayTracing.py:111-115`` / ``voge_ray_tracing_ray.cu:191-239``):
    the K smallest ``hit_len`` among entries with ``hit_act < -log(thr +
    1e-8)``, ascending; empty slots hold (idx -1, len 1e10, act 1e10, dsd 0).

    Differentiable in the three hit tensors: each selected entry's gradient
    goes back to its own tensor (the reference's backward, ``RayTracing.py:
    239-240``, overwrote the act / dsd gradients with the len one; fixed in
    ``voge_tpu`` and here).
    """
    thr_act = -math.log(thr + 1.0 / _INF)
    return nearest_k(hit_len_in, hit_act_in, hit_dsd_in, thr_act, int(K))


def find_farest_k(hit_len_in, hit_act_in, hit_dsd_in, K: int, thr: float):
    """Farthest-K variant (reference ``RayTracing.py:118-123``)."""
    point_idx, hit_len, hit_act, hit_dsd = find_nearest_k(
        -hit_len_in, hit_act_in, hit_dsd_in, K, thr)
    return point_idx, -hit_len, hit_act, hit_dsd
