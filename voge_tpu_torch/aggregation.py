"""Closed-form erf transmittance compositing (counterpart of
``voge_tpu/aggregation.py`` and the reference ``VoGE/Aggregation.py``),
including the reference's quirks: the self term in the occlusion sum, the
``exp(0.5)`` normalisation and the ``1e-10`` inside the square root.

Per pixel with K selected kernels (hit length l, activation a, dsd):

    ca[m, k] = (l_m - l_k) * sqrt(dsd_k + 1e-10)
    w_m      = exp(-ow * sum_k exp(-a_k) * (erf(ca[m, k]) + 1) / 2)
               * exp(-a_m) * exp(0.5)

Invalid slots carry a = 1e10, so their weight and occlusion vanish.  The
renderer's main path computes this inside the select kernel
(``ops/cuda_fine.py``); these functions are the plain tensor forms.
"""
from __future__ import annotations

import torch

# re-exported, as ``voge_tpu.aggregation`` does, for ``from VoGE.Aggregation import *`` users
from voge_tpu_torch.rays import get_ray_camera_space  # noqa: F401

_E_HALF = 1.6487212707001282  # exp(0.5)


def get_cross_activation(sel_length: torch.Tensor,
                         sel_dsd: torch.Tensor) -> torch.Tensor:
    """(l_m - l_k) * sqrt(dsd_k + 1e-10): [..., M] -> [..., M(m), M(k)]."""
    return (sel_length[..., :, None] - sel_length[..., None, :]) * torch.sqrt(
        sel_dsd[..., None, :] + 1e-10)


def assign2weight(sel_activation: torch.Tensor, cross_activation: torch.Tensor,
                  occupation_weight: float = 1.0) -> torch.Tensor:
    """Occlusion-aware per-kernel weights [..., M]."""
    density_dist = torch.exp(-sel_activation[..., None, :]) * (
        (torch.erf(cross_activation) + 1.0) / 2.0)
    density_weight = torch.exp(-density_dist.sum(-1) * occupation_weight)
    return density_weight * torch.exp(-sel_activation) * _E_HALF


def weights_from_sel(sel_len, sel_act, sel_dsd, occupation_weight: float = 1.0):
    """Per-slot compositing weights from (length, activation, dsd)."""
    return assign2weight(sel_act, get_cross_activation(sel_len, sel_dsd),
                         occupation_weight)


def aggregation(sel_idx, sel_act, sel_len, sel_dsd,
                occupation_weight: float = 1.0):
    """(vert_weight, vert_index, valid_num, vert_hit_length)."""
    weight = weights_from_sel(sel_len, sel_act, sel_dsd, occupation_weight)
    return weight, sel_idx, (sel_idx >= 0).sum(-1), sel_len


def merge_final(vert_attr: torch.Tensor, weight: torch.Tensor,
                vert_assign: torch.Tensor, valid_num: torch.Tensor):
    """Composite per-kernel attributes [n, d] into an attribute map [..., d]:
    slots at or beyond ``valid_num`` are masked and invalid indices read
    row 0 (reference ``Aggregation.py:111-141``)."""
    slots = torch.arange(weight.shape[-1], device=weight.device)
    mask = (slots < valid_num[..., None]).to(weight.dtype)
    idx = torch.where(vert_assign < 0, vert_assign + 1, vert_assign).long()
    return (vert_attr[idx] * (mask * weight)[..., None]).sum(-2)


def expend_sigma(sigma, rotation_matrix=None) -> torch.Tensor:
    """Promote (N,) / (N, 3) sigmas to (N, 3, 3)."""
    sigma = torch.as_tensor(sigma)
    if sigma.ndim == 3:
        if sigma.shape[1:] == (3, 3):
            return sigma
        raise ValueError(f"Got unexpected sigma, which has shape: {tuple(sigma.shape)}")
    if rotation_matrix is None:
        rotation_matrix = torch.eye(3, dtype=sigma.dtype, device=sigma.device)[None]
    rotation_matrix = torch.as_tensor(rotation_matrix, device=sigma.device)
    if rotation_matrix.ndim == 2:
        rotation_matrix = rotation_matrix[None]
    rotation_matrix = rotation_matrix[:, :3, :3]
    if sigma.ndim == 1:
        return sigma[:, None, None] * rotation_matrix
    if sigma.ndim == 2:
        return sigma[:, :, None] * rotation_matrix
    raise ValueError(f"Got unexpected sigma, which has shape: {tuple(sigma.shape)}")
