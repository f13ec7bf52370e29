"""The float64 oracle: a render in float64 through the dense route
(``ops/dense_select.py``: the dense select, its closed-form backward and the
erf weights), the reference the port holds its float32 kernels to where
there is no JAX.  It matches ``voge_tpu``'s chain in float64 (under
``jax.enable_x64``, below its render's float32 cast) to ~1e-9, and runs in
PyTorch ops on any device.

    frag = oracle.render(verts, sigmas, R, T, focal, principal,
                         image_size=(128, 128), max_assign=20, attrs=colors)

It takes :func:`voge_tpu_torch.renderer.render_pipeline`'s arguments (no
camera context and no ``camera_grad``: the oracle differentiates
everything) and returns float64 ``Fragments``; ``attr_img`` is composited
in float64 by :func:`interpolate_attr`.  The kernels' route never calls it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from voge_tpu_torch.ops.dense_select import ray_tracing_dense
from voge_tpu_torch.renderer import Fragments, _render_inputs


def interpolate_attr(fragments: Fragments, vert_attr: torch.Tensor) -> torch.Tensor:
    """``renderer.interpolate_attr`` in float64: img = sum_k w[..., k]
    attrs[idx[..., k]], differentiable in the weights and the attributes."""
    idx, w = fragments.vert_index, fragments.vert_weight
    attrs = torch.as_tensor(vert_attr, device=idx.device).to(torch.float64)
    if fragments.valid_num.ndim == 3 and idx.shape[0] > 1 and attrs.ndim == 2:
        attrs = attrs.repeat(idx.shape[0], 1)
    attrs = attrs.reshape(-1, attrs.shape[-1])
    valid = idx >= 0
    rows = attrs[torch.where(valid, idx, 0).long()]
    return (rows * torch.where(valid, w.to(torch.float64), 0.0)[..., None]).sum(-2)


def render(verts: torch.Tensor, sigmas: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
           focal: torch.Tensor, principal: torch.Tensor, *, image_size: Tuple[int, int],
           max_assign: int = 20, thr_activation: float = 0.01, absorptivity: float = 1.0,
           inverse_sigma: bool = False, bin_size: Optional[int] = None,
           max_point_per_bin: Optional[int] = None,
           attrs: Optional[torch.Tensor] = None) -> Fragments:
    """``render_pipeline`` in float64 through the dense route, at any K."""
    cams, verts, isigma, rays, origins, attrs_b = _render_inputs(
        verts, sigmas, R, T, focal, principal, image_size, inverse_sigma, None, attrs,
        torch.float64)
    (idx, length, _act, _dsd, weight, _), overflow = ray_tracing_dense(
        cams, verts, isigma, rays, image_size, thr_activation, max_assign, bin_size,
        max_point_per_bin, float(absorptivity), origins=origins)
    frag = Fragments(weight, idx, (idx >= 0).sum(-1), length, overflow_points=overflow)
    if attrs_b is not None:
        frag.attr_img = interpolate_attr(frag, attrs_b)
    return frag
