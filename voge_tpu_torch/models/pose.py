"""Render-and-compare pose estimation, NeMo-style (counterpart of
``voge_tpu/models/pose.py``).

The reference exposes its ray tracer so that NeMo can score many pose
hypotheses by rendering per-kernel feature maps and comparing them with CNN
feature maps, then refine the best hypothesis by gradient descent on the
camera pose.  Here:

- hypotheses are a batch of cameras: scoring is one batched render per
  chunk of hypotheses;
- refinement treats the pose as differentiable spherical coordinates
  (distance, elevation, azimuth, in-plane theta) feeding
  ``look_at_view_transform`` + ``rotation_theta``.  The render is given no
  camera context, so the pose gradient flows through the rays and through
  the camera-centred means (``renderer.render_pipeline``), into the fine
  backward's ray gradient.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from voge_tpu_torch import trace
from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import look_at_view_transform
from voge_tpu_torch.ops import cuda_similarity
from voge_tpu_torch.renderer import get_silhouette, interpolate_attr, render_pipeline
from voge_tpu_torch.utils import rotation_theta


def pose_matrices(dist, elev, azim, theta=None, degrees: bool = False, device=None):
    """(R, T) from batched spherical poses (+ optional in-plane theta), the
    reference demos' ``look_at_view_transform`` + ``rotation_theta``
    composition (``demo/ExtractTexture.py:43``).  ``device=None``: a tensor
    argument's device, else the card (``_device.resolve_device``)."""
    device = resolve_device(device, dist, elev, azim, theta)
    R, T = look_at_view_transform(dist, elev, azim, degrees=degrees, device=device)
    if theta is not None:
        R = torch.matmul(R, rotation_theta(theta, device=device))
    return R, T


def feature_similarity(pred: torch.Tensor, target: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean cosine similarity over pixels, (B,); pred / target (B, H, W, C).

    Float32 inputs with no mask and no gradient wanted (``score``, under
    ``no_grad``) take ``ops.cuda_similarity.feature_similarity``: one pass
    over the stack on the card.  Everything else (``refine_pose``'s pose
    gradient, a mask, other dtypes) takes the differentiable expression."""
    with trace.span("voge.similarity"):
        needs_grad = torch.is_grad_enabled() and (pred.requires_grad or target.requires_grad)
        if mask is None and not needs_grad and pred.dtype == target.dtype == torch.float32:
            return cuda_similarity.feature_similarity(pred, target)
        return cuda_similarity.feature_similarity_plain(pred, target, mask)


class PoseHypothesisScorer(nn.Module):
    """Score pose hypotheses by rendering kernel features and comparing them
    with a target feature map.

    :param verts: (N, 3) Gaussian centres (world)
    :param sigmas: (N,) / (N, 3) / (N, 3, 3)
    :param features: (N, C) per-kernel features (e.g. a CNN-trained bank)
    :param focal, principal: pixel intrinsics (scalars or pairs)
    :param chunk: hypotheses rendered at once by :meth:`score`
    :param device: None is the device of a tensor among the scene's arrays,
        else the card (``_device.resolve_device``)
    """

    def __init__(self, verts, sigmas, features, focal, principal,
                 image_size: Tuple[int, int], max_assign: int = 20,
                 thr_activation: float = 0.01, max_point_per_bin: Optional[int] = None,
                 chunk: int = 32, device=None):
        super().__init__()
        device = resolve_device(device, verts, sigmas, features)
        as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        for name, val in (("verts", verts), ("sigmas", sigmas), ("features", features)):
            self.register_buffer(name, as_f32(val).detach())
        self.register_buffer("focal", as_f32(focal).reshape(-1)[:2].expand(2).clone())
        self.register_buffer("principal", as_f32(principal).reshape(-1)[:2].expand(2).clone())
        self.image_size = tuple(int(v) for v in image_size)
        self.max_assign = max_assign
        self.thr_activation = thr_activation
        self.max_point_per_bin = max_point_per_bin
        self.chunk = chunk

    def render_features(self, R, T):
        """(feature map (B, H, W, C), silhouette (B, H, W)) seen from (R, T)."""
        B = R.shape[0]
        frag = render_pipeline(
            self.verts, self.sigmas, R, T, self.focal.expand(B, 2),
            self.principal.expand(B, 2), image_size=self.image_size,
            max_assign=self.max_assign, thr_activation=self.thr_activation,
            max_point_per_bin=self.max_point_per_bin)
        return interpolate_attr(frag, self.features), get_silhouette(frag)

    @torch.no_grad()
    def score(self, R: torch.Tensor, T: torch.Tensor,
              target_feature_map: torch.Tensor) -> torch.Tensor:
        """Scores (B,) of B pose hypotheses, rendered ``chunk`` at a time (the
        last chunk padded with its last hypothesis, as ``voge_tpu`` pads)."""
        B, c = R.shape[0], self.chunk
        target = target_feature_map
        if target.ndim == 3:
            target = target[None]
        n_pad = (B + c - 1) // c * c
        Rp = torch.cat([R, R[-1:].expand(n_pad - B, 3, 3)])
        Tp = torch.cat([T, T[-1:].expand(n_pad - B, 3)])
        outs = []
        for s in range(0, n_pad, c):
            pred, _ = self.render_features(Rp[s:s + c], Tp[s:s + c])
            outs.append(feature_similarity(pred, target.expand(pred.shape)))
        return torch.cat(outs)[:B]

    forward = score


def refine_pose(scorer: PoseHypothesisScorer, target_feature_map: torch.Tensor,
                init_pose: Tuple[float, float, float, float], steps: int = 100,
                lr: float = 0.02) -> Tuple[Dict[str, torch.Tensor], float]:
    """Refine a pose (dist, elev, azim, theta; radians) by gradient ascent on
    the feature similarity with ``torch.optim.Adam(lr)`` (``voge_tpu``:
    ``optax.adam(lr)``; both divide by ``sqrt(v_hat) + 1e-8``): the NeMo
    render-and-compare inner loop.

    :return: (refined pose as a dict of scalar tensors, the similarity at the
        last step's start)
    """
    device = scorer.verts.device
    params = {k: torch.tensor(float(v), dtype=torch.float32, device=device,
                              requires_grad=True)
              for k, v in zip(("dist", "elev", "azim", "theta"), init_pose)}
    target = target_feature_map
    if target.ndim == 3:
        target = target[None]
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        R, T = pose_matrices(*(params[k][None] for k in ("dist", "elev", "azim", "theta")))
        pred, _ = scorer.render_features(R, T)
        loss = -feature_similarity(pred, target)[0]
        loss.backward()
        opt.step()
    return {k: v.detach() for k, v in params.items()}, -loss.item()
