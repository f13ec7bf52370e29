"""Inverse rendering: pull image attributes back onto Gaussian kernels
(counterpart of ``voge_tpu/sampler.py`` and the reference ``VoGE/Sampler.py``
+ ``sample_voge.cu``, whose scatter uses float atomics).

``sample_features`` is the adjoint of the linear map ``attr ->
interpolate_attr(frag, attr)`` with the image as the cotangent; a ones
channel appended to the image gives the per-kernel weight sums in the same
pass.  So the forward is the attribute half of the attribute merge's VJP on
its own (``ops.cuda_attr.attr_scatter``), and the backward is the merge
forward (K3f, for ``d_image``) plus the weight half on its own
(``ops.cuda_attr.attr_dw``, for ``d_weight``) with the roles of attribute
and cotangent swapped.  None of them uses float atomics, so values and
gradients repeat to the bit.  ``voge_tpu``'s fused sampler carries a
candidate-space context for its id-matching kernels; the port's fragments
hold ids and weights in image layout, which is all these kernels read, so
one sampler serves every render path.
"""
from __future__ import annotations

from typing import Optional

import torch

from voge_tpu_torch.ops.cuda_attr import attr_dw, attr_merge, attr_scatter


def _num_vertices(frag, n_vert: Optional[int]) -> int:
    if n_vert is not None:
        return int(n_vert)
    if hasattr(frag, "num_vertices"):
        return int(frag.num_vertices)
    return int(frag.vert_index.max()) + 1       # a device-to-host read


class SampleFeatures(torch.autograd.Function):
    """``(weights (B, H, W, K), image (B, H, W, C)) -> (n_vert, C + 1)``:
    per-kernel sums of ``w * (image ++ 1)`` over the slots holding each
    kernel.  ``idx`` (B, H, W, K) int32 holds flattened kernel ids, -1 for
    empty slots (they add nothing)."""

    @staticmethod
    def forward(ctx, weights, image, idx, n_vert):
        aug = torch.cat([image, torch.ones_like(image[..., :1])], dim=-1).contiguous()
        ctx.save_for_backward(weights, aug, idx)
        return attr_scatter(idx, weights, aug, n_vert)

    @staticmethod
    def backward(ctx, g_aug):
        weights, aug, idx = ctx.saved_tensors
        g_aug = g_aug.contiguous()
        d_w = d_image = None
        if ctx.needs_input_grad[0]:
            # d_w[r, k] = <g_feat[sel], image[r]> + g_wsum[sel]
            d_w = attr_dw(idx, g_aug, aug)
        if ctx.needs_input_grad[1]:
            # d_image[r] = sum_k w[r, k] g_feat[sel[r, k]]
            d_image = attr_merge(idx, weights, g_aug)[..., :-1]
        return d_w, d_image, None, None


def sample_features(frag, image: torch.Tensor, n_vert: Optional[int] = None):
    """Scatter pixel features onto kernels (reference ``Sampler.py:5-29``).

    Equivalent to (reference docstring):
        weight = zeros(image.shape[:3] + (n_vert,)).at[..., idx].set(w)
        vert_sum_weight = weight.sum((0, 1, 2))
        vert_feature = weight.reshape(-1, n_vert).T @ image.reshape(-1, C)

    Differentiable in ``frag.vert_weight`` and ``image``.  The kernels
    compute in float32; the results take the promoted dtype of (image,
    weights).

    :param frag: :class:`voge_tpu_torch.renderer.Fragments`
    :param image: (B, H, W, C), on the fragments' device
    :param n_vert: number of kernels.  Default: ``frag.num_vertices`` where
        the fragments have it, else ``max(vert_index) + 1``, which waits for
        the device (pass it explicitly in hot loops).  Ids are the flattened
        ``b * N + n``; rows beyond the largest id stay zero
    :return: (vert_feature (n_vert, C), vert_sum_weight (n_vert,))
    """
    w, idx = frag.vert_weight, frag.vert_index
    assert w.shape[:3] == image.shape[:3]
    n_vert = _num_vertices(frag, n_vert)
    dt = torch.promote_types(image.dtype, w.dtype)
    f32 = torch.float32
    idx = idx.to(torch.int32)
    idx = torch.where(idx < n_vert, idx, -1).contiguous()   # beyond n_vert: dropped
    out = SampleFeatures.apply(w.to(f32).contiguous(), image.to(f32), idx, n_vert)
    return out[:, :-1].to(dt), out[:, -1].to(dt)


@torch.no_grad()
def scatter_max_weight(frag, n_vert: Optional[int] = None) -> torch.Tensor:
    """Per-kernel maximum weight (reference ``Sampler.py:32-42``), 0 for
    kernels no pixel holds; not differentiable.  PyTorch ops, as it is XLA's
    ``segment_max`` in ``voge_tpu``; a maximum does not depend on the order
    of its terms, so it repeats to the bit."""
    w, idx = frag.vert_weight, frag.vert_index
    n_vert = _num_vertices(frag, n_vert)
    flat = idx.reshape(-1).long()
    valid = (flat >= 0) & (flat < n_vert)
    out = torch.full((n_vert + 1,), -torch.inf, dtype=w.dtype, device=w.device)
    out.scatter_reduce_(0, torch.where(valid, flat, n_vert), w.reshape(-1),
                        "amax", include_self=True)
    out = out[:n_vert]
    return torch.where(torch.isneginf(out), torch.zeros_like(out), out)
