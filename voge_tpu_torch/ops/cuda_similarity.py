"""The mean cosine similarity over pixels of a feature stack against a target
map, and its gradient in the stack (``csrc/similarity.cu``), beside their
plain PyTorch versions.

- :func:`feature_similarity_plain`: ``models.pose.feature_similarity``'s
  expression, differentiable, with an optional mask; CPU tensors, a mask and
  a target that needs a gradient run it.
- :func:`feature_similarity`: the same value without the mask, in one pass
  over the stack on CUDA tensors (``cos_partial_kernel``, then
  ``cos_finish_kernel``'s fixed-order float64 sum over pixels), through
  :class:`FeatureSimilarity`, whose backward, where pred needs a gradient, is
  :func:`feature_similarity_grad`: one more pass (``cos_grad_kernel``) that
  reads the stack and the target once and writes the cotangent once.  They
  replace no TPU kernel (``voge_tpu/models/pose.py`` leaves the similarity
  and its VJP to XLA); both are bound by DRAM bytes (the source's note says
  how they read each byte once).
"""
from __future__ import annotations

import torch

from voge_tpu_torch import trace
from voge_tpu_torch.ops._dispatch import (
    INT, LONG, VOIDP, bind, on_cuda, raise_on_error, stream,
)

# (library, symbol, argtypes[, restype]) of each C entry this module launches
_SIM = ("similarity", "voge_feature_similarity",
        (VOIDP, VOIDP, LONG, LONG, VOIDP, VOIDP, INT, LONG, INT, VOIDP))
_SIM_SCRATCH = ("similarity", "voge_feature_similarity_scratch", (INT, LONG), LONG)
_SIM_GRAD = ("similarity", "voge_feature_similarity_grad",
             (VOIDP, VOIDP, VOIDP, LONG, LONG, LONG, VOIDP, INT, LONG, INT, VOIDP))


def feature_similarity_plain(pred, target, mask=None):
    """Mean cosine similarity over pixels, (B,); pred / target (B, H, W, C)
    (target broadcast against pred), mask (B, H, W) or None."""
    pn = pred / (torch.linalg.norm(pred, dim=-1, keepdim=True) + 1e-8)
    tn = target / (torch.linalg.norm(target, dim=-1, keepdim=True) + 1e-8)
    sim = (pn * tn).sum(-1)
    if mask is not None:
        return (sim * mask).sum((1, 2)) / (mask.sum((1, 2)) + 1e-8)
    return sim.mean((1, 2))


def feature_similarity_grad_plain(pred, target, grad):
    """The gradient in pred of ``feature_similarity_plain(pred, target)``
    against ``grad`` (B,) of its output: autograd of the expression."""
    with torch.enable_grad():
        p = pred.detach().requires_grad_(True)
        return torch.autograd.grad(feature_similarity_plain(p, target.detach()), p, grad)[0]


def _rows(t: torch.Tensor):
    """``t`` (B, H, W, C) as a tensor whose (H, W, C) rows are dense, and its
    batch stride in elements (0 where one map serves the whole batch)."""
    if t.shape[0] == 1 or t.stride(0) == 0:
        row = t[0]
        return (row if row.is_contiguous() else row.contiguous()), 0
    if not t[0].is_contiguous():
        t = t.contiguous()
    return t, t.stride(0)


def _operands(pred: torch.Tensor, target: torch.Tensor):
    """(pred's shape, (pred, its batch stride, target, its batch stride)),
    each tensor with dense (H, W, C) rows, for the kernels; raises on other
    dtypes or an empty pred."""
    for t, name in ((pred, "pred"), (target, "target")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if pred.ndim != 4 or pred.numel() == 0:
        raise ValueError(f"pred: expected a non-empty (B, H, W, C), got {tuple(pred.shape)}")
    return pred.shape, (*_rows(pred), *_rows(target.expand(pred.shape)))


class FeatureSimilarity(torch.autograd.Function):
    """The similarity's kernels on CUDA tensors, differentiable in pred: the
    forward saves pred and target alone (no normalised stacks, no norms);
    the backward is :func:`feature_similarity_grad`.  Under ``no_grad``, or
    where pred needs no gradient, it records no graph."""

    @staticmethod
    def forward(ctx, pred, target):
        ctx.save_for_backward(pred, target)
        (B, H, W, C), (pred, pred_bs, target, target_bs) = _operands(pred, target)
        n_pix = H * W
        scratch = torch.empty(bind(*_SIM_SCRATCH)(B, n_pix), dtype=torch.float64,
                              device=pred.device)
        out = torch.empty(B, dtype=torch.float32, device=pred.device)
        err = bind(*_SIM)(pred.data_ptr(), target.data_ptr(), pred_bs, target_bs,
                          scratch.data_ptr(), out.data_ptr(), B, n_pix, C, stream(pred.device))
        raise_on_error(err, "feature_similarity")
        trace.count("launch.feature_similarity")
        return out

    @staticmethod
    def backward(ctx, grad):
        pred, target = ctx.saved_tensors
        return feature_similarity_grad(pred, target, grad), None


def feature_similarity(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean cosine similarity over pixels, (B,), of ``pred`` (B, H, W, C)
    against ``target`` (broadcast to pred's shape), both float32.

    Differentiable in pred (:class:`FeatureSimilarity`); a target that
    needs a gradient raises on CUDA tensors (the kernels give none: use
    :func:`feature_similarity_plain`).  Neither
    tensor is copied where its (H, W, C) rows are dense: pred may have any
    batch stride (a slice ``pred[:, :h]``), target a batch stride of 0
    (``target.expand(pred.shape)``) or its own maps.  Other layouts are made
    dense first (a copy; one map, not B, for a target shared by the batch).
    """
    if not on_cuda(pred, target):
        return feature_similarity_plain(pred, target)
    if torch.is_grad_enabled() and target.requires_grad:
        raise ValueError("target: the similarity kernels give no gradient in the target")
    return FeatureSimilarity.apply(pred, target)


def feature_similarity_grad(pred: torch.Tensor, target: torch.Tensor,
                            grad: torch.Tensor) -> torch.Tensor:
    """The gradient in pred, (B, H, W, C) dense, of
    ``feature_similarity(pred, target)`` against ``grad`` (B,) float32 of
    its output (any stride: autograd's gradient of a sum is one value
    expanded); pred and target as there."""
    if not on_cuda(pred, target, grad):
        return feature_similarity_grad_plain(pred, target, grad)
    (B, H, W, C), (pred, pred_bs, target, target_bs) = _operands(pred, target)
    if grad.dtype != torch.float32 or grad.shape != (B,):
        raise ValueError(f"grad: expected float32 ({B},), got {grad.dtype} {tuple(grad.shape)}")
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=pred.device)
    err = bind(*_SIM_GRAD)(pred.data_ptr(), target.data_ptr(), grad.data_ptr(), pred_bs,
                           target_bs, grad.stride(0), out.data_ptr(), B, H * W, C,
                           stream(pred.device))
    raise_on_error(err, "feature_similarity_grad")
    trace.count("launch.feature_similarity_grad")
    return out
