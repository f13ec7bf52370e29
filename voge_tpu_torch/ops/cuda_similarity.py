"""The mean cosine similarity over pixels of a feature stack against a target
map (``csrc/similarity.cu``), beside its plain PyTorch version.

- :func:`feature_similarity_plain`: ``models.pose.feature_similarity``'s
  expression, differentiable, with an optional mask; CPU tensors and every
  call that needs a gradient run it.
- :func:`feature_similarity`: the same value without the mask, in one pass
  over the stack on CUDA tensors (``cos_partial_kernel``, then
  ``cos_finish_kernel``'s fixed-order float64 sum over pixels).  It replaces
  no TPU kernel (``voge_tpu/models/pose.py`` leaves the similarity to XLA);
  it is bound by DRAM bytes, and reads the stack once and a target shared by
  the batch once (the source's note says how).
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


def feature_similarity_plain(pred, target, mask=None):
    """Mean cosine similarity over pixels, (B,); pred / target (B, H, W, C)
    (target broadcast against pred), mask (B, H, W) or None."""
    pn = pred / (torch.linalg.norm(pred, dim=-1, keepdim=True) + 1e-8)
    tn = target / (torch.linalg.norm(target, dim=-1, keepdim=True) + 1e-8)
    sim = (pn * tn).sum(-1)
    if mask is not None:
        return (sim * mask).sum((1, 2)) / (mask.sum((1, 2)) + 1e-8)
    return sim.mean((1, 2))


def _rows(t: torch.Tensor):
    """``t`` (B, H, W, C) as a tensor whose (H, W, C) rows are dense, and its
    batch stride in elements (0 where one map serves the whole batch)."""
    if t.shape[0] == 1 or t.stride(0) == 0:
        row = t[0]
        return (row if row.is_contiguous() else row.contiguous()), 0
    if not t[0].is_contiguous():
        t = t.contiguous()
    return t, t.stride(0)


def feature_similarity(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean cosine similarity over pixels, (B,), of ``pred`` (B, H, W, C)
    against ``target`` (broadcast to pred's shape), both float32; no
    gradient.

    Neither tensor is copied where its (H, W, C) rows are dense: pred may have
    any batch stride (a slice ``pred[:, :h]``), target a batch stride of 0
    (``target.expand(pred.shape)``) or its own maps.  Other layouts are made
    dense first (a copy; one map, not B, for a target shared by the batch).
    """
    if not on_cuda(pred, target):
        return feature_similarity_plain(pred, target)
    for t, name in ((pred, "pred"), (target, "target")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if pred.ndim != 4 or pred.numel() == 0:
        raise ValueError(f"pred: expected a non-empty (B, H, W, C), got {tuple(pred.shape)}")
    B, H, W, C = pred.shape
    pred, pred_bs = _rows(pred)
    target, target_bs = _rows(target.expand(B, H, W, C))
    n_pix = H * W
    scratch = torch.empty(bind(*_SIM_SCRATCH)(B, n_pix), dtype=torch.float64,
                          device=pred.device)
    out = torch.empty(B, dtype=torch.float32, device=pred.device)
    err = bind(*_SIM)(pred.data_ptr(), target.data_ptr(), pred_bs, target_bs,
                      scratch.data_ptr(), out.data_ptr(), B, n_pix, C, stream(pred.device))
    raise_on_error(err, "feature_similarity")
    trace.count("launch.feature_similarity")
    return out
