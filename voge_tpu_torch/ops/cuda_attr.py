"""K3f: attribute merge forward (``csrc/attr_merge.cu``) and its plain
PyTorch version: ``img[..., :] = sum_k w[..., k] * attrs[idx[..., k], :]``
over slots with ``idx >= 0``.

Replaces ``voge_tpu/ops/pallas_attr.py::_fwd_kernel`` (``attr_merge_compact``
/ ``attr_merge_fwd_pallas``), which id-matches candidate chunks and contracts
them on the MXU because gathers are slow on a TPU.  On Hopper it is a direct
gather-and-reduce, one thread per (pixel, channel), sharing its device
function with K2's fused attribute image.  Bound on the H100: memory (a few
MB at the headline), in practice launch latency.

:class:`AttrMerge` wraps it as an autograd node whose backward is K4b
(``csrc/attr_merge_bwd.cu``, replacing ``pallas_attr.py::_bwd_unified_kernel``):
``d_w[..., k] = attrs[idx[..., k]] . g`` and ``d_attr[j]`` = the sum of
``w * g`` over the slots holding ``j``, in ascending slot order, without
float atomics.
"""
from __future__ import annotations

import torch

from voge_tpu_torch._build import load
from voge_tpu_torch.ops._dispatch import (
    INT, LONG, VOIDP, check, on_cuda, ptr, raise_on_error, stream,
)


def attr_merge_plain(idx, w, attrs):
    """Plain version of K3f; same contract as :func:`attr_merge`."""
    valid = idx >= 0
    rows = attrs[torch.where(valid, idx, 0).long()]           # (..., K, d)
    return (rows * torch.where(valid, w, 0.0)[..., None]).sum(-2)


def _kernel():
    fn = load("attr_merge").voge_attr_merge
    fn.argtypes = [VOIDP] * 4 + [LONG, INT, INT, LONG, VOIDP]
    fn.restype = INT
    return fn


def attr_merge(idx: torch.Tensor, w: torch.Tensor, attrs: torch.Tensor):
    """Composite per-kernel attributes into an attribute map.

    :param idx: (..., K) int32 flattened kernel ids, -1 for empty slots
    :param w: (..., K) float32 weights
    :param attrs: (rows, d) float32, indexed by id
    :return: (..., d) float32
    """
    if not on_cuda(idx, w, attrs):
        return attr_merge_plain(idx, w, attrs)
    K = idx.shape[-1]
    check(idx, "idx", torch.int32)
    check(w, "w", torch.float32, idx.shape)
    check(attrs, "attrs", torch.float32)
    if attrs.ndim != 2:
        raise ValueError(f"attrs: expected (rows, d), got {tuple(attrs.shape)}")
    n_pix, d = idx.numel() // K, attrs.shape[1]
    out = torch.empty(idx.shape[:-1] + (d,), dtype=torch.float32, device=idx.device)
    err = _kernel()(ptr(idx), ptr(w), ptr(attrs), ptr(out), n_pix, K, d,
                    attrs.shape[0], stream(idx.device))
    raise_on_error(err, "attr_merge")
    attr_merge.launches += 1
    return out


attr_merge.launches = 0


def attr_merge_bwd_plain(idx, w, attrs, g, need_w: bool = True,
                        need_attr: bool = True):
    """Plain version of K4b; same contract as :func:`attr_merge_bwd`."""
    n_rows, d = attrs.shape
    valid = (idx >= 0) & (idx < n_rows)
    d_w = d_attr = None
    if need_w:
        rows = attrs[torch.where(valid, idx, 0).long()]         # (..., K, d)
        d_w = torch.where(valid, (rows * g[..., None, :]).sum(-1), 0.0)
    if need_attr:
        vals = (torch.where(valid, w, 0.0)[..., None] * g[..., None, :]).reshape(-1, d)
        seg = torch.where(valid, idx, n_rows).long().reshape(-1)
        d_attr = attrs.new_zeros((n_rows + 1, d)).index_add_(0, seg, vals)[:n_rows]
    return d_w, d_attr


def _bwd_kernel():
    fn = load("attr_merge_bwd").voge_attr_merge_bwd
    fn.argtypes = [VOIDP] * 8 + [LONG, INT, INT, LONG, VOIDP]
    fn.restype = INT
    return fn


def attr_merge_bwd(idx: torch.Tensor, w: torch.Tensor, attrs: torch.Tensor,
                   g: torch.Tensor, need_w: bool = True, need_attr: bool = True):
    """Backward of :func:`attr_merge`.

    :param idx, w, attrs: as for :func:`attr_merge`
    :param g: (..., d) float32 cotangent of the attribute map
    :return: (d_w (..., K) or None, d_attr (rows, d) or None)
    """
    if not on_cuda(idx, w, attrs, g):
        return attr_merge_bwd_plain(idx, w, attrs, g, need_w, need_attr)
    K = idx.shape[-1]
    check(idx, "idx", torch.int32)
    check(w, "w", torch.float32, idx.shape)
    check(attrs, "attrs", torch.float32)
    if attrs.ndim != 2:
        raise ValueError(f"attrs: expected (rows, d), got {tuple(attrs.shape)}")
    n_rows, d = attrs.shape
    check(g, "g", torch.float32, idx.shape[:-1] + (d,))
    dev = idx.device
    d_w = torch.empty_like(w) if need_w else None
    order = starts = d_attr = None
    if need_attr:
        # one stable sort groups each row's slots into a run in slot order
        flat = idx.reshape(-1)
        key = torch.where((flat >= 0) & (flat < n_rows), flat, n_rows)
        key_s, order = torch.sort(key, stable=True)
        starts = torch.searchsorted(
            key_s, torch.arange(n_rows + 1, dtype=key_s.dtype, device=dev))
        d_attr = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    err = _bwd_kernel()(ptr(idx), ptr(w), ptr(attrs), ptr(g), ptr(order),
                        ptr(starts), ptr(d_w), ptr(d_attr), idx.numel() // K,
                        K, d, n_rows, stream(dev))
    raise_on_error(err, "attr_merge_bwd")
    attr_merge_bwd.launches += 1
    return d_w, d_attr


attr_merge_bwd.launches = 0


class AttrMerge(torch.autograd.Function):
    """:func:`attr_merge` as an autograd node, differentiable in ``w`` and
    ``attrs``; its backward is :func:`attr_merge_bwd`."""

    @staticmethod
    def forward(ctx, w, attrs, idx):
        ctx.save_for_backward(w, attrs, idx)
        return attr_merge(idx, w, attrs)

    @staticmethod
    def backward(ctx, grad):
        w, attrs, idx = ctx.saved_tensors
        d_w, d_attr = attr_merge_bwd(idx, w, attrs, grad.contiguous(),
                                     ctx.needs_input_grad[0],
                                     ctx.needs_input_grad[1])
        return d_w, d_attr, None
