"""K3f: attribute merge forward (``csrc/attr_merge.cu``) and its plain
PyTorch version: ``img[..., :] = sum_k w[..., k] * attrs[idx[..., k], :]``
over slots with ``idx >= 0``.

Replaces ``voge_tpu/ops/pallas_attr.py::_fwd_kernel`` (``attr_merge_compact``
/ ``attr_merge_fwd_pallas``), which id-matches candidate chunks and contracts
them on the MXU because gathers are slow on a TPU.  On Hopper it is a direct
gather-and-reduce, one thread per (pixel, channel), sharing its device
function with K2's fused attribute image.  Bound on the H100: memory (a few
MB at the headline), in practice launch latency.

:class:`AttrMerge` wraps it as an autograd node whose backward raises until
the attribute backward kernels are ported.
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


class AttrMerge(torch.autograd.Function):
    """:func:`attr_merge` as an autograd node (differentiable in ``w`` and
    ``attrs``); the backward is not ported yet."""

    @staticmethod
    def forward(ctx, w, attrs, idx):
        return attr_merge(idx, w, attrs)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "voge_tpu_torch renders forward only: the attribute-merge "
            "backward (voge_tpu/ops/pallas_attr.py::_bwd_unified_kernel) "
            "is ported after the select backward "
            "(pallas_bwd.py::_bwd_t_kernel, ROADMAP queue 2)")
