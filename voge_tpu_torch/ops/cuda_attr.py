"""The attribute merge and its backward: K3f (``csrc/attr_merge.cu``), K4b
and its two halves on their own (``csrc/attr_merge_bwd.cu``), each beside its
plain PyTorch version.

- :func:`attr_merge` (K3f): ``img[..., :] = sum_k w[..., k] * attrs[idx[...,
  k], :]`` over slots with ``idx >= 0``.  Replaces
  ``voge_tpu/ops/pallas_attr.py::_fwd_kernel`` (``attr_merge_compact`` /
  ``attr_merge_fwd_pallas``), which id-matches candidate chunks and contracts
  them on the MXU because gathers are slow on a TPU.  On Hopper it is a direct
  gather-and-reduce: each warp copies its pixels' ids once into shared
  memory (16-byte ``cp.async``), then a thread sums up to four channels of a
  pixel in registers, in slot order, loading the valid slots' weights beside
  their attribute rows, and the block's outputs leave as 16-byte stores.
- :func:`attr_dw`: ``d_w[..., k] = attrs[idx[..., k]] . g`` (replaces
  ``_bwd_w_kernel``), a gather, four consecutive slots of a pixel a thread
  (one 16-byte load of ids, the pixel's ``g`` row read once for the four).
- :func:`slot_runs` (``csrc/slot_runs.cu``): the grouping every run kernel
  takes, the valid slots of the flattened ids grouped by id in slot order
  (``order``) and each id's run start (``starts``), by a stable radix sort of
  the valid slots on the bits the ids have; equal to the bit to the stable
  ``torch.sort`` + ``searchsorted`` of :func:`slot_runs_plain`.
- :func:`attr_scatter`: ``out[j]`` = the sum of ``w * g`` over the slots
  holding ``j`` (replaces ``_bwd_attr_kernel``).  :func:`slot_runs` groups
  each row's slots into a run in slot order; a warp per short run and a
  block per long one sum it in one fixed order, without float atomics.  It is
  the d_attr half of the merge's VJP and, with an image as ``g``, the texture
  sampler's forward (``voge_tpu_torch.sampler``).
- :func:`attr_merge_bwd` (K4b, replaces ``_bwd_unified_kernel``): both halves
  in one call over the same device kernels; asked for one half it hands over
  to that half's entry.

Bound on the H100: memory (a few MB at the 10K-Gaussian headline, where
launch latency and the wrapper's host time dominate; ~110 MB of slots at the
texture shapes, of which the grouping reads the ids and writes the valid
slots' order).  The wrappers bind their C entries once
(``_dispatch.bind``) and keep every check that raises.

:class:`AttrMerge` wraps K3f as an autograd node whose backward is
:func:`attr_merge_bwd`.
"""
from __future__ import annotations

import torch

from voge_tpu_torch import trace
from voge_tpu_torch.ops._dispatch import (
    INT, LONG, VOIDP, bind, check, on_cuda, ptr, raise_on_error, stream,
)

# (library, symbol, argtypes) of each C entry this module launches
_MERGE = ("attr_merge", "voge_attr_merge", (VOIDP,) * 4 + (LONG, INT, INT, LONG, VOIDP))
_RUNS = ("slot_runs", "voge_slot_runs", (VOIDP,) * 4 + (LONG, LONG, VOIDP))
_RUNS_SCRATCH = ("slot_runs", "voge_slot_runs_scratch", (LONG,), LONG)
_DW = ("attr_merge_bwd", "voge_attr_dw", (VOIDP,) * 4 + (LONG, INT, INT, LONG, VOIDP))
_SCATTER = ("attr_merge_bwd", "voge_attr_scatter", (VOIDP,) * 6 + (LONG, INT, INT, LONG, VOIDP))
_BWD = ("attr_merge_bwd", "voge_attr_merge_bwd", (VOIDP,) * 9 + (LONG, INT, INT, LONG, VOIDP))


def attr_merge_plain(idx, w, attrs):
    """Plain version of K3f; same contract as :func:`attr_merge`."""
    valid = idx >= 0
    rows = attrs[torch.where(valid, idx, 0).long()]           # (..., K, d)
    return (rows * torch.where(valid, w, 0.0)[..., None]).sum(-2)


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
    out = w.new_empty(idx.shape[:-1] + (d,))
    err = bind(*_MERGE)(ptr(idx), ptr(w), ptr(attrs), ptr(out), n_pix, K, d,
                        attrs.shape[0], stream(idx.device))
    raise_on_error(err, "attr_merge")
    trace.count("launch.attr_merge")
    return out


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
        d_attr = attr_scatter_plain(idx, w, g, n_rows)
    return d_w, d_attr


def attr_dw_plain(idx, attrs, g):
    """Plain version of :func:`attr_dw`."""
    return attr_merge_bwd_plain(idx, None, attrs, g, need_attr=False)[0]


def attr_scatter_plain(idx, w, g, n_rows: int):
    """Plain version of :func:`attr_scatter` (``index_add_``)."""
    d = g.shape[-1]
    valid = (idx >= 0) & (idx < n_rows)
    vals = (torch.where(valid, w, 0.0)[..., None] * g[..., None, :]).reshape(-1, d)
    seg = torch.where(valid, idx, n_rows).long().reshape(-1)
    return g.new_zeros((n_rows + 1, d)).index_add_(0, seg, vals)[:n_rows]


def _check_slots(idx, g, w=None):
    check(idx, "idx", torch.int32)
    if idx.ndim < 1 or idx.numel() == 0:
        raise ValueError(f"idx: expected (..., K) with elements, got {tuple(idx.shape)}")
    if g.ndim < 1:
        raise ValueError(f"g: expected (..., d), got {tuple(g.shape)}")
    check(g, "g", torch.float32, idx.shape[:-1] + (g.shape[-1],))
    if w is not None:
        check(w, "w", torch.float32, idx.shape)
    return idx.numel() // idx.shape[-1], idx.shape[-1], g.shape[-1]


def _check_attrs(attrs, d: int):
    check(attrs, "attrs", torch.float32)
    if attrs.ndim != 2 or attrs.shape[1] != d:
        raise ValueError(f"attrs: expected (rows, {d}), got {tuple(attrs.shape)}")
    return attrs.shape[0]


def slot_runs_plain(idx, n_rows: int):
    """Plain version of :func:`slot_runs`: a stable ``torch.sort`` of the
    flattened ids (out-of-range ones keyed ``n_rows``, behind the last run)
    and a ``searchsorted`` of the run edges; ``order`` as int32."""
    flat = idx.reshape(-1)
    key = torch.where((flat >= 0) & (flat < n_rows), flat, n_rows)
    key_s, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        key_s, torch.arange(n_rows + 1, dtype=key_s.dtype, device=idx.device))
    return order.to(torch.int32), starts.to(torch.int64)


def slot_runs(idx: torch.Tensor, n_rows: int):
    """Group the flattened slots by the id they hold.

    :param idx: (..., K) int32 ids; ids outside ``[0, n_rows)`` hold nothing
    :param n_rows: the number of ids
    :return: (order (idx.numel(),) int32, starts (n_rows + 1,) int64): the
        slots holding ``j`` are ``order[starts[j]:starts[j + 1]]`` in
        ascending slot order; ``order[starts[n_rows]:]`` is unspecified
    """
    with trace.span("voge.grouping"):
        if not on_cuda(idx):
            return slot_runs_plain(idx, n_rows)
        check(idx, "idx", torch.int32)
        n = idx.numel()
        if not 0 < n < 2 ** 31:
            raise ValueError(f"idx: expected 1 to 2^31 - 1 slots, got {n}")
        if not 0 < n_rows < 2 ** 31 - 1:
            raise ValueError(f"n_rows: expected 1 to 2^31 - 2, got {n_rows}")
        dev = idx.device
        scratch = idx.new_empty(bind(*_RUNS_SCRATCH)(n))
        order = idx.new_empty(n)
        starts = idx.new_empty(n_rows + 1, dtype=torch.int64)
        err = bind(*_RUNS)(ptr(idx), ptr(order), ptr(starts), ptr(scratch), n, n_rows,
                           stream(dev))
        raise_on_error(err, "slot_runs")
        trace.count("launch.slot_runs")
        return order, starts


def attr_dw(idx: torch.Tensor, attrs: torch.Tensor, g: torch.Tensor):
    """The weight half of the merge's backward, on its own.

    :param idx: (..., K) int32 ids, -1 for empty slots
    :param attrs: (rows, d) float32; :param g: (..., d) float32
    :return: d_w (..., K) float32, ``attrs[idx] . g``, 0 on empty slots
    """
    if not on_cuda(idx, attrs, g):
        return attr_dw_plain(idx, attrs, g)
    n_pix, K, d = _check_slots(idx, g)
    n_rows = _check_attrs(attrs, d)
    d_w = g.new_empty(idx.shape)
    err = bind(*_DW)(ptr(idx), ptr(g), ptr(attrs), ptr(d_w), n_pix, K, d, n_rows,
                     stream(idx.device))
    raise_on_error(err, "attr_dw")
    trace.count("launch.attr_dw")
    return d_w


def attr_scatter(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                 n_rows: int):
    """The attribute half of the merge's backward, on its own: scatter
    per-pixel rows onto the ids their slots hold.

    :param idx: (..., K) int32 ids, -1 for empty slots
    :param w: (..., K) float32 weights; :param g: (..., d) float32
    :param n_rows: rows of the result; ids outside ``[0, n_rows)`` add nothing
    :return: (n_rows, d) float32, ``out[j] = sum over slots with idx == j of
        w[slot] * g[pixel(slot)]`` in ascending slot order
    """
    if not on_cuda(idx, w, g):
        return attr_scatter_plain(idx, w, g, n_rows)
    n_pix, K, d = _check_slots(idx, g, w)
    if n_rows <= 0:
        raise ValueError(f"n_rows: expected a positive count, got {n_rows}")
    order, starts = slot_runs(idx, n_rows)
    out = g.new_empty((n_rows, d))
    rows = idx.new_empty(n_rows + 1)
    err = bind(*_SCATTER)(ptr(order), ptr(starts), ptr(w), ptr(g), ptr(out), ptr(rows),
                          n_pix, K, d, n_rows, stream(idx.device))
    raise_on_error(err, "attr_scatter")
    trace.count("launch.attr_scatter")
    return out


def attr_merge_bwd(idx: torch.Tensor, w: torch.Tensor, attrs: torch.Tensor,
                   g: torch.Tensor, need_w: bool = True, need_attr: bool = True):
    """Backward of :func:`attr_merge`: both halves in one call (K4b); one
    half alone goes to :func:`attr_dw` / :func:`attr_scatter`.

    :param idx, w, attrs: as for :func:`attr_merge`
    :param g: (..., d) float32 cotangent of the attribute map
    :return: (d_w (..., K) or None, d_attr (rows, d) or None)
    """
    if not on_cuda(idx, w, attrs, g):
        return attr_merge_bwd_plain(idx, w, attrs, g, need_w, need_attr)
    if not (need_w and need_attr):
        return (attr_dw(idx, attrs, g) if need_w else None,
                attr_scatter(idx, w, g, attrs.shape[0]) if need_attr else None)
    n_pix, K, d = _check_slots(idx, g, w)
    n_rows = _check_attrs(attrs, d)
    dev = idx.device
    order, starts = slot_runs(idx, n_rows)
    d_w = w.new_empty(w.shape)
    d_attr = g.new_empty((n_rows, d))
    rows = idx.new_empty(n_rows + 1)
    err = bind(*_BWD)(ptr(idx), ptr(w), ptr(attrs), ptr(g), ptr(order), ptr(starts),
                      ptr(d_w), ptr(d_attr), ptr(rows), n_pix, K, d, n_rows, stream(dev))
    raise_on_error(err, "attr_merge_bwd")
    trace.count("launch.attr_merge_bwd")
    return d_w, d_attr


class AttrMerge(torch.autograd.Function):
    """:func:`attr_merge` as an autograd node, differentiable in ``w`` and
    ``attrs``; its backward is :func:`attr_merge_bwd`."""

    @staticmethod
    def forward(ctx, w, attrs, idx):
        ctx.save_for_backward(w, attrs, idx)
        with trace.span("voge.attr"):
            return attr_merge(idx, w, attrs)

    @staticmethod
    def backward(ctx, grad):
        w, attrs, idx = ctx.saved_tensors
        with trace.span("voge.attr_bwd"):
            d_w, d_attr = attr_merge_bwd(idx, w, attrs, grad.contiguous(),
                                         ctx.needs_input_grad[0],
                                         ctx.needs_input_grad[1])
        return d_w, d_attr, None
