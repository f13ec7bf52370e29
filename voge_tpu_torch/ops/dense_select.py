"""The dense select and its analytic backward: the port of ``voge_tpu``'s
XLA route (``voge_tpu/ops/fine.py:99-329``: ``_gauss_feature_cols``,
``_residual_act``, ``_xla_select``, ``_fine_forward`` and the
``_ray_trace_fine`` custom VJP), which ``voge_tpu`` runs outside any Pallas
kernel for K above its kernels' 128 and off the TPU.

Every (ray, candidate) pair of a bin is evaluated in PyTorch ops, in the
inputs' dtype (float32 or float64) and on their device: the candidates are a
bin's list (``ops.coarse.rasterize_coarse``) or, with no coarse stage, every
Gaussian of the image in one whole-image bin.  The K nearest passing pairs
are kept in ascending length, ties to the lower candidate position (a stable
sort: ``lax.top_k``'s order); empty slots hold idx -1, len / act 1e10, dsd 0.
The work goes in chunks of bins and rays, so the hit tensors never exceed a
fixed number of pairs.  The backward is ``_ray_trace_fine_bwd``'s closed-form
chain rule over the selected entries (in K3's residual form); the
per-Gaussian sums go through the
grouping-based scatter of the attribute merge (``cuda_attr.attr_scatter``,
no float atomics) in float32, and through its plain version
(``index_add_``) in float64.

Two users:

- :func:`ray_tracing_dense`, the renderer's route for ``max_assign`` above
  the select kernel's ``MAX_K`` (``voge_tpu``'s large-K dispatch,
  ``fine.py:1303-1365``), chosen by K alone, in float32;
- the float64 oracle (:mod:`voge_tpu_torch.oracle`): the same route in
  float64, the reference the port holds its float32 kernels to without JAX.

The hit values and the select (:func:`hit_tensors`, :func:`nearest_k`) are
also what ``ops/dense.py``'s dense functions are built on.

The erf compositing weights of the selections are :func:`dense_weights`:
``aggregation.weights_from_sel`` evaluated in chunks of pixels, its backward
by recomputing each chunk under autograd (``voge_tpu`` differentiates the
same expression with ``jax.grad``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from voge_tpu_torch.aggregation import weights_from_sel
from voge_tpu_torch.ops.coarse import coarse_bin_config, rasterize_coarse
from voge_tpu_torch.ops.cuda_attr import AttrMerge, attr_scatter, attr_scatter_plain
from voge_tpu_torch.ops.cuda_fine_bwd import _slot_grads

_SENTINEL_LEN = 1e10
_SENTINEL_ACT = 1e10


def _budget(device: torch.device) -> int:
    """Pairs of one chunk: ~15 tensors of this many elements live at once."""
    return 1 << (25 if device.type == "cuda" else 21)


def _gauss_feature_cols(mus: torch.Tensor, isigmas: torch.Tensor) -> torch.Tensor:
    """(..., P, 16) feature rows [A0, A1, A2, msm, L00 .. L22, mu0, mu1, mu2]
    of (..., P, 3) means and (..., P, 3, 3) precisions, with A = Lambda^T mu
    (msk = mu^T Lambda r: the CUDA reference's contraction) and
    msm = mu^T Lambda mu."""
    mu = [mus[..., d] for d in range(3)]
    L = [[isigmas[..., i, j] for j in range(3)] for i in range(3)]
    A = [L[0][i] * mu[0] + L[1][i] * mu[1] + L[2][i] * mu[2] for i in range(3)]
    msm = mu[0] * A[0] + mu[1] * A[1] + mu[2] * A[2]
    return torch.stack(A + [msm] + [L[i][j] for i in range(3) for j in range(3)] + mu, -1)


def _residual_act(length, rf, cf):
    """act = d^T Lambda d with d = mu - len r, the compensated residual form
    of msm - msk^2 / ksk.

    :param length: (..., R, M); :param rf: (..., R, 12) ray features (r,
        then the nine r_i r_j); :param cf: (..., M, 16) candidate feature rows"""
    d = [cf[..., None, :, 13 + i] - length * rf[..., :, None, i] for i in range(3)]
    Lr = lambda i, j: cf[..., None, :, 4 + 3 * i + j]
    e = [sum(d[i] * Lr(i, j) for i in range(3)) for j in range(3)]
    return sum(e[j] * d[j] for j in range(3))


def _ray_features(rays: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit rays -> (..., 12): r and the nine r_i r_j."""
    r = [rays[..., d] for d in range(3)]
    return torch.stack(r + [r[i] * r[j] for i in range(3) for j in range(3)], -1)


def hit_tensors(rf: torch.Tensor, cf: torch.Tensor):
    """(length, act, dsd) of every (ray, candidate) pair: t* = msk / ksk,
    act = d^T Lambda d (:func:`_residual_act`), dsd = ksk = r^T Lambda r.

    :param rf: (..., R, 12) ray features; :param cf: (..., M, 16) feature rows
    :return: three tensors of shape (..., R, M)
    """
    msk = torch.einsum("...rd,...md->...rm", rf[..., 0:3], cf[..., 0:3])
    ksk = torch.einsum("...rq,...mq->...rm", rf[..., 3:12], cf[..., 4:13])
    length = msk / ksk
    return length, _residual_act(length, rf, cf), ksk


def nearest_k(length, act, dsd, thr_act: float, K: int, valid=None):
    """The K smallest lengths among pairs with ``act < thr_act`` (and
    ``valid``), ascending, ties to the lower position (a stable sort:
    ``lax.top_k``'s order); empty slots hold position -1, len / act 1e10,
    dsd 0.  Differentiable in the three hit tensors through the gathers.

    :return: (position int32, len, act, dsd), each (..., K)
    """
    ok = act < thr_act
    if valid is not None:
        ok = ok & valid
    lm = torch.where(ok, length, torch.full_like(length, _SENTINEL_LEN))
    kk = min(K, lm.shape[-1])
    order = torch.sort(lm.detach(), dim=-1, stable=True)[1][..., :kk]
    sel_ok = torch.gather(ok, -1, order)
    sel_pos = torch.where(sel_ok, order, -1).to(torch.int32)
    sel_len = torch.where(sel_ok, torch.gather(length, -1, order), _SENTINEL_LEN)
    sel_act = torch.where(sel_ok, torch.gather(act, -1, order), _SENTINEL_ACT)
    sel_dsd = torch.where(sel_ok, torch.gather(dsd, -1, order), 0.0)
    if kk < K:   # pad to K slots with empty entries
        pad = lambda x, v: torch.nn.functional.pad(x, (0, K - kk), value=v)
        sel_pos, sel_len = pad(sel_pos, -1), pad(sel_len, _SENTINEL_LEN)
        sel_act, sel_dsd = pad(sel_act, _SENTINEL_ACT), pad(sel_dsd, 0.0)
    return sel_pos, sel_len, sel_act, sel_dsd


def dense_select(rf: torch.Tensor, cf: torch.Tensor, cand: torch.Tensor,
                 thr_act: float, K: int):
    """The select over each bin's candidates (``_xla_select``).

    :param rf: (n, R, 12) ray features of each bin's rays
    :param cf: (n, M, 16) feature rows of each bin's candidates
    :param cand: (n, M) int32 candidate ids, -1 for none
    :return: (idx int32, len, act, dsd), each (n, R, K)
    """
    length, act, ksk = hit_tensors(rf, cf)
    pos, sel_len, sel_act, sel_dsd = nearest_k(length, act, ksk, thr_act, K,
                                               valid=(cand >= 0)[:, None, :])
    ids = torch.gather(cand[:, None, :].expand(length.shape), -1, pos.clamp(min=0).long())
    return torch.where(pos >= 0, ids, -1).to(torch.int32), sel_len, sel_act, sel_dsd


def _bin_rays(rays: torch.Tensor, BH: int, BW: int, bsh: int, bsw: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B * BH * BW, bsh * bsw, 3), zero rays past the image
    (they pass no candidate: their length is 0 / 0)."""
    B, H, W, _ = rays.shape
    x = torch.nn.functional.pad(rays, (0, 0, 0, BW * bsw - W, 0, BH * bsh - H))
    x = x.reshape(B, BH, bsh, BW, bsw, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * BH * BW, bsh * bsw, 3)


def _unbin(x: torch.Tensor, B, BH, BW, H, W, bsh, bsw) -> torch.Tensor:
    """(nb, R, K) -> (B, H, W, K)."""
    K = x.shape[-1]
    x = x.reshape(B, BH, BW, bsh, bsw, K).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, BH * bsh, BW * bsw, K)[:, :H, :W].contiguous()


@torch.no_grad()
def fine_forward(mus, isigmas, rays, bin_points, thr_act: float,
                 bin_size: Tuple[int, int], K: int):
    """``_fine_forward``: the selections of every pixel from its bin's list,
    in chunks of at most :func:`_budget` pairs.

    :param mus: (P, 3) flattened over the batch; :param isigmas: (P, 3, 3)
    :param rays: (B, H, W, 3); :param bin_points: (B, BH, BW, M) int32
    :return: (idx int32, len, act, dsd), each (B, H, W, K)

    The module's ``calls`` counts its calls (the route a render took).
    """
    global calls
    calls += 1
    B, H, W, _ = rays.shape
    _, BH, BW, M = bin_points.shape
    bsh, bsw = bin_size
    nb, R = B * BH * BW, bsh * bsw
    bp = bin_points.reshape(nb, M)
    if M > 0:    # the lists' padding is -1 at the end: trim it (one host read)
        M_used = int((bp >= 0).sum(-1).max())
        bp = bp[:, :max(M_used, 1)]
    M = bp.shape[1]
    cols = _gauss_feature_cols(mus, isigmas)
    rf = _ray_features(_bin_rays(rays, BH, BW, bsh, bsw))        # (nb, R, 12)
    budget = _budget(rays.device)
    rc = max(1, min(R, budget // max(M, 1)))                      # rays a chunk
    nbc = max(1, min(nb, budget // max(M * rc, 1)))               # bins a chunk
    outs = []
    for b0 in range(0, nb, nbc):
        cand = bp[b0:b0 + nbc]
        cf = cols[torch.where(cand >= 0, cand, 0).long()]         # (n, M, 16)
        parts = [dense_select(rf[b0:b0 + nbc, r0:r0 + rc], cf, cand, thr_act, K)
                 for r0 in range(0, R, rc)]
        outs.append([torch.cat(p, 1) for p in zip(*parts)])
    sel = [torch.cat(p, 0) for p in zip(*outs)]
    return tuple(_unbin(x, B, BH, BW, H, W, bsh, bsw) for x in sel)


calls = 0     # calls of fine_forward: the dense route's selects


def _segment_rows(packed: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Per-Gaussian sums of per-entry rows (E, C) by id (-1: none): the
    grouped scatter (its kernel on the card) in float32; in float64 (the
    oracle's backward) its plain version, since the kernel takes float32."""
    ids = idx.reshape(-1, 1).to(torch.int32).contiguous()
    scatter = attr_scatter if packed.dtype == torch.float32 else attr_scatter_plain
    ones = torch.ones(ids.shape, dtype=packed.dtype, device=packed.device)
    return scatter(ids, ones, packed.contiguous(), n_rows)


def fine_backward(mus, isigmas, rays, sel_idx, sel_len, sel_dsd, g_len, g_act, g_dsd):
    """``_ray_trace_fine_bwd``: the closed-form chain rule of
    ``ray_trace_voge.cu:324-330`` over the selected entries, in the residual
    form of K3's plain version (``cuda_fine_bwd._slot_grads``: the same
    function, evaluated around ``mu - len r`` so that float32 does not lose
    the ~len^2 factor ``voge_tpu``'s sum-then-combine order loses).

    :return: (grad_mus (P, 3), grad_isigmas (P, 3, 3), grad_rays (B, H, W, 3))
    """
    P = mus.shape[0]
    zero = lambda g: torch.zeros_like(sel_len) if g is None else g.to(mus.dtype)
    valid = sel_idx >= 0
    vf = valid.to(mus.dtype)
    cols = _gauss_feature_cols(mus, isigmas)
    feats = cols[torch.where(valid, sel_idx, 0).long()]          # (B, H, W, K, 16)
    gd = zero(g_dsd) * vf
    cl = zero(g_len) / torch.where(valid, sel_dsd, 1.0) * vf
    ga = zero(g_act) * vf
    lv = torch.where(valid, sel_len, 0.0)
    g_mu, g_L, g_ray = _slot_grads(feats, rays[..., None, :], gd[..., None], cl[..., None],
                                   ga[..., None], lv[..., None], True)
    grad_rays = torch.where(valid[..., None], g_ray, 0.0).sum(-2)
    rows = _segment_rows(torch.cat([g_mu, g_L], -1).reshape(-1, 12),
                         torch.where(valid, sel_idx, -1), P)
    return rows[:, 0:3], rows[:, 3:12].reshape(P, 3, 3), grad_rays


class DenseFineSelect(torch.autograd.Function):
    """``voge_tpu``'s ``_ray_trace_fine`` custom VJP: differentiable in
    ``mus`` (P, 3), ``isigmas`` (P, 3, 3), both flattened over the batch, and
    ``rays`` (B, H, W, 3); ``bin_points`` (B, BH, BW, M) int32 lists each
    bin's candidates.  Saves the inputs and the selected ids, lengths and
    dsd: the backward evaluates the chain rule at the selected entries."""

    @staticmethod
    def forward(ctx, mus, isigmas, rays, bin_points, thr_act, bin_size, K):
        out = fine_forward(mus, isigmas, rays, bin_points, thr_act, bin_size, K)
        ctx.mark_non_differentiable(out[0])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(mus, isigmas, rays, out[0], out[1], out[3])
        return out

    @staticmethod
    def backward(ctx, _g_idx, g_len, g_act, g_dsd):
        mus, isigmas, rays, sel_idx, sel_len, sel_dsd = ctx.saved_tensors
        if g_len is None and g_act is None and g_dsd is None:
            return (None,) * 7
        g_mus, g_isig, g_rays = fine_backward(mus, isigmas, rays, sel_idx, sel_len, sel_dsd,
                                              g_len, g_act, g_dsd)
        needs = ctx.needs_input_grad
        return (g_mus if needs[0] else None, g_isig if needs[1] else None,
                g_rays if needs[2] else None, None, None, None, None)


def _weight_chunks(n_pix: int, K: int, device: torch.device) -> int:
    return max(1, min(n_pix, 4 * _budget(device) // max(K * K, 1)))


class DenseWeights(torch.autograd.Function):
    """:func:`voge_tpu_torch.aggregation.weights_from_sel` over (..., K)
    selections in chunks of pixels (its (..., K, K) terms bounded); the
    backward recomputes each chunk under autograd.  Slots past the most any
    pixel filled (one host read) hold act 1e10: their weights, their terms in
    the others' sums and their gradients are exactly 0, so only the filled
    columns are evaluated."""

    @staticmethod
    def forward(ctx, length, act, dsd, agg_ow):
        K = length.shape[-1]
        kv = max(1, int((act < 0.5 * _SENTINEL_ACT).sum(-1).max())) if act.numel() else 1
        l2, a2, d2 = (x.reshape(-1, K)[:, :kv] for x in (length, act, dsd))
        n = _weight_chunks(l2.shape[0], kv, length.device)
        w = torch.cat([weights_from_sel(l2[i:i + n], a2[i:i + n], d2[i:i + n], agg_ow)
                       for i in range(0, l2.shape[0], n)])
        ctx.save_for_backward(length, act, dsd)
        ctx.agg_ow, ctx.kv = agg_ow, kv
        return torch.nn.functional.pad(w, (0, K - kv)).reshape(length.shape)

    @staticmethod
    def backward(ctx, g):
        length, act, dsd = ctx.saved_tensors
        K, kv = length.shape[-1], ctx.kv
        l2, a2, d2 = (x.reshape(-1, K)[:, :kv] for x in (length, act, dsd))
        g2 = g.reshape(-1, K)[:, :kv]
        n = _weight_chunks(l2.shape[0], kv, length.device)
        grads = [[], [], []]
        for i in range(0, l2.shape[0], n):
            with torch.enable_grad():
                xs = [x[i:i + n].detach().requires_grad_(True) for x in (l2, a2, d2)]
                w = weights_from_sel(*xs, ctx.agg_ow)
                for acc, gx in zip(grads, torch.autograd.grad(w, xs, g2[i:i + n])):
                    acc.append(gx)
        return tuple(torch.nn.functional.pad(torch.cat(acc), (0, K - kv)).reshape(length.shape)
                     for acc in grads) + (None,)


def dense_weights(length, act, dsd, agg_ow: float = 1.0) -> torch.Tensor:
    """Erf compositing weights (..., K) of selections, differentiable in
    ``length``, ``act`` and ``dsd``."""
    return DenseWeights.apply(length, act, dsd, float(agg_ow))


def whole_image_bins(B: int, P: int, device) -> torch.Tensor:
    """(B, 1, 1, P) int32: every Gaussian of image b, ids ``b * P + p``."""
    return torch.arange(B * P, dtype=torch.int32, device=device).reshape(B, 1, 1, P)


def ray_tracing_dense(cams, points: torch.Tensor, isigmas: torch.Tensor,
                      rays: torch.Tensor, image_size, thr: float, n_assign: int,
                      bin_size: Optional[int] = None,
                      max_points_per_bin: Optional[int] = None, agg_ow: float = 1.0,
                      attrs: Optional[torch.Tensor] = None, camera_grad: bool = True,
                      origins: Optional[torch.Tensor] = None):
    """``voge_tpu.ops.fine.ray_tracing``'s route off its kernels
    (``fine.py:1334-1365``): ``rasterize_coarse``'s per-bin lists (their
    truncation at ``max_points_per_bin`` counted as overflow, as
    ``voge_tpu`` counts it) or, for ``max_points_per_bin == -1``, one
    whole-image bin of every Gaussian; then the dense select, the erf
    weights and, given attributes, the attribute image (the attribute
    merge, K3f / K4b, in float32).  Same arguments and return as
    :func:`voge_tpu_torch.ops.fine.ray_tracing`; computes in the dtype of
    ``points`` (float32; float64 for the oracle, which passes no
    ``attrs``)."""
    B, P = points.shape[0], points.shape[1]
    H, W = int(image_size[0]), int(image_size[1])
    bs, mppb = coarse_bin_config((H, W), n_assign, P, bin_size, max_points_per_bin)
    dt = points.dtype
    if origins is not None:
        points = points - origins.to(dt)[:, None, :]
    rays = rays.to(dt)
    if not camera_grad:
        rays = rays.detach()
    overflow = torch.zeros((), dtype=torch.int32, device=points.device)
    if mppb == -1:
        bin_points, eff = whole_image_bins(B, P, points.device), (H, W)
    else:
        with torch.no_grad():
            R, T, focal, principal = (torch.as_tensor(x, device=points.device).to(dt)
                                      for x in cams)
            bin_points, counts = rasterize_coarse(
                R, T, focal, principal, points.detach(), isigmas.detach(), (H, W), thr,
                bs, mppb, return_counts=True)
            overflow = (counts - mppb).clamp(min=0).sum().to(torch.int32)
        eff = (bs, bs)
    sel = DenseFineSelect.apply(points.reshape(-1, 3), isigmas.reshape(-1, 3, 3),
                                rays.contiguous(), bin_points,
                                -math.log(thr + 1.0 / 1e10), eff, int(n_assign))
    w = dense_weights(sel[1], sel[2], sel[3], agg_ow)
    img = None
    if attrs is not None:
        a = attrs.to(torch.float32).reshape(B * P, attrs.shape[-1]).contiguous()
        img = AttrMerge.apply(w.contiguous(), a, sel[0].contiguous())
    return tuple(sel) + (w, img), overflow
