"""K3: the fine backward (``csrc/fine_bwd.cu``) and the weight-cotangent
fold (``csrc/fold_weights.cu``, the device function of ``csrc/fine_bwd.cuh``),
with their plain PyTorch versions.

K3 is two kernels: a per-slot kernel (one thread per (ray, slot)) and a
per-Gaussian kernel (a group of lanes per Gaussian, over the run of the slot
ids grouped by id, ``cuda_attr.slot_runs``).  Four wrappers launch them:

- :func:`fine_bwd` replaces ``voge_tpu/ops/pallas_bwd.py::_bwd_t_kernel``
  (``fine_bwd_compact_t_pallas``, the emission-compacted path, with the
  attribute VJP), and :func:`fine_bwd_global` ``pallas_bwd.py::
  _bwd_unified_kernel`` (``fine_bwd_unified_pallas``, the global candidate
  space of the no-coarse path and the two-stage tracer): both kernels.  From
  the select's saved image-layout outputs (idx, len, act, dsd, w) and their
  cotangents, the per-slot kernel folds the weight cotangent (and, with
  attributes, the attribute image's weight cotangent) into the len / act /
  dsd cotangents, applies the entry-space chain rule and sums the ray
  gradient (3) per ray; the per-Gaussian kernel sums the gradients of mu
  (3), Lambda (9) and the attributes (d) in a fixed order.
- :func:`fine_bwd_gauss` and :func:`fine_bwd_rays` replace
  ``pallas_bwd.py::_bwd_gauss_kernel`` (``fine_bwd_gauss_pallas``) and
  ``_bwd_rays_kernel`` (``fine_bwd_rays_pallas``), the global backward as a
  per-Gaussian and a per-ray half, on cotangents of len / act / dsd with the
  weight cotangent already folded in: the per-Gaussian half is both kernels
  with the fold off, the per-ray half the per-slot kernel alone, writing no
  coefficients.  Given ``act``, ``w`` and a weight cotangent (and
  attributes), the per-ray half folds them in the same launch: the backward
  of a frozen scene, where only the rays (and the camera centres) need a
  gradient (``ops.fine``).

A slot's id ``b * P + p`` is its row of the (B * P, 16) feature table and of
the output, so the entries return per-Gaussian rows: no float atomics, two
runs give the same bits.  :func:`group_width` sets the per-Gaussian kernel's
lanes a Gaussian from the shapes alone.

The chain rule is ``voge_tpu``'s (``ray_trace_voge.cu:324-326``: with
``ksk = dsd``, ``msk = len * dsd``, ``g_ksk = (g_a msk - g_l) msk / ksk^2 +
g_d``, ``g_msk = (g_l - 2 g_a msk) / ksk``, ``g_msm = g_a``), rewritten around
the residual ``delta = mu - len * r`` that the forward's activation also uses
(the compensated residual form).  With ``c = g_l / ksk``:

    g_Lambda = g_d r r^T + (c - g_a l) delta r^T + g_a l r delta^T
               + g_a delta delta^T
    g_mu     = c Lambda r + g_a l (Lambda^T - Lambda) r
               + g_a (Lambda + Lambda^T) delta
    g_r      = g_d (Lambda + Lambda^T) r + g_a l^2 (Lambda - Lambda^T) r
               - c l Lambda r + (c - 2 g_a l) Lambda^T delta

The same function: ``voge_tpu``'s terms in ``mu mu^T`` and ``mu r^T`` are
~``len^2`` (~36 at the headline) times larger than their sum, and forming
the per-row sums first and combining them with ``mu`` afterwards loses
that factor in float32 (the sigma gradient of the 9,602-Gaussian headline
was 3.8e-3 from a float64 evaluation; this form keeps it near 1e-4).

``fold_weights`` replaces ``voge_tpu/ops/pallas_fine2.py::fold_weights_pallas``:
the same fold on its own.  The plain versions use ``torch.erf``, ``voge_tpu``
a rational polynomial (``pallas_fine2._erf32``); the two differ by about 1e-7.
"""
from __future__ import annotations

from typing import Optional

import torch

from voge_tpu_torch import trace
from voge_tpu_torch.ops._dispatch import (
    FLOAT, INT, LONG, VOIDP, bind, check, on_cuda, ptr, raise_on_error, stream,
)
from voge_tpu_torch.ops.cuda_attr import slot_runs
from voge_tpu_torch.ops.cuda_fine import FEAT, MAX_K

_INV_SQRT_PI = 0.5641895835477563


def fold_weights_plain(length, act, dsd, w, g_w, ow: float):
    """Plain version of the fold; same contract as :func:`fold_weights`."""
    s = torch.sqrt(dsd + 1e-10)
    e = torch.exp(-act)
    G = g_w * w
    B = torch.zeros_like(length)
    A, C, D = [], [], []
    for k in range(length.shape[-1]):
        diff = length - length[..., k:k + 1]
        ca = diff * s[..., k:k + 1]
        phi = torch.exp(-ca * ca) * _INV_SQRT_PI
        Phi = (torch.erf(ca) + 1.0) * 0.5
        A.append((G * Phi).sum(-1))
        C.append((G * phi).sum(-1))
        D.append((G * phi * diff).sum(-1))
        B = B + (e[..., k:k + 1] * s[..., k:k + 1]) * phi
    A, C, D = (torch.stack(x, dim=-1) for x in (A, C, D))
    da = -G + ow * e * A
    dl = -ow * (G * B - e * s * C)
    dd = -ow * e * D * (0.5 / s)
    return dl, da, dd


def _fold_kernel():
    return bind("fold_weights", "voge_fold_weights", [VOIDP] * 8 + [LONG, INT, FLOAT, VOIDP])


def fold_weights(length, act, dsd, w, g_w, ow: float):
    """Cotangents of (len, act, dsd) from the cotangent ``g_w`` of the erf
    compositing weights ``w`` (``aggregation.weights_from_sel``).

    :param length, act, dsd, w, g_w: (..., K) float32, the select's outputs
        (invalid slots: len / act 1e10, dsd 0, w 0) and the weight cotangent
    :param ow: occupation weight of the compositing
    :return: (dl, da, dd), each (..., K) float32
    """
    if not on_cuda(length, act, dsd, w, g_w):
        return fold_weights_plain(length, act, dsd, w, g_w, ow)
    K = length.shape[-1]
    if not 0 < K <= MAX_K:
        raise NotImplementedError(f"K={K}: the fold kernel takes 1 <= K <= {MAX_K}")
    for t, name in ((length, "length"), (act, "act"), (dsd, "dsd"), (w, "w"),
                    (g_w, "g_w")):
        check(t, name, torch.float32, length.shape)
    dl, da, dd = (torch.empty_like(length) for _ in range(3))
    err = _fold_kernel()(
        ptr(length), ptr(act), ptr(dsd), ptr(w), ptr(g_w), ptr(dl), ptr(da),
        ptr(dd), length.numel() // K, K, float(ow), stream(length.device))
    raise_on_error(err, "fold_weights")
    trace.count("launch.fold_weights")
    return dl, da, dd


GROUP_MIN = 4    # the fewest lanes a Gaussian in K3's per-Gaussian kernel


def group_width(n_slots: int, n_tab: int) -> int:
    """Lanes a Gaussian in K3's per-Gaussian kernel, from the shapes alone
    (no host read): a lane for every two slots a Gaussian could hold on
    average (``n_slots / n_tab``, ``n_slots`` = rays x K), rounded up to a
    power of two and clamped to [``GROUP_MIN``, 32].  A warp a Gaussian
    wherever Gaussians hold many slots (every shape with a golden file:
    136 and more slots a Gaussian); 4 at the 300,000-point cloud (6.8).
    Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6): 4 lanes
    beat 8, 16 and 32 at the 300K cloud (the kernel 0.035 ms against 0.047,
    0.076, 0.140); at the headline and ShapeFitting shapes 16 and 32 are
    within 0.002 ms and 4 is the slowest.  The lanes' sums are a fixed tree, so a shape
    gives the same bits on every run."""
    half = n_slots / (2 * max(n_tab, 1))
    g = GROUP_MIN
    while g < half and g < 32:
        g *= 2
    return g


def _slot_coefs(idx, length, act, dsd, w, g_len, g_act, g_dsd, g_w,
                agg_ow: float, attrs=None, g_img=None):
    """Per-slot chain-rule coefficients (g_d, c = g_len / ksk, g_a, l), each
    (..., K), zero on empty slots: the weight cotangent (plus, with
    attributes, the fused image's d_w) folded into (g_len, g_act, g_dsd).
    With neither ``g_w`` nor attributes there is nothing to fold (``act`` and
    ``w`` may be None)."""
    zero = lambda g: torch.zeros_like(length) if g is None else g
    gl, ga, gd = (zero(g) for g in (g_len, g_act, g_dsd))
    valid = idx >= 0
    if g_w is not None or attrs is not None:
        gw = zero(g_w)
        if attrs is not None:
            ok = valid & (idx < attrs.shape[0])
            dw = (attrs[torch.where(ok, idx, 0).long()] * g_img[..., None, :]).sum(-1)
            gw = gw + torch.where(ok, dw, 0.0)
        dl, da, dd = fold_weights_plain(length, act, dsd, w, gw, agg_ow)
        gl, ga, gd = gl + dl, ga + da, gd + dd
    vf = valid.to(length.dtype)
    cl = gl / torch.where(valid, dsd, 1.0) * vf
    return gd * vf, cl, ga * vf, torch.where(valid, length, 0.0)


def _slot_grads(feats, r, gd, cl, ga, lv, want_rays: bool):
    """Per-slot gradients of the chain rule in the residual form (module
    note): (g_mu (..., 3), g_Lambda (..., 9) row-major, g_ray (..., 3) or
    None) from the slots' feature rows ``feats`` (..., 16), rays ``r``
    (..., 3) and coefficients (..., 1)."""
    L = feats[..., 4:13].reshape(feats.shape[:-1] + (3, 3))
    Lt = L.transpose(-1, -2)
    delta = feats[..., 13:16] - lv * r                           # mu - l r
    mv = lambda m, v: (m * v[..., None, :]).sum(-1)             # m @ v
    Lr, La_r = mv(L, r), mv(L - Lt, r)
    g_mu = cl * Lr - ga * lv * La_r + ga * mv(L + Lt, delta)
    outer = lambda a, b: (a[..., :, None] * b[..., None, :]).flatten(-2)
    g_L = (gd * outer(r, r) + (cl - ga * lv) * outer(delta, r)
           + ga * lv * outer(r, delta) + ga * outer(delta, delta))
    g_ray = None
    if want_rays:
        g_ray = (gd * mv(L + Lt, r) + ga * lv * lv * La_r - cl * lv * Lr
                 + (cl - 2.0 * ga * lv) * mv(Lt, delta))
    return g_mu, g_L, g_ray


def _check_split(rays, table, idx, length, dsd, grads):
    """Shapes and types of a global-space backward's arguments; (rows of the
    table, K)."""
    B, H, W, K = idx.shape
    if K <= 0:
        raise ValueError(f"idx: expected (B, H, W, K) with K > 0, got {tuple(idx.shape)}")
    check(rays, "rays", torch.float32, (B, H, W, 3))
    if table.ndim != 2 or table.shape[0] == 0:
        raise ValueError(f"table: expected (rows, {FEAT}), got {tuple(table.shape)}")
    check(table, "table", torch.float32, (table.shape[0], FEAT))
    check(idx, "idx", torch.int32)
    for t, name in ((length, "len"), (dsd, "dsd")):
        check(t, name, torch.float32, idx.shape)
    for t, name in zip(grads, ("g_len", "g_act", "g_dsd")):
        if t is not None:
            check(t, name, torch.float32, idx.shape)
    return table.shape[0], K


def _check_fold(rays, table, idx, length, act, dsd, w, grads, attrs, g_img):
    """The arguments of a backward that may fold the weight cotangent;
    (rows of the table, K, d)."""
    n_tab, K = _check_split(rays, table, idx, length, dsd, grads[:3])
    for t, name in ((act, "act"), (w, "w"), (grads[3], "g_w")):
        if t is not None:
            check(t, name, torch.float32, idx.shape)
    if (attrs is None) != (g_img is None):
        raise ValueError("attrs and g_img go together")
    if (grads[3] is not None or attrs is not None) and (act is None or w is None):
        raise ValueError("the weight fold (g_w or attributes) needs act and w")
    d = 0
    if attrs is not None:
        if attrs.ndim != 2:
            raise ValueError(f"attrs: expected (rows, d), got {tuple(attrs.shape)}")
        d = attrs.shape[1]
        check(attrs, "attrs", torch.float32, (n_tab, d))
        check(g_img, "g_img", torch.float32, idx.shape[:3] + (d,))
    return n_tab, K, d


def _check_k(K: int, what: str):
    if K > MAX_K:
        raise NotImplementedError(
            f"K={K}: {what} takes 1 <= K <= MAX_K = {MAX_K}; larger K takes the "
            "dense route (ops.dense_select)")


def _check_bwd(rays, table, idx, length, act, dsd, w, grads, attrs, g_img):
    """K3's arguments (:func:`fine_bwd`); (rows of the table, K, d)."""
    n_tab, K, d = _check_fold(rays, table, idx, length, act, dsd, w, grads, attrs, g_img)
    _check_k(K, "the backward kernel")
    return n_tab, K, d


def _plain(rays, table, idx, length, act, dsd, w, grads, agg_ow, attrs, g_img,
           want_rows: bool, want_rays: bool, want_mu: bool):
    """K3's plain version: dense tensor ops per slot, each slot's feature row
    read by its id; per Gaussian a segmented sum (``index_add_``), per ray a
    sum over its slots (``voge_tpu``'s entry-space backward,
    ``fine.py:259-329``, in the residual form).  (rows or None, g_rays or
    None, g_mu or None)."""
    n_tab, d = table.shape[0], 0 if attrs is None else attrs.shape[1]
    coefs = _slot_coefs(idx, length, act, dsd, w, *grads, agg_ow, attrs, g_img)
    ok = (idx >= 0) & (idx < n_tab)
    seg = torch.where(ok, idx, n_tab).long()                     # (B, H, W, K)
    feats = torch.cat([table, table.new_zeros((1, FEAT))])[seg]
    g_mu, g_L, g_ray = _slot_grads(feats, rays[..., None, :],
                                   *(c[..., None] for c in coefs), want_rays)
    rows = None
    if want_rows:
        cols = [g_mu, g_L]
        if d:
            cols.append(w[..., None] * g_img[..., None, :])
        vals = torch.cat(cols, dim=-1).reshape(-1, 12 + d)
        rows = vals.new_zeros((n_tab + 1, 12 + d)).index_add_(0, seg.reshape(-1), vals)
        rows = rows[:n_tab]
    per_ray = lambda g: torch.where(ok[..., None], g, 0.0).sum(-2)
    return (rows, per_ray(g_ray) if want_rays else None,
            per_ray(g_mu) if want_mu else None)


def fine_bwd_plain(rays, table, idx, length, act, dsd, w, g_len, g_act, g_dsd,
                   g_w, agg_ow: float, attrs: Optional[torch.Tensor] = None,
                   g_img: Optional[torch.Tensor] = None, want_rays: bool = True,
                   return_mu: bool = False):
    """Plain version of K3.  Same contract as :func:`fine_bwd`."""
    grads = (g_len, g_act, g_dsd, g_w)
    _check_bwd(rays, table, idx, length, act, dsd, w, grads, attrs, g_img)
    out = _plain(rays, table, idx, length, act, dsd, w, grads, agg_ow, attrs, g_img,
                 True, want_rays, return_mu)
    return out if return_mu else out[:2]


def fine_bwd_global_plain(rays, table, idx, length, act, dsd, w, g_len, g_act,
                          g_dsd, g_w, agg_ow: float, want_rays: bool = True):
    """Plain version of K3's global entry: :func:`fine_bwd_plain` without
    attributes.  Same contract as :func:`fine_bwd_global`."""
    return fine_bwd_plain(rays, table, idx, length, act, dsd, w, g_len, g_act,
                          g_dsd, g_w, agg_ow, None, None, want_rays)


def _kernels():
    return (bind("fine_bwd", "voge_fine_bwd_slots",
                 [VOIDP] * 16 + [LONG, LONG, INT, INT, FLOAT, VOIDP]),
            bind("fine_bwd", "voge_fine_bwd_runs", [VOIDP] * 8 + [LONG, INT, INT, INT, VOIDP]))


def _slots_stage(rays, table, idx, length, act, dsd, w, grads, agg_ow, attrs, g_img,
                 want_coef: bool, want_rays: bool, want_mu: bool = False):
    """K3's per-slot kernel on CUDA tensors: (coef (..., K, 4) or None,
    g_rays or None, g_mu or None)."""
    K, d = idx.shape[-1], 0 if attrs is None else attrs.shape[1]
    empty = lambda shape, want: (torch.empty(shape, dtype=torch.float32, device=rays.device)
                                 if want else None)
    coef = empty(idx.shape + (4,), want_coef)
    g_rays, g_mu = empty(rays.shape, want_rays), empty(rays.shape, want_mu)
    err = _kernels()[0](
        ptr(rays), ptr(table), ptr(idx), ptr(length), ptr(act), ptr(dsd), ptr(w),
        *(ptr(g) for g in grads), ptr(attrs), ptr(g_img), ptr(coef), ptr(g_rays), ptr(g_mu),
        idx.numel() // K, table.shape[0], K, d, float(agg_ow), stream(rays.device))
    raise_on_error(err, "fine_bwd (per-slot kernel)")
    return coef, g_rays, g_mu


def _runs_stage(rays, table, coef, w, g_img, order, starts, group: Optional[int] = None):
    """K3's per-Gaussian kernel on CUDA tensors: rows (B * P, 12 + d), with
    ``group`` lanes a Gaussian (None: :func:`group_width`)."""
    K, d = coef.shape[-2], 0 if g_img is None else g_img.shape[-1]
    n_tab = table.shape[0]
    if group is None:
        group = group_width(coef.numel() // 4, n_tab)
    rows = torch.empty((n_tab, 12 + d), dtype=torch.float32, device=rays.device)
    err = _kernels()[1](
        ptr(table), ptr(rays), ptr(coef), ptr(w), ptr(g_img), ptr(order), ptr(starts),
        ptr(rows), n_tab, K, d, int(group), stream(rays.device))
    raise_on_error(err, "fine_bwd (per-Gaussian kernel)")
    return rows


def _launch(rays, table, idx, length, act, dsd, w, grads, agg_ow, attrs, g_img, want_rays,
            want_mu=False):
    """K3 on CUDA tensors: the per-slot kernel, the grouping of each
    Gaussian's slots into a run in slot order (:func:`slot_runs`), the
    per-Gaussian kernel.  (rows, g_rays or None, g_mu or None)."""
    n_tab, _, _ = _check_bwd(rays, table, idx, length, act, dsd, w, grads, attrs, g_img)
    coef, g_rays, g_mu = _slots_stage(rays, table, idx, length, act, dsd, w, grads, agg_ow,
                                      attrs, g_img, True, want_rays, want_mu)
    order, starts = slot_runs(idx, n_tab)
    return _runs_stage(rays, table, coef, w, g_img, order, starts), g_rays, g_mu


def fine_bwd(rays, table, idx, length, act, dsd, w, g_len, g_act, g_dsd, g_w,
             agg_ow: float, attrs: Optional[torch.Tensor] = None,
             g_img: Optional[torch.Tensor] = None, want_rays: bool = True,
             return_mu: bool = False):
    """Backward of the select (K2) over the emission-compacted rows, with the
    fused attribute image's VJP.

    :param rays: (B, H, W, 3); :param table: (B * P, 16) feature rows,
        indexed by the slots' ids (``ops.fine.feature_table``)
    :param idx, length, act, dsd, w: (B, H, W, K) the select's outputs
        (``act`` and ``w`` may be None when there is nothing to fold: no
        ``g_w`` and no attributes)
    :param g_len, g_act, g_dsd, g_w: (B, H, W, K) cotangents, None for zero
    :param agg_ow: occupation weight of the fused erf compositing
    :param attrs, g_img: (B * P, d) attributes indexed by id and the
        (B, H, W, d) cotangent of the fused attribute image, or both None
    :param want_rays: compute the ray gradient (else skip that reduction)
    :param return_mu: also return each ray's slots' mean gradients summed in
        slot order (minus their sum over an image is its camera centre's
        gradient)
    :return: (rows (B * P, 12 + d) float32 per Gaussian: grad mu (3), grad
        Lambda (9, row-major), grad attrs (d), summed over the slots that hold
        it; g_rays (B, H, W, 3) float32 or None), and with ``return_mu`` g_mu
        (B, H, W, 3) float32 third
    """
    grads = (g_len, g_act, g_dsd, g_w)
    if not on_cuda(rays, table, idx, length, act, dsd, w, *grads, attrs, g_img):
        return fine_bwd_plain(rays, table, idx, length, act, dsd, w, *grads, agg_ow,
                              attrs, g_img, want_rays, return_mu)
    out = _launch(rays, table, idx, length, act, dsd, w, grads, agg_ow, attrs, g_img,
                  want_rays, return_mu)
    trace.count("launch.fine_bwd")
    return out if return_mu else out[:2]


def fine_bwd_global(rays, table, idx, length, act, dsd, w, g_len, g_act,
                    g_dsd, g_w, agg_ow: float, want_rays: bool = True):
    """Backward of the select's global entries (``fine_select_global``,
    ``fine_select_bins``): :func:`fine_bwd` without attributes.

    :return: (rows (B * P, 12) float32 per Gaussian: grad mu (3), grad
        Lambda (9, row-major); g_rays (B, H, W, 3) float32 or None)
    """
    grads = (g_len, g_act, g_dsd, g_w)
    if not on_cuda(rays, table, idx, length, act, dsd, w, *grads):
        return fine_bwd_global_plain(rays, table, idx, length, act, dsd, w, *grads,
                                     agg_ow, want_rays)
    out = _launch(rays, table, idx, length, act, dsd, w, grads, agg_ow, None, None,
                  want_rays)
    trace.count("launch.fine_bwd_global")
    return out[:2]


def fine_bwd_gauss_plain(rays, table, idx, length, dsd, g_len, g_act, g_dsd):
    """Plain version of the per-Gaussian half.  Same contract as
    :func:`fine_bwd_gauss`."""
    grads = (g_len, g_act, g_dsd, None)
    _check_split(rays, table, idx, length, dsd, grads[:3])
    return _plain(rays, table, idx, length, None, dsd, None, grads, 1.0, None, None,
                  True, False, False)[0]


def fine_bwd_gauss(rays, table, idx, length, dsd, g_len, g_act, g_dsd):
    """The per-Gaussian half of the select's global backward: K3's per-slot
    kernel with the fold and the ray gradient off (it packs each slot's
    coefficients), the grouping of the slot ids, K3's per-Gaussian kernel.

    :param rays: (B, H, W, 3); :param table: (B * P, 16) feature rows,
        indexed by the slots' ids
    :param idx, length, dsd: (B, H, W, K) the select's outputs
    :param g_len, g_act, g_dsd: (B, H, W, K) cotangents, the weight cotangent
        already folded in (:func:`fold_weights`); None for zero
    :return: rows (B * P, 12) float32 per Gaussian: grad mu (3), grad Lambda
        (9, row-major), summed over the slots that hold it in slot order
    """
    grads = (g_len, g_act, g_dsd)
    if not on_cuda(rays, table, idx, length, dsd, *grads):
        return fine_bwd_gauss_plain(rays, table, idx, length, dsd, *grads)
    n_tab, K = _check_split(rays, table, idx, length, dsd, grads)
    _check_k(K, "fine_bwd_gauss")
    coef, _, _ = _slots_stage(rays, table, idx, length, None, dsd, None, (*grads, None),
                              1.0, None, None, True, False)
    order, starts = slot_runs(idx, n_tab)
    rows = _runs_stage(rays, table, coef, None, None, order, starts)
    trace.count("launch.fine_bwd_gauss")
    return rows


def fine_bwd_rays_plain(rays, table, idx, length, dsd, g_len, g_act, g_dsd, *,
                        act=None, w=None, g_w=None, agg_ow: float = 1.0, attrs=None,
                        g_img=None, return_mu: bool = False):
    """Plain version of the per-ray half, at any K.  Same contract as
    :func:`fine_bwd_rays`."""
    grads = (g_len, g_act, g_dsd, g_w)
    _check_fold(rays, table, idx, length, act, dsd, w, grads, attrs, g_img)
    _, g_rays, g_mu = _plain(rays, table, idx, length, act, dsd, w, grads, agg_ow, attrs,
                             g_img, False, True, return_mu)
    return (g_rays, g_mu) if return_mu else g_rays


def fine_bwd_rays(rays, table, idx, length, dsd, g_len, g_act, g_dsd, *,
                  act=None, w=None, g_w=None, agg_ow: float = 1.0, attrs=None,
                  g_img=None, return_mu: bool = False):
    """The per-ray half of the select's backward: one launch of K3's
    per-slot kernel, which writes no coefficients.

    :param rays, table, idx, length, dsd, g_len, g_act, g_dsd: as for
        :func:`fine_bwd_gauss`
    :param act, w, g_w, agg_ow, attrs, g_img: as for :func:`fine_bwd`; given
        a weight cotangent ``g_w`` or attributes, the launch folds them into
        the cotangents first (the backward of a frozen scene, in one launch)
    :param return_mu: also return each ray's slots' mean gradients summed in
        slot order
    :return: g_rays (B, H, W, 3) float32: each ray's gradient, summed over
        its K slots in slot order; with ``return_mu``, (g_rays, g_mu)
    """
    grads = (g_len, g_act, g_dsd, g_w)
    if not on_cuda(rays, table, idx, length, act, dsd, w, *grads, attrs, g_img):
        return fine_bwd_rays_plain(rays, table, idx, length, dsd, g_len, g_act, g_dsd,
                                   act=act, w=w, g_w=g_w, agg_ow=agg_ow, attrs=attrs,
                                   g_img=g_img, return_mu=return_mu)
    _, K, _ = _check_fold(rays, table, idx, length, act, dsd, w, grads, attrs, g_img)
    _check_k(K, "fine_bwd_rays")
    _, g_rays, g_mu = _slots_stage(rays, table, idx, length, act, dsd, w, grads, agg_ow,
                                   attrs, g_img, False, True, return_mu)
    trace.count("launch.fine_bwd_rays")
    return (g_rays, g_mu) if return_mu else g_rays
