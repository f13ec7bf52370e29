"""K3: the fine backward (``csrc/fine_bwd.cu``), the weight-cotangent fold
(``csrc/fold_weights.cu``, the device function of ``csrc/fine_bwd.cuh``) and
the global backward split in two (``csrc/fine_bwd_split.cu``), with their
plain PyTorch versions.

K3 has two entries on one kernel pair.  :func:`fine_bwd` replaces
``voge_tpu/ops/pallas_bwd.py::_bwd_t_kernel`` (``fine_bwd_compact_t_pallas``,
the emission-compacted path, with the attribute VJP); :func:`fine_bwd_global`
replaces ``pallas_bwd.py::_bwd_unified_kernel`` (``fine_bwd_unified_pallas``,
the global candidate space of the no-coarse path and the two-stage tracer).
From the select's saved image-layout outputs (idx, len, act, dsd, w) and
their cotangents, one thread per slot folds the weight cotangent (and, with
attributes, the attribute image's weight cotangent) into the len / act / dsd
cotangents and applies the entry-space chain rule; per ray it sums the ray
gradient (3); per Gaussian, over each Gaussian's run of a stable sort of the
slot ids, one warp sums the gradients of mu (3), Lambda (9) and the
attributes (d) in a fixed order.  A slot's id ``b * P + p`` is its row of the
(B * P, 16) feature table and of the output, so both entries return
per-Gaussian rows: no float atomics, two runs give the same bits.

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

:func:`fine_bwd_gauss` and :func:`fine_bwd_rays` replace
``pallas_bwd.py::_bwd_gauss_kernel`` (``fine_bwd_gauss_pallas``) and
``_bwd_rays_kernel`` (``fine_bwd_rays_pallas``): the global backward as a
per-Gaussian half and a per-ray half that take cotangents of len / act / dsd
with the weight cotangent already folded in (by :func:`fold_weights`), so
they take no ``w``, no ``g_w`` and no occupation weight.  ``ops.fine`` says
when a backward takes the pair and when the per-ray half alone.
"""
from __future__ import annotations

from typing import Optional

import torch

from voge_tpu_torch._build import load
from voge_tpu_torch.ops._dispatch import (
    FLOAT, INT, LONG, VOIDP, check, on_cuda, ptr, raise_on_error, stream,
)
from voge_tpu_torch.ops.cuda_attr import _slot_runs
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
    fn = load("fold_weights").voge_fold_weights
    fn.argtypes = [VOIDP] * 8 + [LONG, INT, FLOAT, VOIDP]
    fn.restype = INT
    return fn


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
    fold_weights.launches += 1
    return dl, da, dd


fold_weights.launches = 0


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


def _check_bwd(rays, table, idx, length, act, dsd, w, grads, attrs, g_img):
    """K3's arguments (:func:`fine_bwd`); (rows of the table, K, d)."""
    n_tab, K = _check_split(rays, table, idx, length, dsd, grads[:3])
    if K > MAX_K:
        raise NotImplementedError(f"K={K}: the backward kernel takes 1 <= K <= {MAX_K}")
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


def fine_bwd_plain(rays, table, idx, length, act, dsd, w, g_len, g_act, g_dsd,
                   g_w, agg_ow: float, attrs: Optional[torch.Tensor] = None,
                   g_img: Optional[torch.Tensor] = None, want_rays: bool = True):
    """Plain version of K3: dense tensor ops per slot, each slot's feature
    row read by its id, and a segmented sum (``index_add_``) per Gaussian
    (``voge_tpu``'s entry-space backward, ``fine.py:259-329``, in the
    residual form).  Same contract as :func:`fine_bwd`."""
    grads = (g_len, g_act, g_dsd, g_w)
    n_tab, K, d = _check_bwd(rays, table, idx, length, act, dsd, w, grads, attrs, g_img)
    coefs = _slot_coefs(idx, length, act, dsd, w, *grads, agg_ow, attrs, g_img)
    ok = (idx >= 0) & (idx < n_tab)
    seg = torch.where(ok, idx, n_tab).long()                     # (B, H, W, K)
    feats = torch.cat([table, table.new_zeros((1, FEAT))])[seg]
    g_mu, g_L, g_ray = _slot_grads(feats, rays[..., None, :],
                                   *(c[..., None] for c in coefs), want_rays)
    cols = [g_mu, g_L]
    if d:
        cols.append(w[..., None] * g_img[..., None, :])
    vals = torch.cat(cols, dim=-1).reshape(-1, 12 + d)
    rows = vals.new_zeros((n_tab + 1, 12 + d)).index_add_(0, seg.reshape(-1), vals)
    g_rays = None
    if want_rays:
        g_rays = torch.where(ok[..., None], g_ray, 0.0).sum(-2)
    return rows[:n_tab], g_rays


def fine_bwd_global_plain(rays, table, idx, length, act, dsd, w, g_len, g_act,
                          g_dsd, g_w, agg_ow: float, want_rays: bool = True):
    """Plain version of K3's global entry: :func:`fine_bwd_plain` without
    attributes.  Same contract as :func:`fine_bwd_global`."""
    return fine_bwd_plain(rays, table, idx, length, act, dsd, w, g_len, g_act,
                          g_dsd, g_w, agg_ow, None, None, want_rays)


def _kernels():
    lib = load("fine_bwd")
    slots, runs = lib.voge_fine_bwd_slots, lib.voge_fine_bwd_runs
    slots.argtypes = [VOIDP] * 15 + [LONG, LONG, INT, INT, FLOAT, VOIDP]
    runs.argtypes = [VOIDP] * 8 + [LONG, INT, INT, VOIDP]
    slots.restype = runs.restype = INT
    return slots, runs


def _slots_stage(rays, table, idx, length, act, dsd, w, grads, agg_ow, attrs, g_img,
                 want_rays):
    """K3's per-slot kernel on CUDA tensors: (coef (..., K, 4), g_rays or None)."""
    K, d = idx.shape[-1], 0 if attrs is None else attrs.shape[1]
    coef = torch.empty(idx.shape + (4,), dtype=torch.float32, device=rays.device)
    g_rays = torch.empty_like(rays) if want_rays else None
    err = _kernels()[0](
        ptr(rays), ptr(table), ptr(idx), ptr(length), ptr(act), ptr(dsd), ptr(w),
        *(ptr(g) for g in grads), ptr(attrs), ptr(g_img), ptr(coef), ptr(g_rays),
        idx.numel() // K, table.shape[0], K, d, float(agg_ow), stream(rays.device))
    raise_on_error(err, "fine_bwd (per-slot kernel)")
    return coef, g_rays


def _runs_stage(rays, table, coef, w, g_img, order, starts):
    """K3's per-Gaussian kernel on CUDA tensors: rows (B * P, 12 + d)."""
    K, d = coef.shape[-2], 0 if g_img is None else g_img.shape[-1]
    rows = torch.empty((table.shape[0], 12 + d), dtype=torch.float32, device=rays.device)
    err = _kernels()[1](
        ptr(table), ptr(rays), ptr(coef), ptr(w), ptr(g_img), ptr(order), ptr(starts),
        ptr(rows), table.shape[0], K, d, stream(rays.device))
    raise_on_error(err, "fine_bwd (per-Gaussian kernel)")
    return rows


def _launch(rays, table, idx, length, act, dsd, w, grads, agg_ow, attrs, g_img, want_rays):
    """K3 on CUDA tensors: the per-slot kernel, the stable sort of the slot
    ids that groups each Gaussian's slots into a run in slot order (glue),
    the per-Gaussian kernel."""
    n_tab, _, _ = _check_bwd(rays, table, idx, length, act, dsd, w, grads, attrs, g_img)
    coef, g_rays = _slots_stage(rays, table, idx, length, act, dsd, w, grads, agg_ow,
                                attrs, g_img, want_rays)
    order, starts = _slot_runs(idx, n_tab)
    return _runs_stage(rays, table, coef, w, g_img, order, starts), g_rays


def fine_bwd(rays, table, idx, length, act, dsd, w, g_len, g_act, g_dsd, g_w,
             agg_ow: float, attrs: Optional[torch.Tensor] = None,
             g_img: Optional[torch.Tensor] = None, want_rays: bool = True):
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
    :return: (rows (B * P, 12 + d) float32 per Gaussian: grad mu (3), grad
        Lambda (9, row-major), grad attrs (d), summed over the slots that hold
        it; g_rays (B, H, W, 3) float32 or None)
    """
    grads = (g_len, g_act, g_dsd, g_w)
    if not on_cuda(rays, table, idx, length, act, dsd, w, *grads, attrs, g_img):
        return fine_bwd_plain(rays, table, idx, length, act, dsd, w, *grads, agg_ow,
                              attrs, g_img, want_rays)
    out = _launch(rays, table, idx, length, act, dsd, w, grads, agg_ow, attrs, g_img,
                  want_rays)
    fine_bwd.launches += 1
    return out


fine_bwd.launches = 0


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
    fine_bwd_global.launches += 1
    return out


fine_bwd_global.launches = 0


def _split_slots(table, idx, length, dsd, g_len, g_act, g_dsd):
    """What the plain halves share: each slot's feature row (..., K, 16), its
    coefficients (g_d, c = g_len / dsd, g_a, l), each (..., K, 1) and zero
    where the slot holds no row of the table, and its segment id (the dump
    row ``n_tab`` for such slots)."""
    n_tab = table.shape[0]
    zero = lambda g: torch.zeros_like(length) if g is None else g
    ok = (idx >= 0) & (idx < n_tab)
    vf = ok.to(length.dtype)
    coefs = (zero(g_dsd) * vf, zero(g_len) / torch.where(ok, dsd, 1.0) * vf,
             zero(g_act) * vf, torch.where(ok, length, 0.0))
    seg = torch.where(ok, idx, n_tab).long()
    feats = torch.cat([table, table.new_zeros((1, FEAT))])[seg]
    return feats, tuple(c[..., None] for c in coefs), seg


def fine_bwd_gauss_plain(rays, table, idx, length, dsd, g_len, g_act, g_dsd):
    """Plain version of the per-Gaussian half: dense tensor ops per slot and
    a segmented sum (``index_add_``).  Same contract as :func:`fine_bwd_gauss`."""
    n_tab, _ = _check_split(rays, table, idx, length, dsd, (g_len, g_act, g_dsd))
    feats, coefs, seg = _split_slots(table, idx, length, dsd, g_len, g_act, g_dsd)
    g_mu, g_L, _ = _slot_grads(feats, rays[..., None, :], *coefs, False)
    vals = torch.cat([g_mu, g_L], dim=-1).reshape(-1, 12)
    return vals.new_zeros((n_tab + 1, 12)).index_add_(0, seg.reshape(-1), vals)[:n_tab]


def fine_bwd_rays_plain(rays, table, idx, length, dsd, g_len, g_act, g_dsd):
    """Plain version of the per-ray half: dense tensor ops per slot, summed
    over each ray's slots.  Same contract as :func:`fine_bwd_rays`."""
    _check_split(rays, table, idx, length, dsd, (g_len, g_act, g_dsd))
    feats, coefs, _ = _split_slots(table, idx, length, dsd, g_len, g_act, g_dsd)
    return _slot_grads(feats, rays[..., None, :], *coefs, True)[2].sum(-2)


def _kernel_gauss():
    fn = load("fine_bwd_split").voge_fine_bwd_gauss
    fn.argtypes = [VOIDP] * 10 + [LONG, INT, VOIDP]
    fn.restype = INT
    return fn


def fine_bwd_gauss(rays, table, idx, length, dsd, g_len, g_act, g_dsd):
    """The per-Gaussian half of the select's global backward.

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
    # one stable sort groups each Gaussian's slots into a run in slot order
    order, starts = _slot_runs(idx, n_tab)
    rows = torch.empty((n_tab, 12), dtype=torch.float32, device=rays.device)
    err = _kernel_gauss()(
        ptr(rays), ptr(table), ptr(length), ptr(dsd), *(ptr(g) for g in grads),
        ptr(order), ptr(starts), ptr(rows), n_tab, K, stream(rays.device))
    raise_on_error(err, "fine_bwd_gauss")
    fine_bwd_gauss.launches += 1
    return rows


fine_bwd_gauss.launches = 0


def _kernel_rays():
    fn = load("fine_bwd_split").voge_fine_bwd_rays
    fn.argtypes = [VOIDP] * 9 + [LONG, LONG, INT, VOIDP]
    fn.restype = INT
    return fn


def fine_bwd_rays(rays, table, idx, length, dsd, g_len, g_act, g_dsd):
    """The per-ray half of the select's global backward.

    :param rays, table, idx, length, dsd, g_len, g_act, g_dsd: as for
        :func:`fine_bwd_gauss`
    :return: g_rays (B, H, W, 3) float32: each ray's gradient, summed over
        its K slots in slot order
    """
    grads = (g_len, g_act, g_dsd)
    if not on_cuda(rays, table, idx, length, dsd, *grads):
        return fine_bwd_rays_plain(rays, table, idx, length, dsd, *grads)
    n_tab, K = _check_split(rays, table, idx, length, dsd, grads)
    g_rays = torch.empty_like(rays)
    err = _kernel_rays()(
        ptr(rays), ptr(table), ptr(idx), ptr(length), ptr(dsd),
        *(ptr(g) for g in grads), ptr(g_rays), idx.numel() // K, n_tab, K,
        stream(rays.device))
    raise_on_error(err, "fine_bwd_rays")
    fine_bwd_rays.launches += 1
    return g_rays


fine_bwd_rays.launches = 0
