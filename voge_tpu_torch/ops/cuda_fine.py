"""K2: streaming top-K select with fused erf weights and fused attribute
image (``csrc/fine_select.cu``), and its plain PyTorch version.

Replaces ``voge_tpu/ops/pallas_fine2.py::_kernel_tc`` (compacted entry,
``fine_select_compact_pallas``).  For every pixel it keeps the K nearest
candidates of its supertile row that pass ``act < thr_act`` and whose
sub-bin bit is set, by ascending hit length with earlier candidates winning
ties, then composites their erf weights and, given attributes, the attribute
image.  Outputs are in image layout.

Bound on the H100: latency, not throughput: each thread walks its
supertile's candidate rows in order, and the densest supertile sets the time
(see the source note).  Design: one thread per ray, 128 rays per block,
candidate rows staged through shared memory, the running top-K in registers
(K bucket template, unrolled stable insertion), compiled with
``-fmad=false`` so that len / act / dsd equal :func:`fine_select_plain`'s
bit for bit.

The forward runs inside :class:`FineSelect`, an autograd function whose
backward raises: the backward kernel (``pallas_bwd._bwd_t_kernel``) is ported
in the next slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from voge_tpu_torch._build import load
from voge_tpu_torch.ops._dispatch import (
    FLOAT, INT, LONG, VOIDP, check, on_cuda, ptr, raise_on_error, stream,
)
from voge_tpu_torch.ops.coarse import supertile_grid
from voge_tpu_torch.ops.cuda_attr import attr_merge_plain

FEAT = 16          # feature row: A(3), msm, Lambda(9), mu(3)
MAX_K = 128        # largest K bucket the kernel is built for
_INF = 1e10
_E_HALF = 1.6487212707001282
# dense (rows x candidates) elements the plain version evaluates at once
_PLAIN_CHUNK = 1 << 24


def _supertile_rays(rays, bin_size: int):
    """(B, H, W, 3) -> (nb, st*st, 3): supertile-local rays, row-major in
    the supertile, zero outside the image."""
    B, H, W, _ = rays.shape
    st = 2 * bin_size
    BH2, BW2 = supertile_grid(H, W, bin_size)
    pad = rays.new_zeros((B, BH2 * st, BW2 * st, 3))
    pad[:, :H, :W] = rays
    x = pad.reshape(B, BH2, st, BW2, st, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * BH2 * BW2, st * st, 3)


def _to_image(x, B: int, H: int, W: int, bin_size: int):
    """(nb, st*st, C) supertile layout -> (B, H, W, C)."""
    st = 2 * bin_size
    BH2, BW2 = supertile_grid(H, W, bin_size)
    C = x.shape[-1]
    x = x.reshape(B, BH2, BW2, st, st, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, BH2 * st, BW2 * st, C)[:, :H, :W]


def _check_args(rays, table_c, bits_c, ids_c, counts_c, K, bin_size, attrs):
    B, H, W, _ = rays.shape
    BH2, BW2 = supertile_grid(H, W, bin_size)
    nb, M = B * BH2 * BW2, table_c.shape[1]
    if not 0 < K <= MAX_K:
        raise NotImplementedError(
            f"K={K}: the select kernel takes 1 <= K <= {MAX_K}; larger K "
            "waits for the dense path (ROADMAP queue 1, item 8)")
    check(rays, "rays", torch.float32, (B, H, W, 3))
    check(table_c, "table_c", torch.float32, (nb, M, FEAT))
    check(bits_c, "bits_c", torch.int32, (nb, M))
    check(ids_c, "ids_c", torch.int32, (nb, M))
    check(counts_c, "counts_c", torch.int32, (nb,))
    if attrs is not None:
        check(attrs, "attrs", torch.float32)
        if attrs.ndim != 2:
            raise ValueError(f"attrs: expected (rows, d), got {tuple(attrs.shape)}")
    return B, H, W, BH2, BW2, nb, M


def fine_select_plain(rays, table_c, bits_c, ids_c, counts_c, thr_act: float,
                      K: int, bin_size: int, agg_ow: float,
                      attrs: Optional[torch.Tensor] = None):
    """Plain version of K2: a dense (supertile, ray, candidate) evaluation,
    a stable sort along the candidates and the K-step weight loop, in the
    kernel's operation order.  Same contract as :func:`fine_select`."""
    B, H, W, BH2, BW2, nb, M = _check_args(
        rays, table_c, bits_c, ids_c, counts_c, K, bin_size, attrs)
    dev = rays.device
    st = 2 * bin_size
    R = st * st
    r_all = _supertile_rays(rays, bin_size)                    # (nb, R, 3)
    lr = torch.arange(R, device=dev) // st
    lc = torch.arange(R, device=dev) % st
    g = (2 * (lr // bin_size) + lc // bin_size)[None, :, None]  # sub-bin
    slots = torch.arange(M, device=dev)
    kk = min(K, M)
    outs = []
    step = max(1, _PLAIN_CHUNK // max(R * M, 1))
    for s0 in range(0, nb, step):
        s1 = min(nb, s0 + step)
        f = table_c[s0:s1, None, :, :]                          # (n, 1, M, 16)
        r = [r_all[s0:s1, :, i, None] for i in range(3)]        # (n, R, 1)
        rr = [r[i] * r[j] for i in range(3) for j in range(3)]
        msk = f[..., 0] * r[0]
        msk = msk + f[..., 1] * r[1]
        msk = msk + f[..., 2] * r[2]
        ksk = f[..., 4] * rr[0]
        for q in range(1, 9):
            ksk = ksk + f[..., 4 + q] * rr[q]
        length = msk / ksk
        d = [f[..., 13 + i] - length * r[i] for i in range(3)]
        e = [(d[0] * f[..., 4 + j] + d[1] * f[..., 7 + j]) + d[2] * f[..., 10 + j]
             for j in range(3)]
        act = (e[0] * d[0] + e[1] * d[1]) + e[2] * d[2]
        member = (bits_c[s0:s1, None, :].to(torch.int64) >> g) & 1
        live = slots[None, None, :] < counts_c[s0:s1, None, None]
        ok = (act < thr_act) & (member > 0) & live
        lm = torch.where(ok, length, _INF)
        vals, order = torch.sort(lm, dim=-1, stable=True)
        vals, order = vals[..., :kk], order[..., :kk]
        sel = vals < _INF
        ids = ids_c[s0:s1, None, :].expand(-1, R, -1)
        outs.append((
            torch.where(sel, ids.gather(-1, order), -1),
            torch.where(sel, vals, _INF),
            torch.where(sel, act.gather(-1, order), _INF),
            torch.where(sel, ksk.gather(-1, order), 0.0),
        ))
    idx, sl, sa, sd = (torch.cat(x, dim=0) for x in zip(*outs))
    if kk < K:
        pad = lambda x, v: torch.nn.functional.pad(x, (0, K - kk), value=v)
        idx, sl, sa, sd = pad(idx, -1), pad(sl, _INF), pad(sa, _INF), pad(sd, 0.0)

    # fused erf weights (pallas_fine2.py:386-406), k ascending
    ea = torch.exp(-sa)
    sq = torch.sqrt(sd + 1e-10)
    occ = torch.zeros_like(sl)
    for k in range(K):
        ca = (sl - sl[..., k:k + 1]) * sq[..., k:k + 1]
        occ = occ + ea[..., k:k + 1] * (0.5 * (torch.erf(ca) + 1.0))
    w = torch.exp(-agg_ow * occ) * ea * _E_HALF

    to_img = lambda x: _to_image(x, B, H, W, bin_size).contiguous()
    idx, w = to_img(idx.to(torch.int32)), to_img(w)
    img = None if attrs is None else attr_merge_plain(idx, w, attrs)
    return idx, to_img(sl), to_img(sa), to_img(sd), w, img


def _kernel():
    fn = load("fine_select").voge_fine_select
    fn.argtypes = [VOIDP] * 12 + [INT] * 9 + [LONG, FLOAT, FLOAT, VOIDP]
    fn.restype = INT
    return fn


def fine_select(rays, table_c, bits_c, ids_c, counts_c, thr_act: float,
                K: int, bin_size: int, agg_ow: float,
                attrs: Optional[torch.Tensor] = None):
    """Select the K nearest passing candidates of every pixel.

    :param rays: (B, H, W, 3) float32 unit world directions
    :param table_c: (nb, M, 16) float32 candidate feature rows of each
        supertile (``ops.fine._gauss_feature_planes_batched`` gathered by
        ``pos_c``), nb = B * BH2 * BW2
    :param bits_c, ids_c: (nb, M) int32 sub-bin bits / flattened ids
    :param counts_c: (nb,) int32 occupied rows
    :param attrs: optional (rows, d) float32 attributes indexed by id
    :return: (idx (B,H,W,K) int32, len, act, dsd, w (B,H,W,K) float32,
        img (B,H,W,d) float32 or None); empty slots hold idx -1,
        len / act 1e10, dsd 0, w 0
    """
    if not on_cuda(rays, table_c, bits_c, ids_c, counts_c, attrs):
        return fine_select_plain(rays, table_c, bits_c, ids_c, counts_c,
                                 thr_act, K, bin_size, agg_ow, attrs)
    B, H, W, BH2, BW2, nb, M = _check_args(
        rays, table_c, bits_c, ids_c, counts_c, K, bin_size, attrs)
    dev = rays.device
    f32 = dict(dtype=torch.float32, device=dev)
    idx = torch.empty((B, H, W, K), dtype=torch.int32, device=dev)
    sl, sa, sd, w = (torch.empty((B, H, W, K), **f32) for _ in range(4))
    d = 0 if attrs is None else attrs.shape[1]
    img = None if attrs is None else torch.empty((B, H, W, d), **f32)
    n_rows = 0 if attrs is None else attrs.shape[0]
    err = _kernel()(
        ptr(rays), ptr(table_c), ptr(bits_c), ptr(ids_c), ptr(counts_c),
        ptr(attrs), ptr(idx), ptr(sl), ptr(sa), ptr(sd), ptr(w), ptr(img),
        nb, H, W, bin_size, BW2, BH2 * BW2, M, K, d, n_rows, thr_act, agg_ow,
        stream(dev),
    )
    raise_on_error(err, "fine_select")
    fine_select.launches += 1
    return idx, sl, sa, sd, w, img


fine_select.launches = 0


class FineSelect(torch.autograd.Function):
    """:func:`fine_select` as an autograd node: differentiable inputs are
    ``table_c``, ``rays`` and ``attrs``; the backward is not ported yet."""

    @staticmethod
    def forward(ctx, table_c, rays, attrs, bits_c, ids_c, counts_c, thr_act,
                K, bin_size, agg_ow):
        out = fine_select(rays, table_c, bits_c, ids_c, counts_c, thr_act, K,
                          bin_size, agg_ow, attrs)
        ctx.mark_non_differentiable(out[0])
        return out if attrs is not None else out[:5]

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "voge_tpu_torch renders forward only: the backward of the select "
            "kernel (voge_tpu/ops/pallas_bwd.py::_bwd_t_kernel) is ported in "
            "the next slice (ROADMAP queue 1, slice 2)")
