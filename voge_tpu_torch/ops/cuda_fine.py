"""K2: streaming top-K select with fused erf weights and fused attribute
image (``csrc/fine_select.cu``), and its plain PyTorch version.

Replaces ``voge_tpu/ops/pallas_fine2.py::_kernel_tc`` through both of its
entries: :func:`fine_select` is the compacted entry
(``fine_select_compact_pallas``), :func:`fine_select_global` the global one
(``fine_select_mask_pallas``, the no-coarse path); and, through a third entry
of the same kernel, ``voge_tpu/ops/pallas_fine.py::_kernel``
(``fine_select_pallas``): :func:`fine_select_bins` selects over per-bin
candidate lists for the public two-stage tracer, without weights or image
(``ops.fine.ray_tracing_fine``).  For every pixel it keeps
the K nearest candidates of its supertile that pass ``act < thr_act`` and
whose sub-bin bit is set, by ascending hit length with earlier candidates
winning ties, then composites their erf weights and, given attributes, the
attribute image.  The candidates of a supertile are its emission-compacted
rows (compacted entry) or every Gaussian of its image in ascending index
(global entry).  Outputs are in image layout.

Bound on the H100: latency, not throughput (the work is small against the
card's rates; a thread walks its candidates in order and each pair costs a
division and four shared-memory reads).  Design (see the source note): one
thread per ray, 128 rays per block; the running top-K in shared memory as
(len, position), slot-major, at any K up to 128 (one code path, no K
buckets), with act / dsd of the kept candidates computed again at the flush;
candidates examined 512 at a time and only those that can matter to the
block packed into shared memory in ascending position (sub-bin bits, list
ids, and on the global entry a cone cull proven conservative:
:func:`cull_rows`, :func:`block_cones`, :func:`cull_mask_plain`, the first
two small kernels of their own on the card; at larger shapes two levels,
super-tiles of 2 x 2 blocks first, :func:`two_level`, :func:`cull_lists`);
rows copied by ``cp.async`` while the next candidates are examined;
accepted candidates entering the list on a warp vote; blocks of 8 x 16
pixels on the global entry without a bits plane.  Compiled with
``-fmad=false`` so that len / act / dsd equal :func:`fine_select_plain`'s
bit for bit.

The forward runs inside ``ops.fine.FineSelect`` / ``FineSelectGlobal``,
whose backward is K3 (``ops/cuda_fine_bwd.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from voge_tpu_torch import trace
from voge_tpu_torch.ops._dispatch import (
    FLOAT, INT, LONG, VOIDP, bind, check, on_cuda, ptr, raise_on_error, stream,
)
from voge_tpu_torch.ops.coarse import supertile_grid
from voge_tpu_torch.ops.cuda_attr import attr_merge_plain

FEAT = 16          # feature row: A(3), msm, Lambda(9), mu(3)
MAX_K = 128        # largest K the kernel takes (K KB of shared memory a block)
_INF = 1e10
_E_HALF = 1.6487212707001282
# dense (rows x candidates) elements the plain version evaluates at once
_PLAIN_CHUNK = 1 << 24
_BLOCK_RAYS = 128          # rays a block of the kernel holds
_GLOBAL_TILE = (8, 16)     # the global entry's ray tile without a bits plane
_WARP_TILE = (4, 8)        # a warp's rays in it on the two-level route
# The cone cull's slack (proof in the source note of csrc/fine_select.cu):
# off the sine of the angle between a Gaussian's line and the cone's edge,
# on the threshold, on the cone's half-angle, and off the eigenvalue bound
# in units of ||Lambda||_F.
_CULL_EPS, _CULL_MARGIN, _CONE_SLACK, _EIG_SLACK = 1e-4, 1e-3, 1e-6, 4e-6
_EIG_NEWTON_STEPS = 6
# The two-level cull: super-tiles of _SUPER x _SUPER blocks, their cones
# widened by _SUPER_SLACK past their warps' (proof in the source note), and
# the least (blocks of an image) x P at which level 1 pays.
_SUPER, _SUPER_SLACK = 2, 1e-5
_TWO_LEVEL_MIN_PAIRS = 1 << 22


def _tiles(x, th: int, tw: int, fill=0):
    """(B, H, W, C) image layout -> (n_tiles, th*tw, C): tiles of ``th`` x
    ``tw`` pixels in row-major order, rays row-major in the tile, ``fill``
    outside the image."""
    B, H, W, C = x.shape
    TH, TW = (H - 1) // th + 1, (W - 1) // tw + 1
    pad = x.new_full((B, TH * th, TW * tw, C), fill)
    pad[:, :H, :W] = x
    pad = pad.reshape(B, TH, th, TW, tw, C).permute(0, 1, 3, 2, 4, 5)
    return pad.reshape(B * TH * TW, th * tw, C)


def _untile(x, B: int, H: int, W: int, th: int, tw: int):
    """(n_tiles, th*tw, C) tile layout -> (B, H, W, C)."""
    TH, TW = (H - 1) // th + 1, (W - 1) // tw + 1
    C = x.shape[-1]
    x = x.reshape(B, TH, TW, th, tw, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, TH * th, TW * tw, C)[:, :H, :W]


def _supertile(x, bin_size: int, fill=0):
    """(B, H, W, C) -> (nb, st*st, C) supertile layout (2x2 bins a tile)."""
    return _tiles(x, 2 * bin_size, 2 * bin_size, fill)


def _to_image(x, B: int, H: int, W: int, bin_size: int):
    """(nb, st*st, C) supertile layout -> (B, H, W, C)."""
    return _untile(x, B, H, W, 2 * bin_size, 2 * bin_size)


def _check_args(rays, table_c, bits_c, ids_c, counts_c, K, bin_size, attrs):
    B, H, W, _ = rays.shape
    BH2, BW2 = supertile_grid(H, W, bin_size)
    nb, M = B * BH2 * BW2, table_c.shape[1]
    if not 0 < K <= MAX_K:
        raise NotImplementedError(
            f"K={K}: the select kernel takes 1 <= K <= MAX_K = {MAX_K}; larger K "
            "takes the dense route (ops.dense_select)")
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


def hit_plain(f, r):
    """The hit test in the kernel's operation order: feature rows ``f``
    (..., 16) against ray components ``r`` (three tensors broadcastable to
    ``f``'s leading shape) -> (len, act, dsd)."""
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
    return length, act, ksk


def _select_tiles_plain(r_all, table_c, ids_c, member, thr_act: float, K: int):
    """The dense select of the plain versions: for every tile (supertile or
    bin) the hit test of each of its rays against each of its candidate
    rows, a stable sort along the candidates and the first K, in the
    kernel's operation order.

    :param r_all: (nb, R, 3) rays of each tile; :param table_c: (nb, M, 16)
    :param ids_c: (nb, M) ids the outputs report
    :param member: ``member(s0, s1)`` -> bool, broadcastable to (s1 - s0, R,
        M): which candidates count for which rays of tiles s0..s1
    :return: (idx (of ``ids_c``'s dtype), len, act, dsd), each (nb, R, K), with
        the fill values idx -1, len / act 1e10, dsd 0
    """
    nb, R, _ = r_all.shape
    M = table_c.shape[1]
    kk = min(K, M)
    outs = []
    step = max(1, _PLAIN_CHUNK // max(R * M, 1))
    for s0 in range(0, nb, step):
        s1 = min(nb, s0 + step)
        f = table_c[s0:s1, None, :, :]                          # (n, 1, M, 16)
        r = [r_all[s0:s1, :, i, None] for i in range(3)]        # (n, R, 1)
        length, act, ksk = hit_plain(f, r)
        ok = (act < thr_act) & member(s0, s1)
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
    return idx, sl, sa, sd


def _weights_plain(sl, sa, sd, agg_ow: float):
    """The fused erf weights (pallas_fine2.py:386-406) of selections
    (..., K), summed over k ascending."""
    ea = torch.exp(-sa)
    sq = torch.sqrt(sd + 1e-10)
    occ = torch.zeros_like(sl)
    for k in range(sl.shape[-1]):
        ca = (sl - sl[..., k:k + 1]) * sq[..., k:k + 1]
        occ = occ + ea[..., k:k + 1] * (0.5 * (torch.erf(ca) + 1.0))
    return torch.exp(-agg_ow * occ) * ea * _E_HALF


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
    lr = torch.arange(R, device=dev) // st
    lc = torch.arange(R, device=dev) % st
    g = (2 * (lr // bin_size) + lc // bin_size)[None, :, None]  # sub-bin
    slots = torch.arange(M, device=dev)

    def member(s0, s1):
        bit = (bits_c[s0:s1, None, :].to(torch.int64) >> g) & 1
        return (bit > 0) & (slots[None, None, :] < counts_c[s0:s1, None, None])

    idx, sl, sa, sd = _select_tiles_plain(_supertile(rays, bin_size), table_c,
                                          ids_c, member, thr_act, K)
    w = _weights_plain(sl, sa, sd, agg_ow)
    to_img = lambda x: _to_image(x, B, H, W, bin_size).contiguous()
    idx, w = to_img(idx.to(torch.int32)), to_img(w)
    img = None if attrs is None else attr_merge_plain(idx, w, attrs)
    return idx, to_img(sl), to_img(sa), to_img(sd), w, img


def _kernel():
    return bind("fine_select", "voge_fine_select",
                [VOIDP] * 12 + [INT] * 9 + [LONG, FLOAT, FLOAT, VOIDP])


def fine_select(rays, table_c, bits_c, ids_c, counts_c, thr_act: float,
                K: int, bin_size: int, agg_ow: float,
                attrs: Optional[torch.Tensor] = None):
    """Select the K nearest passing candidates of every pixel.

    :param rays: (B, H, W, 3) float32 unit world directions
    :param table_c: (nb, M, 16) float32 candidate feature rows of each
        supertile (``ops.dense_select._gauss_feature_cols`` gathered by
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
    trace.count("launch.fine_select")
    return idx, sl, sa, sd, w, img


def _check_global(rays, table, bits, K, bin_size):
    B, H, W, _ = rays.shape
    BH2, BW2 = supertile_grid(H, W, bin_size)
    nb = B * BH2 * BW2
    if not 0 < K <= MAX_K:
        raise NotImplementedError(
            f"K={K}: the select kernel takes 1 <= K <= MAX_K = {MAX_K}; larger K "
            "takes the dense route (ops.dense_select)")
    check(rays, "rays", torch.float32, (B, H, W, 3))
    if table.ndim != 2 or table.shape[0] % B or table.shape[0] == 0:
        raise ValueError(f"table: expected (B * P, {FEAT}) with B={B}, got {tuple(table.shape)}")
    P = table.shape[0] // B
    check(table, "table", torch.float32, (B * P, FEAT))
    if bits is not None:
        check(bits, "bits", torch.int32, (nb, P))
    return B, H, W, BH2, BW2, nb, P


def fine_select_global_plain(rays, table, bits, thr_act: float, K: int,
                             bin_size: int, agg_ow: float):
    """Plain version of K2's global entry: every supertile's candidate rows
    are its image's P feature rows in ascending index, ids ``b * P + n`` and
    the sub-bin bits of ``bits`` (all four when None), evaluated by
    :func:`fine_select_plain` (dense over rays x candidates in chunks of
    ``_PLAIN_CHUNK``, the kernel's operation order).  Same contract as
    :func:`fine_select_global`."""
    B, H, W, BH2, BW2, nb, P = _check_global(rays, table, bits, K, bin_size)
    dev = rays.device
    img = torch.arange(nb, device=dev) // (BH2 * BW2)
    table_c = table.reshape(B, P, FEAT)[img]
    ids_c = (img[:, None] * P + torch.arange(P, device=dev)).to(torch.int32)
    if bits is None:
        bits = torch.full((nb, P), 0xF, dtype=torch.int32, device=dev)
    counts = torch.full((nb,), P, dtype=torch.int32, device=dev)
    return fine_select_plain(rays, table_c, bits, ids_c, counts, thr_act, K,
                             bin_size, agg_ow)[:5]


def global_tile(with_bits: bool, bin_size: int):
    """(height, width) in pixels of the ray tile a group of the global
    entry's blocks takes: the supertile when a bits plane names sub-bins,
    else 8 x 16 pixels of the image (one block, a narrow cone)."""
    return (2 * bin_size, 2 * bin_size) if with_bits else _GLOBAL_TILE


@torch.no_grad()
def cull_rows_plain(table: torch.Tensor, thr_act: float) -> torch.Tensor:
    """Plain version of :func:`cull_rows`: (N, 4) float32 cull rows ``(u, q)``
    of the feature rows ``table`` (N, 16): ``u = mu / |mu|`` and ``q = lo |mu|^2 / (thr_act (1 + 1e-3))``,
    where ``lo`` is a lower bound of the least eigenvalue of Lambda's
    symmetric part less ``4e-6 ||Lambda||_F``.  ``q`` is 0 (the Gaussian is
    never culled) when ``|mu|`` is ~0, ``lo <= 0``, ``thr_act <= 0`` or
    anything is not finite.

    The eigenvalue bound, in float64: for a symmetric positive definite 3x3
    matrix ``det / (trace / 2)^2 <= lambda_min`` (the other two eigenvalues'
    product is at most the square of their mean); from there Newton's
    iteration on the characteristic polynomial, which left of its least
    root is positive, decreasing and convex, rises monotonically and never
    passes the root.
    """
    f64 = torch.float64
    L = table[:, 4:13].to(f64).reshape(-1, 3, 3)
    S = 0.5 * (L + L.transpose(1, 2))
    mu = table[:, 13:16].to(f64)
    a, b, c = S[:, 0, 0], S[:, 1, 1], S[:, 2, 2]
    d, e, f = S[:, 0, 1], S[:, 0, 2], S[:, 1, 2]
    tr = a + b + c
    c2 = (a * b - d * d) + (a * c - e * e) + (b * c - f * f)
    det = a * (b * c - f * f) - d * (d * c - f * e) + e * (d * f - b * e)
    spd = (tr > 0) & (c2 > 0) & (det > 0)
    x = torch.where(spd, det / (0.5 * tr) ** 2, 0.0)
    for _ in range(_EIG_NEWTON_STEPS):
        p = ((tr - x) * x - c2) * x + det          # det(S - x I)
        dp = (2.0 * tr - 3.0 * x) * x - c2
        x = torch.where(spd & (p > 0) & (dp < 0), x - p / dp, x)
    lo = x - _EIG_SLACK * L.flatten(1).norm(dim=1)
    n2 = (mu * mu).sum(1)
    q = lo * n2 / (thr_act * (1.0 + _CULL_MARGIN)) if thr_act > 0 else torch.zeros_like(lo)
    u = mu / n2.sqrt()[:, None]
    ok = spd & (q > 0) & (n2 > 1e-20) & torch.isfinite(q) & torch.isfinite(u).all(1)
    row = torch.cat([u, q.clamp(max=1e30)[:, None]], dim=1)
    return torch.where(ok[:, None], row, 0.0).to(torch.float32).contiguous()


@torch.no_grad()
def block_cones_plain(rays: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Plain version of :func:`block_cones`: (n_tiles * n_chunks, 8) float32
    cones ``(c, sin theta, cos theta, 0, 0, 0)`` of the kernel's ray blocks: the rays (B, H, W, 3) in tiles of
    ``th`` x ``tw`` pixels (row-major over the image, rays row-major in the
    tile) and each tile's rays in chunks of 128.  ``c`` is the unit mean
    direction of the block's rays inside the image and ``theta`` the largest
    angle between one of them and ``c``, computed in float64 and widened by
    1e-6, at most pi / 2 (then nothing is culled).  A block with no ray in
    the image, or with a ray that is not finite, gets NaN and culls nothing.
    """
    f64 = torch.float64
    B, H, W, _ = rays.shape
    t = _tiles(rays.to(f64), th, tw, float("nan"))                # (nt, th*tw, 3)
    nt, R, _ = t.shape
    nchunk = (R - 1) // _BLOCK_RAYS + 1
    if nchunk * _BLOCK_RAYS != R:
        t = torch.cat([t, t.new_full((nt, nchunk * _BLOCK_RAYS - R, 3), float("nan"))], dim=1)
    inside = _tiles(torch.ones((B, H, W, 1), dtype=torch.bool, device=rays.device), th, tw,
                    False)
    if nchunk * _BLOCK_RAYS != R:
        inside = torch.cat([inside, inside.new_zeros((nt, nchunk * _BLOCK_RAYS - R, 1))], dim=1)
    t = t.reshape(nt * nchunk, _BLOCK_RAYS, 3)
    inside = inside.reshape(nt * nchunk, _BLOCK_RAYS)
    unit = t / t.norm(dim=-1, keepdim=True)
    axis = torch.where(inside[..., None], unit, 0.0).sum(1)
    axis = axis / axis.norm(dim=-1, keepdim=True)
    cos = (unit * axis[:, None, :]).sum(-1)
    cos = torch.where(inside, cos, 1.0).min(dim=1).values     # a NaN ray gives NaN
    theta = (torch.acos(cos.clamp(-1.0, 1.0)) + _CONE_SLACK).clamp(max=0.5 * torch.pi)
    theta = torch.where(inside.any(1), theta, float("nan"))
    zero = torch.zeros_like(theta)
    cone = torch.stack([axis[:, 0], axis[:, 1], axis[:, 2], torch.sin(theta),
                        torch.cos(theta), zero, zero, zero], dim=1)
    return cone.to(torch.float32).contiguous()


def cull_rows(table: torch.Tensor, thr_act: float) -> torch.Tensor:
    """(N, 4) float32 cull rows of the feature rows ``table`` (N, 16) for
    K2's global entry: a small kernel of ``csrc/fine_select.cu`` on the card,
    :func:`cull_rows_plain` (which documents them) on the CPU."""
    if not on_cuda(table):
        return cull_rows_plain(table, thr_act)
    check(table, "table", torch.float32, (table.shape[0], FEAT))
    out = torch.empty((table.shape[0], 4), dtype=torch.float32, device=table.device)
    fn = bind("fine_select", "voge_cull_rows", [VOIDP, VOIDP, LONG, ctypes.c_double, VOIDP])
    raise_on_error(fn(ptr(table), ptr(out), table.shape[0], thr_act, stream(table.device)),
                   "cull_rows")
    trace.count("launch.cull_rows")
    return out


def block_cones(rays: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(n_tiles * n_chunks, 8) float32 cones of the kernel's ray blocks for
    K2's global entry: a small kernel of ``csrc/fine_select.cu`` on the card,
    :func:`block_cones_plain` (which documents them) on the CPU."""
    if not on_cuda(rays):
        return block_cones_plain(rays, th, tw)
    B, H, W, _ = rays.shape
    check(rays, "rays", torch.float32, (B, H, W, 3))
    TH, TW = (H - 1) // th + 1, (W - 1) // tw + 1
    nchunk = (th * tw - 1) // _BLOCK_RAYS + 1
    out = torch.empty((B * TH * TW * nchunk, 8), dtype=torch.float32, device=rays.device)
    fn = bind("fine_select", "voge_block_cones", [VOIDP, VOIDP] + [INT] * 7 + [VOIDP])
    raise_on_error(fn(ptr(rays), ptr(out), B * TH * TW, H, W, th, tw, TW, TH * TW,
                      stream(rays.device)), "block_cones")
    trace.count("launch.block_cones")
    return out


def cull_mask_plain(cones: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(n_blocks, N) bool: the pairs (block, Gaussian) the kernel's cull
    drops, from ``cones`` (n_blocks, 8) and cull ``rows`` (N, 4) of one image,
    in the kernel's float32 operation order."""
    c = [cones[:, i, None] for i in range(5)]
    u = [rows[None, :, i] for i in range(4)]
    t = ((u[0] * c[0] + u[1] * c[1]) + u[2] * c[2]).abs()
    x0 = u[1] * c[2] - u[2] * c[1]
    x1 = u[2] * c[0] - u[0] * c[2]
    x2 = u[0] * c[1] - u[1] * c[0]
    sp = torch.sqrt((x0 * x0 + x1 * x1) + x2 * x2)
    sd = (sp * c[4] - t * c[3]) - _CULL_EPS
    return (sd > 0) & (u[3] * (sd * sd) >= 1.0)


def super_grid(TH: int, TW: int, G: int):
    """(STH, STW): super-tiles of ``G`` x ``G`` tiles over a TH x TW grid
    of tiles, the last row and column cut by the image's edge."""
    return (TH - 1) // G + 1, (TW - 1) // G + 1


@torch.no_grad()
def super_cones_plain(cones: torch.Tensor, B: int, TH: int, TW: int, G: int) -> torch.Tensor:
    """Plain version of :func:`super_cones`: (B * STH * STW, 8) float32 cones
    ``(c, sin theta, cos theta, 0, 0, 0)`` of the super-tiles of ``G`` x ``G``
    tiles (row-major, :func:`super_grid`) over the tiles' float32 cones
    ``cones`` (B * TH * TW, 8) of :func:`block_cones` (one a tile).  ``c`` is
    the unit mean of the tiles' unit axes and ``theta`` the widest that a
    tile's cone reaches from it, ``max (angle(c, c_j) + atan2(sin_j,
    cos_j))``, in float64, widened by 1e-5, at most pi / 2.  A NaN in any of
    the tiles' cones makes the super-tile's NaN, which culls nothing."""
    f64 = torch.float64
    STH, STW = super_grid(TH, TW, G)
    grid = cones.to(f64).reshape(B, TH, TW, 8)
    pad = grid.new_zeros((B, STH * G, STW * G, 8))
    pad[:, :TH, :TW] = grid
    have = torch.zeros((B, STH * G, STW * G), dtype=torch.bool, device=cones.device)
    have[:, :TH, :TW] = True
    group = lambda x: x.reshape(B, STH, G, STW, G, *x.shape[3:]).transpose(2, 3).reshape(
        B * STH * STW, G * G, *x.shape[3:])
    pad, have = group(pad), group(have)
    unit = pad[..., :3] / pad[..., :3].norm(dim=-1, keepdim=True)
    axis = torch.where(have[..., None], unit, 0.0).sum(1)
    axis = axis / axis.norm(dim=-1, keepdim=True)
    cos = (unit * axis[:, None, :]).sum(-1).clamp(-1.0, 1.0)
    reach = torch.acos(cos) + torch.atan2(pad[..., 3], pad[..., 4])
    theta = torch.where(have, reach, float("-inf")).amax(1)            # a NaN stays
    theta = torch.where(torch.isnan(axis).any(1), float("nan"), theta)
    theta = (theta + _SUPER_SLACK).clamp(max=0.5 * torch.pi)
    zero = torch.zeros_like(theta)
    cone = torch.stack([axis[:, 0], axis[:, 1], axis[:, 2], torch.sin(theta),
                        torch.cos(theta), zero, zero, zero], dim=1)
    return cone.to(torch.float32).contiguous()


def super_cones(cones: torch.Tensor, B: int, TH: int, TW: int, G: int) -> torch.Tensor:
    """(B * STH * STW, 8) float32 cones of the two-level cull's super-tiles
    of ``G`` x ``G`` tiles: a small kernel of ``csrc/fine_select.cu`` on the
    card, :func:`super_cones_plain` (which documents them) on the CPU."""
    if not on_cuda(cones):
        return super_cones_plain(cones, B, TH, TW, G)
    check(cones, "cones", torch.float32, (B * TH * TW, 8))
    STH, STW = super_grid(TH, TW, G)
    out = torch.empty((B * STH * STW, 8), dtype=torch.float32, device=cones.device)
    fn = bind("fine_select", "voge_super_cones", [VOIDP, VOIDP] + [INT] * 4 + [VOIDP])
    raise_on_error(fn(ptr(cones), ptr(out), B, TH, TW, G, stream(cones.device)),
                   "super_cones")
    trace.count("launch.super_cones")
    return out


def _mask_words(P: int) -> int:
    """Words a super-tile's row of the level-1 mask takes: 32 ids a word,
    rounded up to 128 ids (a uint4 of the select's rounds)."""
    return (P - 1) // _BLOCK_RAYS * 4 + 4


@torch.no_grad()
def cull_lists_plain(rows: torch.Tensor, sup: torch.Tensor, B: int, P: int) -> torch.Tensor:
    """Plain version of :func:`cull_lists`: (B, nsup, words) int32, bit
    ``n % 32`` of word ``n // 32`` of row (b, t) set when Gaussian n of image
    b survives super-tile t's cone (``sup`` (B * nsup, 8)) by the blocks' own
    test (:func:`cull_mask_plain` on the cull ``rows`` (B * P, 4)); no bit at
    or past P."""
    nsup = sup.shape[0] // B
    words = _mask_words(P)
    keep = torch.zeros((B, nsup, words * 32), dtype=torch.int64, device=rows.device)
    for b in range(B):
        keep[b, :, :P] = ~cull_mask_plain(sup[b * nsup:(b + 1) * nsup], rows[b * P:(b + 1) * P])
    weight = torch.ones((), dtype=torch.int64, device=rows.device) << torch.arange(
        32, device=rows.device)
    word = (keep.reshape(B, nsup, words, 32) * weight).sum(-1)
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)


def mask_bits(mask: torch.Tensor, P: int) -> torch.Tensor:
    """(B, nsup, P) bool: the ids the level-1 ``mask`` (B, nsup, words) keeps."""
    bits = (mask.to(torch.int64)[..., None] >> torch.arange(32, device=mask.device)) & 1
    return bits.reshape(*mask.shape[:2], -1)[..., :P] > 0


def _count_level1(device, pairs: int):
    """Tracing's counters of one level-1 pass: its launch, its (super-tile,
    Gaussian) pairs (host); the accumulator its kernel adds the kept rows
    into, or None while tracing is off."""
    trace.count("launch.cull_lists")
    trace.count("cull.level1_pairs", pairs)
    return trace.device_counter("cull.kept_rows", device)


def cull_lists(rows: torch.Tensor, sup: torch.Tensor, B: int, P: int) -> torch.Tensor:
    """Level 1 of the two-level cull: (B, nsup, words) int32 masks of the
    Gaussians that survive each super-tile's cone, in ascending index: a
    kernel of ``csrc/fine_select.cu`` on the card (one thread a Gaussian, a
    warp's ballot a word), :func:`cull_lists_plain` (which documents them)
    on the CPU."""
    if not on_cuda(rows, sup):
        return cull_lists_plain(rows, sup, B, P)
    nsup = sup.shape[0] // B
    check(rows, "rows", torch.float32, (B * P, 4))
    check(sup, "sup", torch.float32, (B * nsup, 8))
    out = torch.empty((B, nsup, _mask_words(P)), dtype=torch.int32, device=rows.device)
    kept = _count_level1(rows.device, B * nsup * P)
    fn = bind("fine_select", "voge_cull_lists", [VOIDP] * 4 + [INT] * 3 + [VOIDP])
    raise_on_error(fn(ptr(rows), ptr(sup), ptr(out), ptr(kept), B, P, nsup,
                      stream(rows.device)), "cull_lists")
    return out


def two_level(P: int, blocks: int) -> bool:
    """Whether the global entry without bits takes the two-level cull: where
    the single level's scan, ``blocks`` (8 x 16 pixel blocks of the launch,
    every image's) x ``P`` cone tests, reaches ``_TWO_LEVEL_MIN_PAIRS`` (card
    measurements in :func:`fine_select_global`'s docstring)."""
    return P * blocks >= _TWO_LEVEL_MIN_PAIRS


def two_level_cones(rays: torch.Tensor, S: int = None):
    """The two-level route's cones: (warps' (B * TH4 * TW4, 8), super-tiles'
    (B * nsup, 8), (TH4, TW4)), a warp's tile 4 x 8 pixels and a super-tile
    ``S`` x ``S`` blocks of 8 x 16 (``2 S`` x ``2 S`` warps' tiles)."""
    S = _SUPER if S is None else S
    B, H, W, _ = rays.shape
    th, tw = _WARP_TILE
    TH4, TW4 = (H - 1) // th + 1, (W - 1) // tw + 1
    cones = block_cones(rays, th, tw)
    return cones, super_cones(cones, B, TH4, TW4, 2 * S), (TH4, TW4)


def fine_select_two_level_plain(rays, table, thr_act: float, K: int, agg_ow: float,
                                S: int = None):
    """Plain version of the two-level route of :func:`fine_select_global`
    (no bits plane): every 4 x 8 pixels (a warp's rays) take as candidates
    the Gaussians of their image that survive their super-tile's cone
    (:func:`cull_lists_plain`) and their own (:func:`cull_mask_plain`), in
    ascending index, with ids ``b * P + n``; evaluated densely by the select
    the other plain versions share.  Equal to
    :func:`fine_select_global_plain` to the bit: a culled pair never passes
    the hit test."""
    S = _SUPER if S is None else S
    B, H, W, _ = rays.shape
    P = table.shape[0] // B
    th, tw = _WARP_TILE
    TH, TW = (H - 1) // th + 1, (W - 1) // tw + 1
    STH, STW = super_grid(TH, TW, 2 * S)
    rows, cones = cull_rows_plain(table, thr_act), block_cones_plain(rays, th, tw)
    sup = super_cones_plain(cones, B, TH, TW, 2 * S)
    kept = mask_bits(cull_lists_plain(rows, sup, B, P), P)
    nt = TH * TW
    own = torch.cat([~cull_mask_plain(cones[b * nt:(b + 1) * nt], rows[b * P:(b + 1) * P])
                     for b in range(B)])                                 # (B * nt, P)
    dev = rays.device
    s = torch.arange(B * nt, device=dev)
    img, sy, sx = s // nt, s % nt // TW, s % TW
    st = (sy // (2 * S)) * STW + sx // (2 * S)
    table_c = table.reshape(B, P, FEAT)[img]
    ids_c = (img[:, None] * P + torch.arange(P, device=dev)).to(torch.int32)
    member = lambda s0, s1: (kept[img[s0:s1], st[s0:s1]] & own[s0:s1])[:, None, :]

    sel = _select_tiles_plain(_tiles(rays, th, tw), table_c, ids_c, member, thr_act, K)
    w = _weights_plain(sel[1], sel[2], sel[3], agg_ow)
    idx, sl, sa, sd, w = (_untile(x, B, H, W, th, tw).contiguous() for x in (*sel, w))
    return idx.to(torch.int32), sl, sa, sd, w


def _kernel_global():
    return bind("fine_select", "voge_fine_select_global",
                [VOIDP] * 13 + [INT] * 11 + [FLOAT, FLOAT, VOIDP])


def fine_select_global(rays, table, bits, thr_act: float, K: int,
                       bin_size: int, agg_ow: float, *, _cull: bool = True):
    """Select the K nearest passing Gaussians of every pixel over the global
    candidate space: every Gaussian of the pixel's image, in ascending index
    (the no-coarse path; ``voge_tpu``'s ``fine_select_mask_pallas``).

    Without a bits plane the cone cull takes one of two routes, by shape
    alone (:func:`two_level`).  One level: every 8 x 16 block tests all P
    cull rows of its image against its cone.  Two levels, where the blocks
    of the launch times P reach 2**22: super-tiles of 2 x 2 blocks test them
    once (:func:`cull_lists`), and each block walks only its super-tile's
    survivors, each of its warps (4 x 8 rays) the rows its own cone keeps.
    Both drop only pairs that cannot pass, so the outputs are the same bits.
    Device ms a call on an H100 80GB HBM3 (700 W), one level / two levels
    (``tools/torch_cull_levels.py``; the point cloud at 128x128 or 320x320,
    one view, K = 20): P = 256 at 128x128 (32,768 block x Gaussian pairs)
    0.0163 / 0.0312; 1,000 (128,000) 0.0251 / 0.0364; 2,562 (327,936)
    0.0439 / 0.0433; 10,000 (1.28 M) 0.1282 / 0.0777; the ShapeFitting shape
    (2,562 Gaussians, 5 views at 128x128, K = 25; 1.64 M) 0.4081 / 0.2369;
    30,000 at 320x320 (24 M) 0.2334 / 0.1222; 100,000 0.6993 / 0.3162;
    300,000 1.9985 / 0.8374; 300,000 under 4 views 6.5322 / 3.0033.  There
    super-tiles of 4 x 4 blocks took 3.42 ms, of 8 x 8 5.31 (2 x 2: 3.02, in
    the same run).  Two levels launch two kernels more; below 2**22 the
    device time they save is small against what two launches cost a caller
    that the host paces: the ShapeFitting step (render, loss, backward)
    measured 4.304 ms a step on two levels against 4.212 on one (medians of
    eight turns of 40 steps, in one process), though its select took 0.19
    device ms less, so it keeps one level.

    :param rays: (B, H, W, 3) float32 unit world directions
    :param table: (B * P, 16) float32 feature rows
        (``ops.dense_select._gauss_feature_cols``), row ``b * P + n`` the
        n-th Gaussian of image b
    :param bits: (nb, P) int32 sub-bin membership bits of each supertile
        (nb = B * BH2 * BW2), or None: every Gaussian is a member everywhere
    :param _cull: a reference for checks and measurements, not an option of
        the path: False walks every Gaussian (the same kernel without its
        cone cull; the same bits, slower), which reaches image sizes the
        dense plain version cannot
    :return: (idx (B,H,W,K) int32 ids ``b * P + n``, len, act, dsd, w
        (B,H,W,K) float32); empty slots hold idx -1, len / act 1e10, dsd 0,
        w 0
    """
    if not on_cuda(rays, table, bits):
        return fine_select_global_plain(rays, table, bits, thr_act, K, bin_size, agg_ow)
    B, H, W, BH2, BW2, nb, P = _check_global(rays, table, bits, K, bin_size)
    dev = rays.device
    f32 = dict(dtype=torch.float32, device=dev)
    idx = torch.empty((B, H, W, K), dtype=torch.int32, device=dev)
    sl, sa, sd, w = (torch.empty((B, H, W, K), **f32) for _ in range(4))
    th, tw = global_tile(bits is not None, bin_size)
    TH, TW = (H - 1) // th + 1, (W - 1) // tw + 1
    cull = cones = sup = mask = kept = None
    S = 0
    if _cull:
        with trace.span("voge.select.cull"):
            cull = cull_rows(table, thr_act)
            if bits is None and two_level(P, B * TH * TW):
                # one workspace, which the call fills before its select: the
                # warps' cones, the super-tiles' cones and level 1's mask
                S = _SUPER
                TH4, TW4 = (H - 1) // _WARP_TILE[0] + 1, (W - 1) // _WARP_TILE[1] + 1
                nsup = math.prod(super_grid(TH4, TW4, 2 * S))
                sizes = [B * TH4 * TW4 * 8, B * nsup * 8, B * nsup * _mask_words(P)]
                work = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
                cones, sup, mask = work.split(sizes)
                trace.count("launch.block_cones")
                trace.count("launch.super_cones")
                kept = _count_level1(dev, B * nsup * P)
            else:
                cones = block_cones(rays, th, tw)
    err = _kernel_global()(
        ptr(rays), ptr(table), ptr(bits), ptr(cull), ptr(cones), ptr(sup), ptr(mask),
        ptr(kept), ptr(idx),
        ptr(sl), ptr(sa), ptr(sd), ptr(w), B * TH * TW, H, W, bin_size, th, tw,
        TW, TH * TW, P, K, S, thr_act, agg_ow, stream(dev),
    )
    raise_on_error(err, "fine_select_global")
    trace.count("launch.fine_select_global")
    return idx, sl, sa, sd, w


def _check_bins(rays, table, bin_points, K, bin_size):
    B, H, W, _ = rays.shape
    bsh, bsw = (bin_size, bin_size) if isinstance(bin_size, int) else bin_size
    BH, BW = (H - 1) // bsh + 1, (W - 1) // bsw + 1
    if not 0 < K <= MAX_K:
        raise NotImplementedError(
            f"K={K}: the select kernel takes 1 <= K <= MAX_K = {MAX_K}; larger K "
            "takes the dense route (ops.dense_select)")
    check(rays, "rays", torch.float32, (B, H, W, 3))
    if table.ndim != 2 or table.shape[0] == 0:
        raise ValueError(f"table: expected (rows, {FEAT}), got {tuple(table.shape)}")
    check(table, "table", torch.float32, (table.shape[0], FEAT))
    if bin_points.ndim != 4 or bin_points.shape[3] == 0:
        raise ValueError(f"bin_points: expected (B, BH, BW, M), got {tuple(bin_points.shape)}")
    check(bin_points, "bin_points", torch.int32, (B, BH, BW, bin_points.shape[3]))
    return B, H, W, int(bsh), int(bsw), BH, BW, bin_points.shape[3]


def fine_select_bins_plain(rays, table, bin_points, thr_act: float, K: int,
                           bin_size):
    """Plain version of K2's per-bin-list entry: every bin's candidate rows
    are the table rows its list names (a zero row, never a member, for an
    empty entry), evaluated densely over the bin's rays by the select the
    other plain versions share.  Same contract as :func:`fine_select_bins`."""
    B, H, W, bsh, bsw, BH, BW, M = _check_bins(rays, table, bin_points, K, bin_size)
    n_tab = table.shape[0]
    lists = bin_points.reshape(-1, M)
    listed = (lists >= 0) & (lists < n_tab)
    rows = torch.cat([table, table.new_zeros((1, FEAT))])[
        torch.where(listed, lists, n_tab).long()]               # (nb, M, 16)
    member = lambda s0, s1: listed[s0:s1, None, :]
    sel = _select_tiles_plain(_tiles(rays, bsh, bsw), rows, lists, member,
                              thr_act, K)
    idx, sl, sa, sd = (_untile(x, B, H, W, bsh, bsw).contiguous() for x in sel)
    return idx.to(torch.int32), sl, sa, sd


def _kernel_bins():
    return bind("fine_select", "voge_fine_select_bins",
                [VOIDP] * 7 + [INT] * 8 + [LONG, INT, FLOAT, VOIDP])


def fine_select_bins(rays, table, bin_points, thr_act: float, K: int,
                     bin_size):
    """Select the K nearest passing candidates of every pixel from its bin's
    candidate list (``voge_tpu``'s ``fine_select_pallas``; the public
    two-stage tracer).  Earlier list positions win ties.

    :param rays: (B, H, W, 3) float32 unit world directions
    :param table: (rows, 16) float32 feature rows
        (``ops.fine.feature_table``), indexed by the lists' ids
    :param bin_points: (B, BH, BW, M) int32 ids of each bin's candidates, -1
        where empty
    :param bin_size: pixels a bin spans, an int or (height, width)
    :return: (idx (B,H,W,K) int32 ids from the lists, len, act, dsd (B,H,W,K)
        float32); empty slots hold idx -1, len / act 1e10, dsd 0
    """
    if not on_cuda(rays, table, bin_points):
        return fine_select_bins_plain(rays, table, bin_points, thr_act, K, bin_size)
    B, H, W, bsh, bsw, BH, BW, M = _check_bins(rays, table, bin_points, K, bin_size)
    dev = rays.device
    idx = torch.empty((B, H, W, K), dtype=torch.int32, device=dev)
    sl, sa, sd = (torch.empty((B, H, W, K), dtype=torch.float32, device=dev)
                  for _ in range(3))
    err = _kernel_bins()(
        ptr(rays), ptr(table), ptr(bin_points), ptr(idx), ptr(sl), ptr(sa),
        ptr(sd), B * BH * BW, H, W, bsh, bsw, BW, BH * BW, M, table.shape[0],
        K, thr_act, stream(dev),
    )
    raise_on_error(err, "fine_select_bins")
    trace.count("launch.fine_select_bins")
    return idx, sl, sa, sd
