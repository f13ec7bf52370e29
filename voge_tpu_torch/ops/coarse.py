"""Coarse stage (counterpart of ``voge_tpu/ops/coarse.py``): the
emission-compacted per-supertile candidate rows of the render path, and the
per-bin candidate lists of the two-stage public tracer.

Emission.  Every Gaussian is a candidate of up to win x win supertiles (2x2
bins each), the cells of the window covering the exact pixel box of its
thr-level ellipsoid's perspective image, with four sub-bin membership bits
per cell.  Gaussians whose bound spans more
than the window are "global": the first ``n_globals`` of them (by index) are
members of every supertile they overlap, the rest are dropped and counted.
Each supertile's members, ascending by Gaussian index, form one candidate
row.  The stage runs in the hand-written kernels of ``csrc/emit.cu``
(``ops/cuda_coarse.py``: the emission K1 writes each window cell's row id,
the globals kernel finds and bins the global members, the rows kernel merges
each row's local run with its global members) around ``cuda_attr.slot_runs``,
which groups the window cells by row id; on CPU tensors each runs its plain
version.  A render asks for exact rows (``row_align``): the rows grow to the
densest supertile, and when more Gaussians than ``n_globals`` outgrow the
window, the emission runs once more with the window those Gaussians need, so
that only bounds wider than K1's largest window can be dropped.  That takes
one host read a render (two when it re-emits).  The port's first route (an
int64 sort key per window cell, one ``torch.sort``, ``searchsorted`` and row
slicing) stays as :func:`_emit_candidates_sorted`: the reference the rows are
held to, bit for bit, and the library comparator; no main path takes it.

Lists.  :func:`rasterize_coarse` tests every (bin, Gaussian) pair
(:func:`overlap_mask`) and compacts each bin's members into an ascending,
-1-padded list (:func:`compact_mask`); plain PyTorch ops, as they are XLA ops
in ``voge_tpu``.  They bin by upstream's box (``cuda_coarse._upstream_planes``:
the ellipsoid's slice at the centre's depth), as
``voge_tpu`` and upstream's ``RayTracing.py`` do, which misses passing pairs
off the axis; the render path's emission bins by the exact box.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from voge_tpu_torch import trace
from voge_tpu_torch.ops.cuda_attr import slot_runs
from voge_tpu_torch.ops.cuda_coarse import (  # noqa: F401  (re-exported)
    MAX_WIN,
    _camera_planes,
    _pixel_radii_planes,
    _upstream_planes,
    coarse_globals,
    coarse_rows,
    emit_rows,
    supertile_bits,
    supertile_window,
    unpack_flags,
)


def coarse_bin_config(image_size, n_assign: int, n_points: int,
                      bin_size: Optional[int] = None,
                      max_points_per_bin: Optional[int] = None):
    """The reference's auto-config heuristics (``RayTracing.py:14-19``)."""
    if bin_size is None:
        bin_size = max(int(2 ** math.ceil(math.log2(max(image_size)) - 5)), 10)
    if max_points_per_bin is None:
        max_points_per_bin = min(int(max(n_assign * 10, n_points / 10)), n_points)
    return int(bin_size), int(max_points_per_bin)


def supertile_grid(H: int, W: int, bin_size: int):
    """(BH2, BW2): supertiles of 2x2 bins covering an H x W image."""
    BH, BW = (H - 1) // bin_size + 1, (W - 1) // bin_size + 1
    return (BH + 1) // 2, (BW + 1) // 2


def emission_geometry(P: int, image_size, bin_size: int):
    """(nst, BH2, BW2, S, win): supertiles per image and their grid, the
    per-image index range of the sort key, and the emission window a scene
    starts with (2x2 supertiles for dense scenes, 3x3 for sparse ones, grown
    when the bins are smaller than the reference heuristic's).
    :func:`emit_supertile_candidates` widens it when the radii ask for more."""
    H, W = int(image_size[0]), int(image_size[1])
    b = int(bin_size)
    BH2, BW2 = supertile_grid(H, W, b)
    S = 1 << max(int(P - 1).bit_length(), 1)
    win = 3 if P <= 4096 else 2
    ref_b = max(int(2 ** math.ceil(math.log2(max(H, W)) - 5)), 10)
    if b < ref_b:
        win = max(win, min(MAX_WIN, int(math.ceil((3 * ref_b + b) / (2 * b)))))
    return BH2 * BW2, BH2, BW2, S, win


def emit_supertile_candidates(R, T, focal, principal, points, isigmas,
                              image_size, thr: float, bin_size: int,
                              M_max: int, n_globals: int = 64,
                              row_align: int = 0, return_dst: bool = False):
    """Per-supertile candidate rows of ascending Gaussian index.

    :param points: (B, P, 3) camera-centred means; :param isigmas: (B, P, 3, 3)
    :param M_max: row capacity; members beyond it are dropped and counted
    :param row_align: when > 0 the rows are exact, at the cost of one host
        read: ``M_max`` is only a floor and the rows grow to hold the densest
        supertile, rounded up to a multiple of ``row_align``; and when more
        than ``n_globals`` Gaussians outgrow the emission window, the
        emission runs again with the window they need (up to ``MAX_WIN``).
        Then only excess globals wider than that are dropped
    :param return_dst: also return the inverse emission map (below)
    :return: (pos_c (nb, M) int32 per-image Gaussian index, bits_c (nb, M)
        int32 sub-bin bits, ids_c (nb, M) int32 flattened ``b * P + p`` ids
        (-1 pad), counts_c (nb,) int32 row occupancy, overflow_c (nb,) int32
        members dropped), nb = B * BH2 * BW2 supertiles in row-major order.
        With ``return_dst`` a sixth element ``(dst_l (B, P, win^2), dst_g
        (B, n_globals, nst), gpos (B, n_globals), g_valid (B, n_globals))``:
        the slot ``row * M + rank`` each emitted key landed in (int32, -1
        when not emitted or dropped), for the local window keys and for the
        global members' per-supertile keys, with the globals' Gaussian
        indices and validity.  ``ops.fine.gather_back_rows``, the
        counterpart of ``voge_tpu``'s gather-back that the tests hold, takes
        it; no backward of the port does (K3 writes one row a Gaussian).
    """
    win = emission_geometry(points.shape[1], image_size, bin_size)[-1]
    return _emit_candidates(R, T, focal, principal, points, isigmas, image_size,
                            thr, bin_size, M_max, n_globals, row_align,
                            return_dst, win)


def _emit_candidates(R, T, focal, principal, points, isigmas, image_size,
                     thr, bin_size, M_max, n_globals, row_align, return_dst,
                     win: int):
    """:func:`emit_supertile_candidates` with the emission window ``win``."""
    B, P = points.shape[0], points.shape[1]
    H, W = int(image_size[0]), int(image_size[1])
    nst, BH2, BW2, _, _ = emission_geometry(P, (H, W), bin_size)
    nb = B * nst
    rid, bits, planes, over, info = emit_rows(
        R, T, focal, principal, points.detach(), isigmas.detach(), thr,
        bin_size, (H, W), nst, BH2, BW2, win,
    )
    order, starts = slot_runs(rid, nb)
    gpos, g_valid, bits_g, gstat = coarse_globals(
        over, planes, starts, info, min(int(n_globals), P), nst, BW2, bin_size, (H, W))
    if row_align > 0 and nb:
        with trace.span("voge.coarse.read"):
            densest, dropped, wider = info.tolist()   # the render's one host read
        trace.count("host_reads")
        if dropped and win < MAX_WIN and wider > win:
            # more Gaussians outgrow the window than the global list holds:
            # emit once more with the window the finite ones need
            trace.count("coarse.reemits")
            return _emit_candidates(
                R, T, focal, principal, points, isigmas, image_size, thr,
                bin_size, M_max, n_globals, row_align, return_dst, wider)
        M_max = max(int(M_max), -(-densest // row_align) * row_align)
    rows = coarse_rows(order, starts, bits, gpos, bits_g, gstat, int(M_max), nst,
                       return_dst)
    if not return_dst:
        return rows
    return rows[:5] + ((rows[5], rows[6], gpos, g_valid),)


def _emit_candidates_sorted(R, T, focal, principal, points, isigmas, image_size,
                            thr, bin_size, M_max, n_globals, row_align,
                            return_dst, win: int):
    """:func:`_emit_candidates` by the port's first route: an int64 sort key
    ``((img * nst + st) * S + idx) * 16 + bits`` per window cell and per
    global member's supertile, one ``torch.sort``, ``searchsorted`` of the
    row edges and row slicing, in PyTorch.  The reference the staged route is
    held to, bit for bit, and its library comparator; no main path takes
    it."""
    B, P = points.shape[0], points.shape[1]
    H, W = int(image_size[0]), int(image_size[1])
    fb = float(bin_size)
    st = 2.0 * fb
    nst, BH2, BW2, S, _ = emission_geometry(P, (H, W), bin_size)
    nb = B * nst
    dev = points.device
    i64 = torch.int64
    big = nb * S * 16                          # above every valid key
    rid, bits_l, planes, over, _ = emit_rows(
        R, T, focal, principal, points.detach(), isigmas.detach(), thr,
        bin_size, (H, W), nst, BH2, BW2, win,
    )
    idx = torch.arange(P, device=dev, dtype=i64)
    keys = torch.where(rid >= 0, (rid.to(i64) * S + idx[:, None]) * 16 + bits_l.to(i64), big)
    u, v, rx, ry = planes.unbind(1)
    oversize = unpack_flags(over, P)

    # global members: the first n_globals oversize Gaussians by index emit
    # one key per supertile they overlap
    n_globals = min(int(n_globals), P)
    g_take = torch.where(oversize, idx, P).sort(dim=1).values[:, :n_globals]
    g_valid = g_take < P
    gpos = torch.where(g_valid, g_take, 0)
    ga = lambda p: p.gather(1, gpos)[..., None]
    s_all = torch.arange(nst, device=dev, dtype=i64)
    bits_g = supertile_bits(ga(u), ga(v), ga(rx), ga(ry),
                            (s_all % BW2).to(torch.float32) * st,
                            (s_all // BW2).to(torch.float32) * st, fb, H, W)
    valid_g = g_valid[..., None] & (bits_g != 0)
    g_over = (oversize.sum(dim=1) - n_globals).clamp(min=0)
    img = torch.arange(B, device=dev, dtype=i64)[:, None, None]
    key_g = ((img * nst + s_all) * S + gpos[..., None]) * 16 + bits_g
    key_g = torch.where(valid_g, key_g, big)

    flat, order = torch.sort(torch.cat([keys.reshape(-1), key_g.reshape(-1)]))
    edges = torch.arange(nb + 1, device=dev, dtype=i64) * (S * 16)
    starts = torch.searchsorted(flat, edges)
    counts_full = starts[1:] - starts[:-1]
    if row_align > 0 and nb:
        with trace.span("voge.coarse.read"):
            densest, dropped = torch.stack([counts_full.max(), g_over.max()]).tolist()
        trace.count("host_reads")
        if dropped and win < MAX_WIN:
            st_t = torch.tensor(st, dtype=torch.float32, device=dev)
            _, wx, finx = supertile_window(u, rx, fb, st_t)
            _, wy, finy = supertile_window(v, ry, fb, st_t)
            fits = oversize & finx & finy & (wx <= MAX_WIN) & (wy <= MAX_WIN)
            with trace.span("voge.coarse.read"):
                wider = int(torch.where(fits, torch.maximum(wx, wy), 0).max())
            trace.count("host_reads")
            if wider > win:
                trace.count("coarse.reemits")
                return _emit_candidates_sorted(
                    R, T, focal, principal, points, isigmas, image_size, thr,
                    bin_size, M_max, n_globals, row_align, return_dst, wider)
        M_max = max(int(M_max), -(-densest // row_align) * row_align)
    counts_c = counts_full.clamp(max=M_max)
    row = torch.arange(nb, device=dev, dtype=i64)
    # excess globals are a per-image count: charge it to the first row
    overflow_c = counts_full - counts_c + torch.where(
        row % nst == 0, g_over[row // nst], 0)

    flat_pad = torch.cat([flat, torch.full((M_max,), big, dtype=i64, device=dev)])
    slots = torch.arange(M_max, device=dev, dtype=i64)
    rows = flat_pad[starts[:-1, None] + slots]
    valid = slots < counts_c[:, None]
    pos_c = torch.where(valid, (rows // 16) % S, 0)
    bits_c = torch.where(valid, rows % 16, 0)
    ids_c = torch.where(valid, (row // nst)[:, None] * P + pos_c, -1)
    i32 = torch.int32
    out = (pos_c.to(i32), bits_c.to(i32), ids_c.to(i32), counts_c.to(i32),
           overflow_c.to(i32))
    if not return_dst:
        return out

    # inverse map: sorted position t holds key flat[t], the emission order[t];
    # its row is the key's supertile and its rank t - starts[row].  Valid keys
    # are distinct, so the sort order of the sentinels is irrelevant, and the
    # write back to emission order stores integers to distinct slots.
    run = flat // (S * 16)
    t = torch.arange(flat.shape[0], device=dev, dtype=i64)
    rank = t - starts[run]                     # run <= nb: starts has nb + 1
    dst_s = torch.where((run < nb) & (rank < M_max), run * M_max + rank, -1)
    dst_e = torch.empty_like(dst_s).scatter_(0, order, dst_s).to(i32)
    n_loc = keys.numel()
    dst_l = dst_e[:n_loc].reshape(keys.shape)
    dst_g = dst_e[n_loc:].reshape(key_g.shape)
    return out + ((dst_l, dst_g, gpos.to(i32), g_valid),)


def overlap_mask(R, T, focal, principal, points, isigmas, image_size,
                 thr: float, bin_size: int):
    """(B, BH, BW, P) bool: the thr-level ellipse bound of Gaussian p
    overlaps bin (by, bx), and p lies in front of the camera
    (``voge_tpu.ops.coarse.overlap_mask``)."""
    H, W = int(image_size[0]), int(image_size[1])
    BH = (H - 1) // bin_size + 1
    BW = (W - 1) // bin_size + 1
    u, v, rx, ry, z = _upstream_planes(R, focal, principal, points, isigmas, thr)
    keep = ~(z < 0)
    bx = torch.arange(BW, dtype=points.dtype, device=points.device)[None, :, None] * bin_size
    by = torch.arange(BH, dtype=points.dtype, device=points.device)[None, :, None] * bin_size
    xo = ((u - rx)[:, None, :] <= bx + bin_size) & (bx < (u + rx)[:, None, :])
    yo = ((v - ry)[:, None, :] <= by + bin_size) & (by < (v + ry)[:, None, :])
    return yo[:, :, None, :] & xo[:, None, :, :] & keep[:, None, None, :]


def compact_mask(mask: torch.Tensor, M: int,
                 base_offset: Optional[torch.Tensor] = None):
    """Rows of set-bit indices, ascending, -1 padded, capped at ``M``.

    :param mask: (nb, P) bool; :param base_offset: optional (nb,) added to
        the emitted indices
    :return: (bin_points (nb, M) int32, counts (nb,) int32, exact: a count
        above ``M`` tells of a truncated row)
    """
    nb, P = mask.shape
    pos = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    counts = (pos[:, -1] + 1).to(torch.int32)
    ids = torch.arange(P, dtype=torch.int32, device=mask.device).expand(nb, P)
    if base_offset is not None:
        ids = ids + base_offset[:, None].to(torch.int32)
    # members beyond the cap and non-members land in a dump column; every
    # kept member has a column of its own
    pos_write = torch.where(mask & (pos < M), pos, M).long()
    bin_points = torch.full((nb, M + 1), -1, dtype=torch.int32, device=mask.device)
    bin_points.scatter_(1, pos_write, ids)
    return bin_points[:, :M].contiguous(), counts


def rasterize_coarse(R, T, focal, principal, points, isigmas, image_size,
                     thr: float, bin_size: int, max_points_per_bin: int,
                     return_counts: bool = False):
    """Per-bin candidate lists (``voge_tpu.ops.coarse.rasterize_coarse``,
    reference ``RayTracing.py:60-72``).

    :param R, T, focal, principal: (B, 3, 3), (B, 3), (B, 2), (B, 2) cameras
    :param points: (B, P, 3) camera-centred means; :param isigmas: (B, P, 3, 3)
    :return: bin_points (B, BH, BW, M) int32 flattened ids ``b * P + p``,
        ascending, -1 padded, the lowest ``M`` kept; with ``return_counts``
        also the exact member counts (B, BH, BW) int32 (a count above ``M``:
        the bin was truncated)
    """
    B, P = points.shape[0], points.shape[1]
    H, W = int(image_size[0]), int(image_size[1])
    BH = (H - 1) // bin_size + 1
    BW = (W - 1) // bin_size + 1
    M = int(max_points_per_bin)
    mask = overlap_mask(R, T, focal, principal, points, isigmas, (H, W), thr,
                        bin_size).reshape(B * BH * BW, P)
    base = torch.arange(B, dtype=torch.int32,
                        device=points.device).repeat_interleave(BH * BW) * P
    bin_points, counts = compact_mask(mask, M, base_offset=base)
    bin_points = bin_points.reshape(B, BH, BW, M)
    if return_counts:
        return bin_points, counts.reshape(B, BH, BW)
    return bin_points


def convert_to_box(isigmas: torch.Tensor, thr: float, z: torch.Tensor,
                   matrix: torch.Tensor) -> torch.Tensor:
    """NDC-space box half-extents (reference ``RayTracing.py:33-39``).

    :param isigmas: (B, N, 3, 3) camera-rotated Lambda; :param z: (B, N)
        multiplier (the renderer passes 1 / z_view); :param matrix: (B, 4, 4)
        projection matrix (only ``[:2, :2]`` is read)
    :return: (B, N, 2)
    """
    a, b = isigmas[..., 0, 0], isigmas[..., 0, 1]
    c, d = isigmas[..., 1, 0], isigmas[..., 1, 1]
    det = a * d - b * c
    inv = [[d / det, -b / det], [-c / det, a / det]]
    m = [[matrix[:, i, j][:, None] for j in range(2)] for i in range(2)]
    nlt = -math.log(thr)
    boxes = []
    for col in range(2):
        acc = 0.0
        for i in range(2):
            for k in range(2):
                for j in range(2):
                    acc = acc + m[i][k] * inv[k][j] * m[j][col]
        boxes.append(torch.sqrt(nlt * acc) * z)
    return torch.stack(boxes, dim=-1)
