"""Coarse stage: emission-compacted per-supertile candidate rows
(counterpart of ``voge_tpu/ops/coarse.py``).

Every Gaussian emits up to win x win sort keys, one per supertile (2x2 bins)
of the window covering its pixel-space ellipse bound, with the four sub-bin
membership bits in the key's low 4 bits (kernel K1, ``ops/cuda_coarse.py``).
One flat sort groups the keys by supertile in ascending Gaussian index, and
each supertile's contiguous run becomes one candidate row.  Gaussians whose
bound spans more than the window are "global": the first ``n_globals`` (by
index) emit one key per supertile they overlap, the rest are dropped and
counted.  The sort, ``searchsorted`` and row slicing are PyTorch ops.  Keys
are int64 on every device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from voge_tpu_torch.ops.cuda_coarse import (  # noqa: F401  (re-exported)
    _camera_planes,
    _pixel_radii_planes,
    emit_keys,
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


def _bits(u, v, rx, ry, sxf, syf, fb: float, H: int, W: int):
    """Sub-bin membership bits (bit 2i + j: y sub-bin i, x sub-bin j) of a
    supertile with pixel origin (sxf, syf)."""
    bits = torch.zeros(torch.broadcast_shapes(u.shape, sxf.shape),
                       dtype=torch.int64, device=u.device)
    for i in range(2):
        byi = syf + i * fb
        yo = (v - ry <= byi + fb) & (byi < v + ry) & (byi < H)
        for j in range(2):
            bxj = sxf + j * fb
            xo = (u - rx <= bxj + fb) & (bxj < u + rx) & (bxj < W)
            bits = bits | ((yo & xo).to(torch.int64) << (2 * i + j))
    return bits


def supertile_grid(H: int, W: int, bin_size: int):
    """(BH2, BW2): supertiles of 2x2 bins covering an H x W image."""
    BH, BW = (H - 1) // bin_size + 1, (W - 1) // bin_size + 1
    return (BH + 1) // 2, (BW + 1) // 2


def emission_geometry(P: int, image_size, bin_size: int):
    """(nst, BH2, BW2, S, win): supertiles per image and their grid, the
    per-image index range of the sort key, and the emission window (2x2
    supertiles for dense scenes, 3x3 for sparse ones, grown when the bins
    are smaller than the reference heuristic's)."""
    H, W = int(image_size[0]), int(image_size[1])
    b = int(bin_size)
    BH2, BW2 = supertile_grid(H, W, b)
    S = 1 << max(int(P - 1).bit_length(), 1)
    win = 3 if P <= 4096 else 2
    ref_b = max(int(2 ** math.ceil(math.log2(max(H, W)) - 5)), 10)
    if b < ref_b:
        win = max(win, min(8, int(math.ceil((3 * ref_b + b) / (2 * b)))))
    return BH2 * BW2, BH2, BW2, S, win


def emit_supertile_candidates(R, T, focal, principal, points, isigmas,
                              image_size, thr: float, bin_size: int,
                              M_max: int, n_globals: int = 64,
                              row_align: int = 0):
    """Per-supertile candidate rows of ascending Gaussian index.

    :param points: (B, P, 3) camera-centred means; :param isigmas: (B, P, 3, 3)
    :param M_max: row capacity; members beyond it are dropped and counted
    :param row_align: when > 0, ``M_max`` is only a floor: the rows grow to
        hold the densest supertile, rounded up to a multiple of ``row_align``
        (costs one host read), so nothing but excess globals is dropped
    :return: (pos_c (nb, M) int32 per-image Gaussian index, bits_c (nb, M)
        int32 sub-bin bits, ids_c (nb, M) int32 flattened ``b * P + p`` ids
        (-1 pad), counts_c (nb,) int32 row occupancy, overflow_c (nb,) int32
        members dropped), nb = B * BH2 * BW2 supertiles in row-major order.
    """
    B, P = points.shape[0], points.shape[1]
    H, W = int(image_size[0]), int(image_size[1])
    fb = float(bin_size)
    st = 2.0 * fb
    nst, BH2, BW2, S, win = emission_geometry(P, (H, W), bin_size)
    nb = B * nst
    dev = points.device
    i64 = torch.int64
    big = nb * S * 16                          # above every valid key
    keys, u, v, rx, ry, _z, oversize = emit_keys(
        R, T, focal, principal, points.detach(), isigmas.detach(), thr,
        bin_size, (H, W), nst, BH2, BW2, S, win,
    )

    # global members: the first n_globals oversize Gaussians by index emit
    # one key per supertile they overlap
    n_globals = min(int(n_globals), P)
    idx = torch.arange(P, device=dev, dtype=i64)
    g_take = torch.where(oversize, idx, P).sort(dim=1).values[:, :n_globals]
    g_valid = g_take < P
    gpos = torch.where(g_valid, g_take, 0)
    ga = lambda p: p.gather(1, gpos)[..., None]
    s_all = torch.arange(nst, device=dev, dtype=i64)
    bits_g = _bits(ga(u), ga(v), ga(rx), ga(ry),
                   (s_all % BW2).to(torch.float32) * st,
                   (s_all // BW2).to(torch.float32) * st, fb, H, W)
    valid_g = g_valid[..., None] & (bits_g != 0)
    g_over = (oversize.sum(dim=1) - n_globals).clamp(min=0)
    img = torch.arange(B, device=dev, dtype=i64)[:, None, None]
    key_g = ((img * nst + s_all) * S + gpos[..., None]) * 16 + bits_g
    key_g = torch.where(valid_g, key_g, big)

    flat = torch.sort(torch.cat([keys.reshape(-1), key_g.reshape(-1)])).values
    edges = torch.arange(nb + 1, device=dev, dtype=i64) * (S * 16)
    starts = torch.searchsorted(flat, edges)
    counts_full = starts[1:] - starts[:-1]
    if row_align > 0:
        densest = int(counts_full.max()) if nb else 0
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
    return (pos_c.to(i32), bits_c.to(i32), ids_c.to(i32), counts_c.to(i32),
            overflow_c.to(i32))
