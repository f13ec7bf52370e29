"""The coarse stage's kernels (``csrc/emit.cu``) and their plain PyTorch
versions: from cameras and Gaussians to the per-supertile candidate rows.

- :func:`emit_rows` (K1) replaces ``voge_tpu/ops/pallas_coarse.py::
  _emit_kernel``.  Per Gaussian: project the centre to (u, v, z), bound the
  thr-level ellipse in pixels (rx, ry), pick the win x win supertile window
  and, per window cell, write the row id ``img * nst + st`` (-1 when the cell
  holds no member) and the four sub-bin bits, in the layout (B, P, win^2):
  Gaussian-major within an image.  Beside them the (u, v, rx, ry) planes, the
  oversize flags as 32-bit words and, in a small ``info`` buffer, the widest
  window the finite oversize Gaussians need.
- :func:`coarse_globals`: per image, the first ``n_globals`` oversize
  Gaussians by index (a stable compaction of the flag words), their bits
  over every supertile, and into ``info`` the densest row (local run +
  global members) and the most globals an image drops.
- :func:`coarse_rows`: per row, the ascending local run of
  ``cuda_attr.slot_runs`` merged with the row's ascending global members into
  ``pos_c`` / ``bits_c`` / ``ids_c`` at width M, the counts, the overflow and
  on request the inverse emission map.

Together with ``slot_runs`` they replace the int64 key, one ``torch.sort``,
``searchsorted`` and the row slicing of the port's first version (kept as
``ops.coarse._emit_candidates_sorted``, the reference and the library
comparator): the rows are equal to the bit (the proof is in the source note
of ``csrc/emit.cu``).  The wrapper of the stage (``ops.coarse``) reads
``info`` once per render.

Bound on the H100: launch latency; ~2 MB of traffic at 100K Gaussians.
Design: one thread per Gaussian, one block per image, one block per row;
compiled with ``-fmad=false`` and written in the Pallas kernel's operation
order, so the emission's planes and bits and the globals' bits equal the
plain versions' bit for bit.  The plain versions divide by tensors, never by
Python scalars, because PyTorch's CUDA division by a scalar multiplies by its
reciprocal.
"""
from __future__ import annotations

import math

import torch

from voge_tpu_torch.ops._dispatch import (
    FLOAT, INT, VOIDP, bind, check, on_cuda, ptr, raise_on_error, stream,
)

MAX_WIN = 8          # the widest emission window K1 is built for
INFO_LEN = 3         # info: densest row, dropped globals, wider window
MAX_GLOBALS = 4096   # the rows kernel stages a row's global members in shared memory


def _camera_planes(R, T, focal, principal, points):
    """(u, v, z_view), each (B, P), of camera-centred points (B, P, 3):
    ``x_view = x_cc @ R`` and the mirrored projection ``u = px - fx x/z``."""
    p = [points[..., d] for d in range(3)]
    view = [p[0] * R[:, 0, d, None] + p[1] * R[:, 1, d, None]
            + p[2] * R[:, 2, d, None] for d in range(3)]
    z = view[2]
    u = principal[:, 0:1] - view[0] * focal[:, 0:1] / z
    v = principal[:, 1:2] - view[1] * focal[:, 1:2] / z
    return u, v, z


def _pixel_radii_planes(R, focal, isigmas, thr: float, z):
    """Pixel half-extents (rx, ry) of the thr-level ellipse: the top-left
    2x2 block of R^T Lambda R, inverted in closed form, in the term order of
    ``pallas_coarse.py:63-77`` (which rounds differently from
    ``voge_tpu.ops.coarse._pixel_radii_planes``)."""
    L = [[isigmas[..., i, j] for j in range(3)] for i in range(3)]
    Lc = [[None, None], [None, None]]
    for a in range(2):
        for b in range(2):
            acc = torch.zeros_like(z)
            for i in range(3):
                for j in range(3):
                    acc = acc + (R[:, i, a] * R[:, j, b])[:, None] * L[i][j]
            Lc[a][b] = acc
    det = Lc[0][0] * Lc[1][1] - Lc[0][1] * Lc[1][0]
    fx, fy = focal[:, 0:1], focal[:, 1:2]
    col_x = ((fx * fx) * Lc[1][1] - (fy * fx) * Lc[1][0]) / det
    col_y = (((-fx) * fy) * Lc[0][1] + (fy * fy) * Lc[0][0]) / det
    nlt = -math.log(thr)
    return torch.sqrt(nlt * col_x) / z, torch.sqrt(nlt * col_y) / z


def supertile_window(c, r, fb: float, st):
    """Along one axis, the supertiles a Gaussian's bound ``c +- r`` (pixels)
    may be a member of: (first supertile (int32), their number (int32),
    finite (bool)).  ``fb`` is the bin size, ``st`` the supertile size as a
    tensor (a division by a tensor, see the module note)."""
    lo = (c - r - fb) / st
    hi = (c + r) / st
    fin = torch.isfinite(lo) & torch.isfinite(hi)
    f0 = torch.where(fin, torch.floor(torch.where(fin, lo, 0.0)), 0.0)
    f1 = torch.where(fin, torch.floor(torch.where(fin, hi, 0.0)), -2.0)
    f0i = torch.clip(f0, -2.0 ** 30, 2.0 ** 30).to(torch.int32)
    w = torch.clip(f1, -2.0 ** 30, 2.0 ** 30).to(torch.int32) - f0i + 1
    return f0i, w, fin


def supertile_bits(u, v, rx, ry, sxf, syf, fb: float, H: int, W: int):
    """Sub-bin membership bits (bit 2i + j: y sub-bin i, x sub-bin j) of a
    supertile with pixel origin (sxf, syf), int64."""
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


def pack_flags(flags):
    """(B, P) bool -> (B, ceil(P / 32)) int32 words, flag p in bit p % 32 of
    word p // 32 (the emission kernel's ballot)."""
    B, P = flags.shape
    nw = (P + 31) // 32
    f = torch.zeros((B, nw * 32), dtype=torch.int64, device=flags.device)
    f[:, :P] = flags
    sh = torch.arange(32, dtype=torch.int64, device=flags.device)
    words = (f.view(B, nw, 32) << sh).sum(-1)                  # [0, 2^32)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def unpack_flags(words, P: int):
    """Inverse of :func:`pack_flags`: (B, P) bool."""
    sh = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.long()[..., None] >> sh) & 1
    return bits.reshape(words.shape[0], -1)[:, :P].bool()


def emit_rows_plain(R, T, focal, principal, points, isigmas, thr: float,
                    bin_size: int, image_size, nst: int, BH2: int, BW2: int,
                    win: int):
    """Plain version of K1; same contract as :func:`emit_rows`."""
    B, P = points.shape[0], points.shape[1]
    H, W = int(image_size[0]), int(image_size[1])
    dev = points.device
    fb = float(bin_size)
    st = torch.tensor(2.0 * fb, dtype=torch.float32, device=dev)
    u, v, z = _camera_planes(R, T, focal, principal, points)
    rx, ry = _pixel_radii_planes(R, focal, isigmas, thr, z)
    keep = ~(z < 0)

    fx0, wx, finx = supertile_window(u, rx, fb, st)
    fy0, wy, finy = supertile_window(v, ry, fb, st)
    oversize = keep & (~finx | ~finy | (wx > win) | (wy > win))
    fits = oversize & finx & finy & (wx <= MAX_WIN) & (wy <= MAX_WIN)
    info = torch.zeros(INFO_LEN, dtype=torch.int32, device=dev)
    info[2] = torch.where(fits, torch.maximum(wx, wy), 0).max()

    lo_u, hi_u = u - rx, u + rx
    lo_v, hi_v = v - ry, v + ry
    fx0f, fy0f = fx0.to(torch.float32), fy0.to(torch.float32)
    xo, yo = [], []
    for m in range(2 * win):
        bx = (2.0 * fx0f + m) * fb
        xo.append((lo_u <= bx + fb) & (bx < hi_u) & (bx < W))
        by = (2.0 * fy0f + m) * fb
        yo.append((lo_v <= by + fb) & (by < hi_v) & (by < H))

    base_ok = keep & ~oversize
    img = torch.arange(B, device=dev, dtype=torch.int32)[:, None]
    rid, bits_out = [], []
    for e in range(win * win):
        cx, cy = e % win, e // win
        bits = torch.zeros((B, P), dtype=torch.int32, device=dev)
        for i in range(2):
            for j in range(2):
                t = (yo[2 * cy + i] & xo[2 * cx + j]).to(torch.int32)
                bits = bits | (t << (2 * i + j))
        sx, sy = fx0 + cx, fy0 + cy
        ok = base_ok & (sx >= 0) & (sx < BW2) & (sy >= 0) & (sy < BH2) & (bits != 0)
        rid.append(torch.where(ok, img * nst + sy * BW2 + sx, -1))
        bits_out.append(torch.where(ok, bits, 0))
    return (torch.stack(rid, dim=-1).to(torch.int32),
            torch.stack(bits_out, dim=-1).to(torch.uint8),
            torch.stack([u, v, rx, ry], dim=1), pack_flags(oversize), info)


def _aligned(t):
    """``t`` as contiguous float32 at a 16-byte aligned address: a copy only
    where it is not (a camera sliced out of a batch starts mid-way)."""
    t = t.to(torch.float32).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _emit_kernel():
    return bind("emit", "voge_emit_rows",
                [VOIDP] * 10 + [INT, INT, FLOAT, FLOAT] + [INT] * 7 + [VOIDP])


def emit_rows(R, T, focal, principal, points, isigmas, thr: float,
              bin_size: int, image_size, nst: int, BH2: int, BW2: int, win: int):
    """Per-Gaussian emission.

    :param R, T, focal, principal: (B,3,3), (B,3), (B,2), (B,2) cameras
    :param points: (B, P, 3) camera-centred means; :param isigmas: (B, P, 3, 3)
    :return: (rid (B, P, win^2) int32 row ``img * nst + st`` of each window
        cell, -1 for no member; bits (B, P, win^2) uint8 sub-bin bits, 0 for
        no member; planes (B, 4, P) float32 u, v, rx, ry; over (B,
        ceil(P / 32)) int32 oversize flag words (:func:`unpack_flags`); info
        (INFO_LEN,) int32: 0, 0, the widest window (<= ``MAX_WIN``) a finite
        oversize Gaussian needs (0 for none))
    """
    if not on_cuda(R, focal, principal, points, isigmas):
        return emit_rows_plain(R, T, focal, principal, points, isigmas, thr,
                               bin_size, image_size, nst, BH2, BW2, win)
    B, P = points.shape[0], points.shape[1]
    H, W = int(image_size[0]), int(image_size[1])
    f32 = torch.float32
    Rm = check(_aligned(R), "R", f32, (B, 3, 3))
    fo = check(_aligned(focal), "focal", f32, (B, 2))
    pp = check(_aligned(principal), "principal", f32, (B, 2))
    pts = check(_aligned(points), "points", f32, (B, P, 3))
    isg = check(_aligned(isigmas.reshape(B, P, 9)), "isigmas", f32)
    dev = points.device
    E = win * win
    rid = torch.empty((B, P, E), dtype=torch.int32, device=dev)
    bits = torch.empty((B, P, E), dtype=torch.uint8, device=dev)
    planes = torch.empty((B, 4, P), dtype=f32, device=dev)
    over = torch.empty((B, (P + 31) // 32), dtype=torch.int32, device=dev)
    info = torch.empty(INFO_LEN, dtype=torch.int32, device=dev)
    err = _emit_kernel()(
        ptr(Rm), ptr(fo), ptr(pp), ptr(pts), ptr(isg), ptr(rid), ptr(bits),
        ptr(planes), ptr(over), ptr(info), B, P, -math.log(thr), float(bin_size),
        H, W, BH2, BW2, nst, win, MAX_WIN, stream(dev),
    )
    raise_on_error(err, "emit_rows")
    emit_rows.launches += 1
    return rid, bits, planes, over, info


emit_rows.launches = 0


def coarse_globals_plain(over, planes, starts, info, n_globals: int, nst: int,
                         BW2: int, bin_size: int, image_size):
    """Plain version of :func:`coarse_globals`; same contract."""
    B, P = planes.shape[0], planes.shape[2]
    H, W = int(image_size[0]), int(image_size[1])
    ng = int(n_globals)
    dev = planes.device
    fb = float(bin_size)
    i64 = torch.int64
    oversize = unpack_flags(over, P)
    n_over = oversize.sum(1)
    rank = torch.cumsum(oversize.to(i64), 1) - 1
    gp = torch.zeros((B, ng + 1), dtype=i64, device=dev)      # column ng: a dump
    gp.scatter_(1, torch.where(oversize & (rank < ng), rank, ng),
                torch.arange(P, dtype=i64, device=dev).expand(B, P))
    n_g = n_over.clamp(max=ng)
    g_valid = torch.arange(ng, device=dev)[None] < n_g[:, None]
    gpos = torch.where(g_valid, gp[:, :ng], 0)
    ga = lambda x: x.gather(1, gpos)[..., None]
    u, v, rx, ry = planes.unbind(1)
    s_all = torch.arange(nst, device=dev, dtype=i64)
    bits = supertile_bits(ga(u), ga(v), ga(rx), ga(ry),
                          (s_all % BW2).to(torch.float32) * (2.0 * fb),
                          (s_all // BW2).to(torch.float32) * (2.0 * fb), fb, H, W)
    bits_g = torch.where(g_valid[..., None], bits, 0).to(torch.uint8)   # (B, ng, nst)
    g_over = (n_over - ng).clamp(min=0)
    counts_full = (starts[1:] - starts[:-1]).reshape(B, nst) + (bits_g != 0).sum(1)
    info[:2] = torch.maximum(info[:2], torch.stack([counts_full.max(), g_over.max()]).to(
        torch.int32))
    gstat = torch.stack([n_g, g_over], dim=1).to(torch.int32)
    return gpos.to(torch.int32), g_valid, bits_g, gstat


def _globals_kernel():
    return bind("emit", "voge_coarse_globals",
                [VOIDP] * 8 + [INT] * 4 + [FLOAT, INT, INT, INT, VOIDP])


def coarse_globals(over, planes, starts, info, n_globals: int, nst: int,
                   BW2: int, bin_size: int, image_size):
    """The global members of every image: its first ``n_globals`` oversize
    Gaussians by index.

    :param over, planes, info: from :func:`emit_rows`
    :param starts: (B * nst + 1,) int64 run starts of the emission's row ids
        (``cuda_attr.slot_runs``)
    :param n_globals: at most P
    :return: (gpos (B, ng) int32 Gaussian index, 0 past the image's members;
        g_valid (B, ng) bool; bits_g (B, ng, nst) uint8 each member's bits in
        each supertile, 0 for invalid; gstat (B, 2) int32: the image's global
        members and its excess oversize Gaussians (dropped)).  ``info[0]``
        becomes at least the densest row's count (local run + global members)
        and ``info[1]`` at least the most an image drops.
    """
    if not on_cuda(over, planes, starts, info):
        return coarse_globals_plain(over, planes, starts, info, n_globals, nst, BW2,
                                    bin_size, image_size)
    B, P = planes.shape[0], planes.shape[2]
    H, W = int(image_size[0]), int(image_size[1])
    ng = int(n_globals)
    if not 0 <= ng <= P:
        raise ValueError(f"n_globals: expected 0 to {P}, got {ng}")
    check(over, "over", torch.int32, (B, (P + 31) // 32))
    check(planes, "planes", torch.float32, (B, 4, P))
    check(starts, "starts", torch.int64, (B * nst + 1,))
    check(info, "info", torch.int32, (INFO_LEN,))
    dev = planes.device
    gpos = torch.empty((B, ng), dtype=torch.int32, device=dev)
    g_valid = torch.empty((B, ng), dtype=torch.uint8, device=dev)
    bits_g = torch.empty((B, ng, nst), dtype=torch.uint8, device=dev)
    gstat = torch.empty((B, 2), dtype=torch.int32, device=dev)
    err = _globals_kernel()(
        ptr(over), ptr(planes), ptr(starts), ptr(gpos), ptr(g_valid), ptr(bits_g),
        ptr(gstat), ptr(info), B, P, nst, BW2, float(bin_size), H, W, ng, stream(dev))
    raise_on_error(err, "coarse_globals")
    coarse_globals.launches += 1
    return gpos, g_valid.view(torch.bool), bits_g, gstat


coarse_globals.launches = 0


def coarse_rows_plain(order, starts, bits, gpos, bits_g, gstat, M: int, nst: int,
                      return_dst: bool = False):
    """Plain version of :func:`coarse_rows`; same contract."""
    B, P, E = bits.shape
    ng = gpos.shape[1]
    nb = B * nst
    dev = bits.device
    i64 = torch.int64
    # the local members: sorted position t holds window slot order[t]
    t = torch.arange(order.numel(), device=dev, dtype=i64)
    valid = t < starts[-1]
    row = (torch.searchsorted(starts, t, right=True) - 1).clamp(max=nb - 1)
    q = torch.where(valid, order.to(i64), 0)
    p = (q // E) % P
    # the global members of each row, by g: (B, nst, ng)
    bits_m = bits_g.transpose(1, 2)
    mem = (bits_m != 0) & (torch.arange(ng, device=dev)[None] < gstat[:, :1])[:, None, :]
    gp = gpos.to(i64)
    # merged by position: a local's rank adds the row's members below it, a
    # member's the row's locals below it
    rank_l = t - starts[row] + (mem.reshape(nb, ng)[row] & (gp[row // nst] < p[:, None])).sum(1)
    key_l = torch.where(valid, row * P + p, nb * P)            # ascending
    rr = torch.arange(nb, device=dev, dtype=i64).reshape(B, nst, 1)
    below = torch.searchsorted(key_l, (rr * P + gp[:, None, :]).reshape(-1)).reshape(B, nst, ng)
    rank_g = torch.cumsum(mem.to(i64), -1) - 1 + below - starts[:-1].reshape(B, nst, 1)

    counts_full = starts[1:] - starts[:-1] + mem.reshape(nb, ng).sum(1)
    counts_c = counts_full.clamp(max=M)
    first = torch.arange(nb, device=dev) % nst == 0
    overflow_c = counts_full - counts_c + torch.where(
        first, gstat[:, 1].to(i64).repeat_interleave(nst), 0)

    dump = nb * M
    at_l = torch.where(valid & (rank_l < M), row * M + rank_l, dump)
    at_g = torch.where(mem & (rank_g < M), rr * M + rank_g, dump).reshape(-1)
    gp_all = gp[:, None, :].expand(B, nst, ng).reshape(-1)
    img_l, img_g = (row // nst) * P, (rr // nst).expand(B, nst, ng).reshape(-1) * P
    outs = []
    for fill, v_l, v_g in ((0, p, gp_all), (0, bits.reshape(-1)[q].to(i64), bits_m.reshape(-1).to(i64)),
                           (-1, img_l + p, img_g + gp_all)):
        o = torch.full((dump + 1,), fill, dtype=i64, device=dev)
        o.scatter_(0, at_l, v_l)
        o.scatter_(0, at_g, v_g)
        outs.append(o[:dump].reshape(nb, M).to(torch.int32))
    out = (*outs, counts_c.to(torch.int32), overflow_c.to(torch.int32))
    if not return_dst:
        return out
    n_slots = B * P * E
    dst_l = torch.full((n_slots + 1,), -1, dtype=i64, device=dev)
    dst_l.scatter_(0, torch.where(valid, q, n_slots),
                   torch.where(rank_l < M, row * M + rank_l, -1))
    dst_g = torch.where(mem & (rank_g < M), rr * M + rank_g, -1).transpose(1, 2)
    return out + (dst_l[:n_slots].reshape(B, P, E).to(torch.int32),
                  dst_g.to(torch.int32).contiguous())


def _rows_kernel():
    return bind("emit", "voge_coarse_rows",
                [VOIDP] * 11 + [INT, VOIDP, VOIDP] + [INT] * 6 + [VOIDP])


def coarse_rows(order, starts, bits, gpos, bits_g, gstat, M: int, nst: int,
                return_dst: bool = False):
    """The candidate rows: each row's local run (ascending) merged with its
    global members (ascending), the first ``M`` kept.

    :param order, starts: ``cuda_attr.slot_runs`` of the emission's row ids
    :param bits: (B, P, E) uint8 from :func:`emit_rows`
    :param gpos, bits_g, gstat: from :func:`coarse_globals`
    :return: (pos_c (nb, M) int32 per-image Gaussian index (0 pad), bits_c
        (nb, M) int32 sub-bin bits (0 pad), ids_c (nb, M) int32 ``b * P + p``
        (-1 pad), counts_c (nb,) int32 ``min(full count, M)``, overflow_c
        (nb,) int32 members dropped, the image's excess globals charged to
        its first row); with ``return_dst`` also dst_l (B, P, E) and dst_g
        (B, ng, nst) int32: the slot ``row * M + rank`` of each local window
        cell and each global member's supertile, -1 when not a member or
        dropped.  nb = B * nst.
    """
    if not on_cuda(order, starts, bits, gpos, bits_g, gstat):
        return coarse_rows_plain(order, starts, bits, gpos, bits_g, gstat, M, nst,
                                 return_dst)
    B, P, E = bits.shape
    ng = gpos.shape[1]
    nb = B * nst
    if ng > MAX_GLOBALS:
        raise ValueError(f"n_globals: at most {MAX_GLOBALS} on the card, got {ng}")
    check(order, "order", torch.int32, (B * P * E,))
    check(starts, "starts", torch.int64, (nb + 1,))
    check(bits, "bits", torch.uint8)
    check(gpos, "gpos", torch.int32, (B, ng))
    check(bits_g, "bits_g", torch.uint8, (B, ng, nst))
    check(gstat, "gstat", torch.int32, (B, 2))
    dev = bits.device
    i32 = torch.int32
    pos_c, bits_c, ids_c = (torch.empty((nb, M), dtype=i32, device=dev) for _ in range(3))
    counts_c, overflow_c = (torch.empty(nb, dtype=i32, device=dev) for _ in range(2))
    dst_l = torch.empty((B, P, E), dtype=i32, device=dev) if return_dst else None
    dst_g = torch.empty((B, ng, nst), dtype=i32, device=dev) if return_dst else None
    err = _rows_kernel()(
        ptr(order), ptr(starts), ptr(bits), ptr(gpos), ptr(bits_g), ptr(gstat),
        ptr(pos_c), ptr(bits_c), ptr(ids_c), ptr(counts_c), ptr(overflow_c),
        int(return_dst), ptr(dst_l), ptr(dst_g), B, P, E, nst, ng, int(M), stream(dev))
    raise_on_error(err, "coarse_rows")
    coarse_rows.launches += 1
    out = (pos_c, bits_c, ids_c, counts_c, overflow_c)
    return out + (dst_l, dst_g) if return_dst else out


coarse_rows.launches = 0
