"""K1: coarse emission (``csrc/emit.cu``) and its plain PyTorch version.

Replaces ``voge_tpu/ops/pallas_coarse.py::_emit_kernel``.  Per Gaussian:
project the centre to (u, v, z), bound the thr-level ellipse in pixels
(rx, ry), pick the win x win supertile window, set the four sub-bin
membership bits per window cell and pack the int64 sort key
``((img * nst + st) * S + idx) * 16 + bits`` (sentinel ``nb * S * 16``).

Bound on the H100: launch latency; ~1 MB of traffic at 10K Gaussians.
Design: one thread per Gaussian, compiled with ``-fmad=false`` and written in
the Pallas kernel's operation order, so its keys and aux planes equal
:func:`emit_keys_plain`'s bit for bit.  The plain version divides by tensors,
never by Python scalars, because PyTorch's CUDA division by a scalar
multiplies by its reciprocal.
"""
from __future__ import annotations

import math

import torch

from voge_tpu_torch._build import load
from voge_tpu_torch.ops._dispatch import (
    FLOAT, INT, LONG, VOIDP, check, on_cuda, ptr, raise_on_error, stream,
)


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


def emit_keys_plain(R, T, focal, principal, points, isigmas, thr: float,
                    bin_size: int, image_size, nst: int, BH2: int, BW2: int,
                    S: int, win: int):
    """Plain version of K1; same contract as :func:`emit_keys`."""
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
    img = torch.arange(B, device=dev, dtype=torch.int64)[:, None]
    idx = torch.arange(P, device=dev, dtype=torch.int64)[None, :]
    big = B * nst * S * 16
    keys = []
    for e in range(win * win):
        cx, cy = e % win, e // win
        bits = torch.zeros((B, P), dtype=torch.int64, device=dev)
        for i in range(2):
            for j in range(2):
                t = (yo[2 * cy + i] & xo[2 * cx + j]).to(torch.int64)
                bits = bits | (t << (2 * i + j))
        sx = (fx0 + cx).to(torch.int64)
        sy = (fy0 + cy).to(torch.int64)
        ok = base_ok & (sx >= 0) & (sx < BW2) & (sy >= 0) & (sy < BH2) & (bits != 0)
        key = ((img * nst + sy * BW2 + sx) * S + idx) * 16 + bits
        keys.append(torch.where(ok, key, torch.full_like(key, big)))
    return torch.stack(keys, dim=-1), u, v, rx, ry, z, oversize


def _kernel():
    fn = load("emit").voge_emit_keys
    fn.argtypes = [VOIDP] * 5 + [INT, INT, FLOAT, FLOAT] + [INT] * 5 + [
        LONG, LONG, INT, VOIDP]
    fn.restype = INT
    return fn


def emit_keys(R, T, focal, principal, points, isigmas, thr: float,
              bin_size: int, image_size, nst: int, BH2: int, BW2: int, S: int,
              win: int):
    """Per-Gaussian emission.

    :param R, T, focal, principal: (B,3,3), (B,3), (B,2), (B,2) cameras
    :param points: (B, P, 3) camera-centred means; :param isigmas: (B, P, 3, 3)
    :return: (keys (B, P, win^2) int64, u, v, rx, ry, z (B, P) float32,
        oversize (B, P) bool)
    """
    if not on_cuda(R, focal, principal, points, isigmas):
        return emit_keys_plain(R, T, focal, principal, points, isigmas, thr,
                               bin_size, image_size, nst, BH2, BW2, S, win)
    B, P = points.shape[0], points.shape[1]
    H, W = int(image_size[0]), int(image_size[1])
    f32 = torch.float32
    cam = torch.cat([R.reshape(B, 9), focal, principal], dim=1).to(f32).contiguous()
    pts = check(points.to(f32).contiguous(), "points", f32, (B, P, 3))
    isg = check(isigmas.to(f32).reshape(B, P, 9).contiguous(), "isigmas", f32)
    check(cam, "cameras", f32, (B, 13))
    keys = torch.empty((B, P, win * win), dtype=torch.int64, device=points.device)
    aux = torch.empty((B, 6, P), dtype=f32, device=points.device)
    big = B * nst * S * 16
    err = _kernel()(
        ptr(cam), ptr(pts), ptr(isg), ptr(keys), ptr(aux), B, P,
        -math.log(thr), float(bin_size), H, W, BH2, BW2, nst, S, big, win,
        stream(points.device),
    )
    raise_on_error(err, "emit_keys")
    emit_keys.launches += 1
    u, v, rx, ry, z, ovf = aux.unbind(1)
    return keys, u, v, rx, ry, z, ovf > 0.5


emit_keys.launches = 0
