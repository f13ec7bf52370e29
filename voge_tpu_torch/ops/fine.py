"""Fine stage: the forward of the emission-compacted ray tracing
(counterpart of the compacted branch of ``voge_tpu.ops.fine.ray_tracing``,
``fine.py:1366-1455``, and of ``_rt_fine_compact_impl``, ``fine.py:969-1031``).

Every render takes this one path: K1 emits the per-supertile candidate rows
(``ops.coarse.emit_supertile_candidates``), the Gaussian feature rows are
gathered into a per-supertile table, and K2 selects, weights and (given
attributes) composites in one kernel.  Unlike ``voge_tpu`` on a TPU, the rows
are sized from the counts the sort produces, so no member is dropped for
capacity.  The no-coarse setting (``max_points_per_bin == -1``) and K above
128 are not ported yet and raise.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from voge_tpu_torch.ops.coarse import (
    coarse_bin_config,
    emit_supertile_candidates,
    supertile_grid,
)
from voge_tpu_torch.ops.cuda_fine import MAX_K, FineSelect


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pick_cand_chunk(P: int) -> int:
    """Candidate chunk width of ``voge_tpu``'s select kernel; here the
    granularity the candidate rows are rounded up to."""
    return 128 if P <= 4096 else 256


def _pick_m_max(P_pad: int, bins_per_image: int, cand_chunk: int,
                m_min: int = 0) -> int:
    """``voge_tpu``'s static per-supertile capacity heuristic: ~8x the mean
    Gaussians per supertile, at least 256, at most all of them; a user
    ``max_point_per_bin`` (in per-supertile units) acts as a floor, clamped
    to keep the compacted path viable."""
    target = max(256, 8 * P_pad // max(bins_per_image, 1))
    if m_min > 0:
        viable = ((P_pad - 1) // 2) // cand_chunk * cand_chunk
        if target < viable:
            m_min = min(int(m_min), viable)
        target = max(target, int(m_min))
    return min(P_pad, _ceil_to(target, cand_chunk))


def production_bin_geometry(image_size, n_assign: int, n_points: int,
                            bin_size: Optional[int],
                            max_points_per_bin: Optional[int]):
    """(bin_size, max_points_per_bin) a render uses: the reference
    heuristics (``voge_tpu``'s TPU-only geometry is not ported)."""
    return coarse_bin_config(image_size, n_assign, n_points, bin_size,
                             max_points_per_bin)


def _gauss_feature_planes_batched(mus: torch.Tensor, isigmas: torch.Tensor):
    """(B, P, 3) / (B, P, 3, 3) -> (B, 16, P) feature planes
    [A0, A1, A2, msm, L00..L22, mu0, mu1, mu2] with A = Lambda^T mu and
    msm = mu^T Lambda mu."""
    mu = [mus[..., d] for d in range(3)]
    L = [[isigmas[..., i, j] for j in range(3)] for i in range(3)]
    A = [L[0][i] * mu[0] + L[1][i] * mu[1] + L[2][i] * mu[2] for i in range(3)]
    msm = mu[0] * A[0] + mu[1] * A[1] + mu[2] * A[2]
    cols = A + [msm] + [L[i][j] for i in range(3) for j in range(3)] + mu
    return torch.stack(cols, dim=1)


class Candidates(NamedTuple):
    """What the select kernel takes besides rays and attributes."""
    table_c: torch.Tensor     # (nb, M, 16) feature rows per supertile
    bits_c: torch.Tensor      # (nb, M) int32 sub-bin bits
    ids_c: torch.Tensor       # (nb, M) int32 flattened ids, -1 pad
    counts_c: torch.Tensor    # (nb,) int32 occupied rows
    overflow_c: torch.Tensor  # (nb,) int32 members dropped
    bin_size: int
    thr_act: float


def compact_candidates(R, T, focal, principal, points: torch.Tensor,
                       isigmas: torch.Tensor, image_size, thr: float,
                       n_assign: int, bin_size: Optional[int] = None,
                       max_points_per_bin: Optional[int] = None) -> Candidates:
    """Coarse stage plus the feature-row gather: the per-supertile
    candidate table of camera-centred ``points`` (B, P, 3) with precisions
    ``isigmas`` (B, P, 3, 3).  Differentiable in the table."""
    B, P = points.shape[0], points.shape[1]
    H, W = int(image_size[0]), int(image_size[1])
    bs, mppb = production_bin_geometry((H, W), n_assign, P, bin_size,
                                       max_points_per_bin)
    if mppb == -1:
        raise NotImplementedError(
            "max_point_per_bin=-1 (no coarse culling) is not ported yet: "
            "ROADMAP queue 1, item 8 (small-scene and no-coarse paths)")
    if n_assign > MAX_K:
        raise NotImplementedError(
            f"max_assign={n_assign} > {MAX_K} is not ported yet: ROADMAP "
            "queue 1, item 8 (dense large-K dispatch)")
    BH2, BW2 = supertile_grid(H, W, bs)
    nst = BH2 * BW2
    cc = _pick_cand_chunk(P)
    # voge_tpu's padded Gaussian count (its chunk widths' lcm, 1024)
    P_pad = _ceil_to(max(P, 1024), 1024)
    m_min = mppb if (max_points_per_bin is not None and max_points_per_bin > 0) else 0
    M_floor = _pick_m_max(P_pad, nst, cc, 4 * m_min)
    pos_c, bits_c, ids_c, counts_c, overflow_c = emit_supertile_candidates(
        R, T, focal, principal, points, isigmas, (H, W), thr, bs, M_floor,
        row_align=cc,
    )
    feat = _gauss_feature_planes_batched(points, isigmas)       # (B, 16, P)
    table = feat.transpose(1, 2).reshape(B * P, 16)
    img_row = torch.arange(B * nst, device=points.device)[:, None] // nst
    table_c = table[(img_row * P + pos_c).reshape(-1)].reshape(
        B * nst, pos_c.shape[1], 16)
    return Candidates(table_c.contiguous(), bits_c, ids_c, counts_c,
                      overflow_c, bs, -math.log(thr + 1.0 / 1e10))


def ray_tracing(cameras_or_params, points: torch.Tensor, isigmas: torch.Tensor,
                rays: torch.Tensor, image_size, thr: float, n_assign: int,
                bin_size: Optional[int] = None,
                max_points_per_bin: Optional[int] = None,
                agg_ow: float = 1.0, attrs: Optional[torch.Tensor] = None):
    """Coarse + fine forward (reference ``RayTracing.py:12-30``).

    :param cameras_or_params: a ``PerspectiveCameras`` or ``(R, T, focal,
        principal)``
    :param points: (B, P, 3) camera-centred means; :param isigmas: (B, P, 3, 3)
    :param rays: (B, H, W, 3)
    :param agg_ow: occupation weight of the fused erf compositing
    :param attrs: optional (B, P, d) attributes composited in the same kernel
    :return: ((idx, len, act, dsd, w, img or None) in image layout
        (B, H, W, K) / (B, H, W, d), overflow_points (scalar int32 tensor))
    """
    if isinstance(cameras_or_params, tuple):
        cams = cameras_or_params
    else:
        cams = cameras_or_params.batched_params(points.shape[0])
    c = compact_candidates(*cams, points, isigmas, image_size, thr, n_assign,
                           bin_size, max_points_per_bin)
    attr_rows = None
    if attrs is not None:
        attr_rows = attrs.to(torch.float32).reshape(
            points.shape[0] * points.shape[1], -1).contiguous()
    sel = FineSelect.apply(
        c.table_c, rays.contiguous(), attr_rows, c.bits_c, c.ids_c,
        c.counts_c, float(c.thr_act), int(n_assign), c.bin_size, float(agg_ow),
    )
    if attrs is None:
        sel = tuple(sel) + (None,)
    return tuple(sel), c.overflow_c.sum().to(torch.int32)
