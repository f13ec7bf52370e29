"""Fine stage: the ray tracing and its backward, counterpart of
``voge_tpu.ops.fine``: :func:`ray_tracing` on two paths, and the public
two-stage tracer's second stage :func:`ray_tracing_fine`.

- Emission-compacted (every ``max_points_per_bin`` but -1; the compacted
  branch, ``fine.py:1366-1455``, and the ``_rt_fine_kern_c`` custom VJP,
  ``fine.py:969-1151``): K1 emits the per-supertile candidate rows
  (``ops.coarse.emit_supertile_candidates``), the
  Gaussian feature rows are gathered into a per-supertile table, and K2
  selects, weights and (given attributes) composites in one kernel.  The
  backward runs K3, whose rows are the Gaussians (a slot's id is its row of
  the feature table), so nothing is gathered back through the inverse
  emission map.  Unlike ``voge_tpu`` on a TPU, the rows are sized from the
  counts the sort produces, so no member is dropped for capacity.
- Global, no coarse stage (``max_points_per_bin == -1``; the mask branch,
  ``fine.py:1303-1338``, and the ``_rt_fine_kern`` custom VJP,
  ``fine.py:695-966``): no K1 and no sort; every Gaussian of an image is a
  candidate of every pixel, in ascending index (``voge_tpu``'s CPU
  candidate order, so ties break the same way; the TPU path's culling mask,
  whose bound is not proven conservative, is not copied).  K2's global entry
  reads the (B * P, 16) feature table in place and skips, block by block,
  only the Gaussians a cone bound proves no ray of the block can pass
  (``ops.cuda_fine.cull_rows`` / ``block_cones``; the proof is in
  ``csrc/fine_select.cu``), so its results are those of testing every pair;
  K3's global entry sums each Gaussian's gradient over its slots, and
  attributes go through the attribute merge (K3f / K4b).  Nothing is
  truncated and ``overflow_points`` is 0.

- Two-stage (``ops.coarse.rasterize_coarse`` then :func:`ray_tracing_fine`,
  reference ``RayTracing.py:76-95``; ``fine.py:1158-1182``, the chain
  ``voge_tpu.ops.fine.ray_tracing`` itself takes off the TPU): the caller
  brings per-bin candidate lists, K2's per-bin-list entry selects from them
  (no weights: the function returns idx, len, act, dsd), and the backward is
  K3's global entry, since the selected ids are rows of the flat feature
  table (``voge_tpu``'s is an XLA ``segment_sum``, a float atomic scatter on
  CUDA).

The backward over the global space (the no-coarse path and the two-stage
tracer) is :func:`global_backward`: K3's global entry, or for a frozen scene
the per-ray half alone (``fine_bwd_rays``: one launch of K3's per-slot
kernel, the fold fused in).  The compacted path's backward
(``FineSelect``) takes the same route for a scene that needs no gradient:
given the camera centres apart (``ray_tracing(origins=)``, as the renderer
passes them), their gradient comes from the per-ray sums of that launch, so
pose refinement groups no slots and sums no per-Gaussian rows.

- Dense (``max_assign`` above the select kernel's ``MAX_K`` = 128):
  :func:`ops.dense_select.ray_tracing_dense` in float32, the port of
  ``voge_tpu``'s XLA route (``fine.py:1334-1365``, which it takes above its
  kernels' K): ``rasterize_coarse``'s per-bin lists, or one whole-image bin
  without a coarse stage, a dense select in PyTorch ops and its closed-form
  backward.  It is chosen by K alone; no render at K <= 128 takes it.

All backward paths are free of float atomics, so gradients repeat to the
bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from voge_tpu_torch import trace
from voge_tpu_torch.ops.coarse import (
    coarse_bin_config,
    emit_supertile_candidates,
    supertile_grid,
)
from voge_tpu_torch.ops.cuda_attr import AttrMerge
from voge_tpu_torch.ops.cuda_fine import (
    FEAT, MAX_K, fine_select, fine_select_bins, fine_select_global,
)
from voge_tpu_torch.ops.cuda_fine_bwd import fine_bwd, fine_bwd_global, fine_bwd_rays
from voge_tpu_torch.ops.dense_select import (
    DenseFineSelect, _gauss_feature_cols, ray_tracing_dense,
)

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


def _check_k(n_assign: int):
    if n_assign > MAX_K:
        raise NotImplementedError(
            f"max_assign={n_assign} > {MAX_K}: the compacted candidates feed the "
            "select kernel, which takes K <= 128; ray_tracing serves larger K by "
            "its dense route")


def takes_dense_route(n_assign: int) -> bool:
    """The dense route serves K above the select kernel's ``MAX_K``; every
    other render takes the kernels."""
    return int(n_assign) > MAX_K


class Candidates(NamedTuple):
    """The coarse stage's output: what the select kernel takes besides rays,
    features and attributes."""
    pos_c: torch.Tensor       # (nb, M) int32 per-image Gaussian index
    bits_c: torch.Tensor      # (nb, M) int32 sub-bin bits
    ids_c: torch.Tensor       # (nb, M) int32 flattened ids, ascending, -1 pad
    counts_c: torch.Tensor    # (nb,) int32 occupied rows
    overflow_c: torch.Tensor  # (nb,) int32 members dropped
    bin_size: int
    thr_act: float


def compact_candidates(R, T, focal, principal, points: torch.Tensor,
                       isigmas: torch.Tensor, image_size, thr: float,
                       n_assign: int, bin_size: Optional[int] = None,
                       max_points_per_bin: Optional[int] = None) -> Candidates:
    """Coarse stage: the per-supertile candidate rows of camera-centred
    ``points`` (B, P, 3) with precisions ``isigmas`` (B, P, 3, 3).  Discrete,
    so not differentiable."""
    with trace.span("voge.coarse"):
        B, P = points.shape[0], points.shape[1]
        H, W = int(image_size[0]), int(image_size[1])
        bs, mppb = production_bin_geometry((H, W), n_assign, P, bin_size,
                                           max_points_per_bin)
        if mppb == -1:
            raise ValueError("max_point_per_bin=-1 has no coarse stage: ray_tracing "
                             "serves it over the global candidate space")
        _check_k(n_assign)
        BH2, BW2 = supertile_grid(H, W, bs)
        nst = BH2 * BW2
        cc = _pick_cand_chunk(P)
        # Rows are sized from the sorted counts: the densest supertile rounded up
        # to ``cc``.  ``voge_tpu``'s static capacity heuristic stays a floor only
        # where the caller asked for a capacity (a positive ``max_point_per_bin``).
        M_floor = 0
        if max_points_per_bin is not None and max_points_per_bin > 0:
            # voge_tpu's padded Gaussian count (its chunk widths' lcm, 1024)
            P_pad = _ceil_to(max(P, 1024), 1024)
            M_floor = _pick_m_max(P_pad, nst, cc, 4 * mppb)
        rows = emit_supertile_candidates(R, T, focal, principal, points, isigmas,
                                         (H, W), thr, bs, M_floor, row_align=cc)
        c = Candidates(*rows, bs, -math.log(thr + 1.0 / 1e10))
        trace.count("coarse.slots", c.pos_c.numel())
        trace.count_device("coarse.members", c.counts_c)
        trace.count_device("coarse.overflow", c.overflow_c)
        return c


@torch.no_grad()
def feature_table(points: torch.Tensor, isigmas: torch.Tensor) -> torch.Tensor:
    """(B * P, 16) feature rows of camera-centred ``points`` (B, P, 3) with
    precisions ``isigmas`` (B, P, 3, 3), row ``b * P + n``; built without
    autograd (the backward kernels return the rows' gradients)."""
    with trace.span("voge.select.table"):
        return _gauss_feature_cols(points.reshape(-1, 3), isigmas.reshape(-1, 3, 3)).contiguous()


@torch.no_grad()
def candidate_table(points: torch.Tensor, isigmas: torch.Tensor,
                    pos_c: torch.Tensor) -> torch.Tensor:
    """(nb, M, 16) feature rows of every supertile's candidates (``pos_c``
    gathers them per image).  Built without autograd: the backward returns
    the Gaussians' gradients directly, never through the gather (whose
    backward would be a float atomic scatter on CUDA)."""
    return _gather_candidates(feature_table(points, isigmas), pos_c, points.shape[0])


def _gather_candidates(table: torch.Tensor, pos_c: torch.Tensor, B: int) -> torch.Tensor:
    """(nb, M, 16) rows of the (B * P, 16) ``table`` that ``pos_c`` names."""
    with trace.span("voge.select.gather"):
        nb, M = pos_c.shape
        P = table.shape[0] // B
        img_row = torch.arange(nb, device=table.device)[:, None] // (nb // B)
        return table[(img_row * P + pos_c).reshape(-1)].reshape(nb, M, FEAT).contiguous()


def gather_back_rows(rows: torch.Tensor, dst) -> torch.Tensor:
    """Per-Gaussian sums of per-slot rows through the inverse emission map
    (counterpart of ``voge_tpu.ops.pallas_attr.gather_back_rows``).  No
    main path takes it: K3's rows are the Gaussians already.

    :param rows: (nb * M, C) per-slot rows
    :param dst: ``(dst_l (B, P, E), dst_g (B, ng, nst), gpos (B, ng),
        g_valid (B, ng))`` from ``emit_supertile_candidates(return_dst=True)``
    :return: (B, P, C): each Gaussian's <= E window slots summed in window
        order, plus, for global members, their per-supertile slots summed in
        supertile order.  Missing slots read a zero dump row, invalid global
        entries write to a dump Gaussian: integer gathers and a scatter to
        distinct slots, no float atomics.
    """
    dst_l, dst_g, gpos, g_valid = dst
    B, P, E = dst_l.shape
    C = rows.shape[1]
    dump = rows.shape[0]
    rows = torch.cat([rows, rows.new_zeros((1, C))])
    src = torch.where(dst_l >= 0, dst_l, dump).long().reshape(-1)
    gg = rows[src].reshape(B, P, E, C).sum(2)
    ng = dst_g.shape[1]
    if ng:
        src_g = torch.where(dst_g >= 0, dst_g, dump).long().reshape(-1)
        gst = rows[src_g].reshape(B, ng, -1, C).sum(2)
        gst = torch.where(g_valid[..., None], gst, 0.0)
        at = torch.where(g_valid, gpos.long(), P)[..., None].expand(B, ng, C)
        gg = torch.cat([gg, gg.new_zeros((B, 1, C))], dim=1)
        gg = gg.scatter(1, at, gg.gather(1, at) + gst)[:, :P]
    return gg


class FineSelect(torch.autograd.Function):
    """The select (K2) as an autograd node, counterpart of ``voge_tpu``'s
    ``_rt_fine_kern_c`` custom VJP.  Differentiable inputs: ``points``
    (B, P, 3), ``isigmas`` (B, P, 3, 3), ``rays`` (B, H, W, 3), ``attrs``
    (B, P, d) or None, and ``origins`` (B, 3) or None: camera centres that
    ``points`` were centred on outside autograd, whose gradient is minus the
    sum of the points' gradient over each image; ``cand`` is the coarse
    stage's output.  The forward builds the (B * P, 16) feature table and
    gathers the candidate rows from it under no autograd, and runs K2.  The
    backward runs K3 on the saved table, whose per-Gaussian rows are the
    gradients, when the points, the precisions or the attributes need one;
    else (a frozen scene) K3's per-ray half alone, one launch with the fold
    fused, and nothing at all when nothing needs a gradient.  The origins'
    gradient is summed per ray in K3's per-slot kernel on either route, so
    it has the same bits on both.  The ray gradient (and its reduction) is
    skipped when ``camera_grad`` is False or the rays need no gradient."""

    @staticmethod
    def forward(ctx, points, isigmas, rays, attrs, origins, cand, K, agg_ow, camera_grad):
        with trace.span("voge.select"):
            table = feature_table(points, isigmas)
            table_c = _gather_candidates(table, cand.pos_c, points.shape[0])
            attr_rows = None
            if attrs is not None:
                attr_rows = attrs.to(torch.float32).reshape(-1, attrs.shape[-1]).contiguous()
            out = fine_select(rays, table_c, cand.bits_c, cand.ids_c, cand.counts_c,
                              cand.thr_act, K, cand.bin_size, agg_ow, attr_rows)
            ctx.mark_non_differentiable(out[0])
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(rays, table, attr_rows, *out[:5])
            ctx.agg_ow, ctx.camera_grad = agg_ow, camera_grad
            ctx.attrs_shape = None if attrs is None else attrs.shape
            return out if attrs is not None else out[:5]

    @staticmethod
    def backward(ctx, _g_idx, g_len, g_act, g_dsd, g_w, g_img=None):
        with trace.span("voge.fine_bwd"):
            rays, table, attr_rows, idx, length, act, dsd, w = ctx.saved_tensors
            needs = ctx.needs_input_grad
            want_rays = bool(ctx.camera_grad) and needs[2]
            want_origins = needs[4]
            if g_img is None:
                attr_rows = None
            want_attrs = attr_rows is not None and needs[3]
            cont = lambda g: None if g is None else g.contiguous()
            grads = (cont(g_len), cont(g_act), cont(g_dsd), cont(g_w))
            g_img = cont(g_img)
            rows = g_rays = g_mu = None
            if needs[0] or needs[1] or want_attrs:
                out = fine_bwd(rays, table, idx, length, act, dsd, w, *grads, ctx.agg_ow,
                               attr_rows, g_img, want_rays, return_mu=want_origins)
                rows, g_rays = out[:2]
                g_mu = out[2] if want_origins else None
            elif want_rays or want_origins:
                g_rays, g_mu = fine_bwd_rays(
                    rays, table, idx, length, dsd, *grads[:3], act=act, w=w, g_w=grads[3],
                    agg_ow=ctx.agg_ow, attrs=attr_rows, g_img=g_img, return_mu=True)
                g_rays = g_rays if want_rays else None
            B = rays.shape[0]
            g_points = g_isigmas = g_attrs = g_origins = None
            if rows is not None:
                rows = rows.reshape(B, -1, rows.shape[-1])
                g_points, g_isigmas = rows[..., 0:3], rows[..., 3:12].reshape(B, -1, 3, 3)
                if want_attrs:
                    g_attrs = rows[..., 12:].reshape(ctx.attrs_shape)
            if want_origins:
                g_origins = -g_mu.reshape(B, -1, 3).sum(1)
            return (g_points, g_isigmas, g_rays, g_attrs, g_origins, None, None, None, None)


def global_backward(rays, table, idx, length, act, dsd, w, g_len, g_act, g_dsd,
                    g_w, agg_ow: float, want_scene: bool, want_rays: bool):
    """Backward of a select over the global space, from its saved outputs
    (idx, len, act, dsd, w), each (B, H, W, K), and their cotangents (None
    for zero; ``w`` and ``g_w`` are None where the select has no weights).

    - The scene needs a gradient: K3's unified entry ``fine_bwd_global``
      (the fold fused in, skipped without a weight cotangent), at every
      size.  ``voge_tpu`` splits the backward past 262,144 Gaussians an
      image (``fine.py:912-931``: the unified kernel's output block outgrows
      a TPU's VMEM); the card has no such limit, and on it the unified entry
      was as fast as or faster than the fold's entry followed by the two
      halves, with equal bits, at the 300K cloud, the ShapeFitting and the
      two-stage shapes (PERF.md section 6).
    - A frozen scene (``want_scene`` False: only the rays need a
      gradient): the per-ray half ``fine_bwd_rays``, one launch that folds
      ``g_w`` into the cotangents of len / act / dsd and sums the ray
      gradient; no grouping of the slot ids.

    :return: (rows (B * P, 12) per Gaussian: grad mu (3), grad Lambda (9),
        or None when ``want_scene`` is False; g_rays (B, H, W, 3) or None)
    """
    with trace.span("voge.fine_bwd"):
        cont = lambda g: None if g is None else g.contiguous()
        g_len, g_act, g_dsd, g_w = (cont(g) for g in (g_len, g_act, g_dsd, g_w))
        if want_scene:
            return fine_bwd_global(rays, table, idx, length, act, dsd, w, g_len, g_act,
                                   g_dsd, g_w, agg_ow, want_rays)
        if not want_rays:
            return None, None
        return None, fine_bwd_rays(rays, table, idx, length, dsd, g_len, g_act, g_dsd,
                                   act=act, w=w, g_w=g_w, agg_ow=agg_ow)


class FineSelectGlobal(torch.autograd.Function):
    """K2's global entry as an autograd node, counterpart of ``voge_tpu``'s
    ``_rt_fine_kern`` custom VJP on the no-coarse path.  Differentiable
    inputs: ``points`` (B, P, 3), ``isigmas`` (B, P, 3, 3) and ``rays``
    (B, H, W, 3).  The forward builds the (B * P, 16) feature table under no
    autograd and runs the select over every Gaussian of each image; the
    backward is :func:`global_backward`, whose per-Gaussian rows are the
    gradients: no gather stays under autograd (its backward would be a
    float atomic scatter on CUDA).  The ray gradient is skipped when
    ``camera_grad`` is False or the rays need no gradient."""

    @staticmethod
    def forward(ctx, points, isigmas, rays, thr_act, K, bin_size, agg_ow, camera_grad):
        with trace.span("voge.select"):
            table = feature_table(points, isigmas)
            out = fine_select_global(rays, table, None, thr_act, K, bin_size, agg_ow)
            ctx.mark_non_differentiable(out[0])
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(rays, table, *out)
            ctx.agg_ow, ctx.camera_grad = agg_ow, camera_grad
            return out

    @staticmethod
    def backward(ctx, _g_idx, g_len, g_act, g_dsd, g_w):
        rays, table, idx, length, act, dsd, w = ctx.saved_tensors
        want_rays = bool(ctx.camera_grad) and ctx.needs_input_grad[2]
        want_scene = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        rows, g_rays = global_backward(
            rays, table, idx, length, act, dsd, w, g_len, g_act, g_dsd, g_w,
            ctx.agg_ow, want_scene, want_rays)
        g_points = g_isigmas = None
        if rows is not None:
            B = rays.shape[0]
            rows = rows.reshape(B, -1, 12)
            g_points, g_isigmas = rows[..., 0:3], rows[..., 3:12].reshape(B, -1, 3, 3)
        return g_points, g_isigmas, g_rays, None, None, None, None, None


class RayTraceFine(torch.autograd.Function):
    """K2's per-bin-list entry as an autograd node, counterpart of
    ``voge_tpu``'s ``_ray_trace_fine`` custom VJP.  Differentiable inputs:
    ``mus`` (P, 3), ``isigmas`` (P, 3, 3), both flattened over the batch, and
    ``rays`` (B, H, W, 3).  The forward builds the (P, 16) feature table
    under no autograd and selects from the bins' lists; the backward is
    :func:`global_backward` on the cotangents of len, act and dsd (there are
    no weights here, so no weight cotangent), whose per-Gaussian rows are the
    gradients."""

    @staticmethod
    def forward(ctx, mus, isigmas, rays, bin_points, thr_act, bin_size, K):
        with trace.span("voge.select"):
            table = feature_table(mus[None], isigmas[None])
            out = fine_select_bins(rays, table, bin_points, thr_act, K, bin_size)
            ctx.mark_non_differentiable(out[0])
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(rays, table, *out)
            return out

    @staticmethod
    def backward(ctx, _g_idx, g_len, g_act, g_dsd):
        rays, table, idx, length, act, dsd = ctx.saved_tensors
        want_scene = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        rows, g_rays = global_backward(
            rays, table, idx, length, act, dsd, None, g_len, g_act, g_dsd, None,
            1.0, want_scene, ctx.needs_input_grad[2])
        g_mus = g_isigmas = None
        if rows is not None:
            g_mus, g_isigmas = rows[:, 0:3], rows[:, 3:12].reshape(-1, 3, 3)
        return g_mus, g_isigmas, g_rays, None, None, None, None


def ray_tracing_fine(mus: torch.Tensor, isigmas: torch.Tensor,
                     rays: torch.Tensor, bin_points: torch.Tensor, thr: float,
                     bin_size: Union[int, Tuple[int, int]], n_assign: int,
                     inf: float = 1e10):
    """Binned fine ray tracing (reference ``RayTracing.py:76-95``), the
    second stage after ``ops.coarse.rasterize_coarse``; differentiable in
    ``mus``, ``isigmas`` and ``rays``.  All tensors share one device.

    :param mus: (P, 3) camera-centred means, flattened over the batch
    :param isigmas: (P, 3, 3)
    :param rays: (B, H, W, 3) unit world directions
    :param bin_points: (B, BH, BW, M) int32 candidate indices into the
        flattened Gaussian axis, -1 padded; earlier entries win ties
    :param thr: activation threshold (``thr_act = -log(thr + 1/inf)``)
    :param bin_size: pixels a bin spans, an int or (height, width)
    :return: (sel_idx int32, sel_len, sel_act, sel_dsd), each (B, H, W, K);
        empty slots hold idx -1, len / act 1e10, dsd 0.  Computed in
        float32; above K = 128 by the dense select
    """
    assert isigmas.ndim == 3 and mus.ndim == 2
    assert rays.ndim == 4 and bin_points.ndim == 4
    assert mus.shape[0] == isigmas.shape[0] and mus.shape[1] == 3
    thr_act = -math.log(thr + 1.0 / inf)
    if isinstance(bin_size, int):
        bin_size = (bin_size, bin_size)
    f32 = torch.float32
    route = DenseFineSelect if takes_dense_route(n_assign) else RayTraceFine
    return route.apply(
        mus.to(f32), isigmas.to(f32), rays.to(f32).contiguous(),
        bin_points.to(torch.int32).contiguous(), float(thr_act),
        (int(bin_size[0]), int(bin_size[1])), int(n_assign))


def ray_tracing(cameras_or_params, points: torch.Tensor, isigmas: torch.Tensor,
                rays: torch.Tensor, image_size, thr: float, n_assign: int,
                bin_size: Optional[int] = None,
                max_points_per_bin: Optional[int] = None,
                agg_ow: float = 1.0, attrs: Optional[torch.Tensor] = None,
                camera_grad: bool = True, origins: Optional[torch.Tensor] = None):
    """Coarse + fine (reference ``RayTracing.py:12-30``), differentiable in
    ``points``, ``isigmas``, ``rays``, ``attrs`` and ``origins``.

    :param cameras_or_params: a ``PerspectiveCameras`` or ``(R, T, focal,
        principal)``
    :param points: (B, P, 3) camera-centred means, or world means when
        ``origins`` is given; :param isigmas: (B, P, 3, 3)
    :param rays: (B, H, W, 3)
    :param max_points_per_bin: -1 for no coarse stage (the global path)
    :param agg_ow: occupation weight of the fused erf compositing
    :param attrs: optional (B, P, d) attributes composited in the select
        kernel (compacted path) or by the attribute merge (global path)
    :param camera_grad: False skips the ray gradient in the backward
    :param origins: optional (B, 3) camera centres: ``points`` are centred
        on them here.  On the compacted path their gradient is summed per ray
        in the backward, so a scene that needs no gradient (pose refinement)
        runs no per-Gaussian pass; with no coarse stage it flows through the
        subtraction.
    :return: ((idx, len, act, dsd, w, img or None) in image layout
        (B, H, W, K) / (B, H, W, d), overflow_points (scalar int32 tensor))

    Above K = 128 the dense route (:func:`ops.dense_select.ray_tracing_dense`)
    serves the call, in float32.
    """
    if takes_dense_route(n_assign):
        if not isinstance(cameras_or_params, tuple):
            cameras_or_params = cameras_or_params.batched_params(points.shape[0])
        f32 = torch.float32
        return ray_tracing_dense(cameras_or_params, points.to(f32), isigmas.to(f32),
                                 rays.to(f32), image_size, thr, n_assign, bin_size,
                                 max_points_per_bin, agg_ow, attrs, camera_grad, origins)
    B, P = points.shape[0], points.shape[1]
    bs, mppb = production_bin_geometry(image_size, n_assign, P, bin_size,
                                       max_points_per_bin)
    if mppb == -1:
        if origins is not None:
            points = points - origins[:, None, :]
        sel = FineSelectGlobal.apply(points, isigmas, rays.contiguous(),
                                     -math.log(thr + 1.0 / 1e10), int(n_assign),
                                     bs, float(agg_ow), bool(camera_grad))
        img = None
        if attrs is not None:
            a = attrs.to(torch.float32).reshape(B * P, attrs.shape[-1]).contiguous()
            img = AttrMerge.apply(sel[4], a, sel[0])
        return tuple(sel) + (img,), torch.zeros((), dtype=torch.int32,
                                                device=points.device)
    if origins is not None:     # the centres' gradient comes from FineSelect
        points = points - origins.detach()[:, None, :]
    if isinstance(cameras_or_params, tuple):
        cams = cameras_or_params
    else:
        cams = cameras_or_params.batched_params(points.shape[0])
    c = compact_candidates(*cams, points, isigmas, image_size, thr, n_assign,
                           bin_size, max_points_per_bin)
    sel = FineSelect.apply(points, isigmas, rays.contiguous(), attrs, origins, c,
                           int(n_assign), float(agg_ow), bool(camera_grad))
    if attrs is None:
        sel = tuple(sel) + (None,)
    return tuple(sel), c.overflow_c.sum().to(torch.int32)
