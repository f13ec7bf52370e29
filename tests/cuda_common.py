"""What the port's checks on the card and ``chip_smoke.py`` share: the
kernels the port launches, the main paths' scenes at their own shapes, the
routes (the plain path, no plain version, a main path with its launches
counted), the comparisons of a kernel with its plain version, with their
tolerances, and memory that ends where its mapping ends (``AtTheEnd``), so a
kernel's read past an input faults.

It imports only torch, numpy and the port, so that it runs on a GPU machine
without JAX.  The tests import it by name (``tests/`` is on their path);
``chip_smoke.py`` appends ``tests/`` to ``sys.path`` and imports it.  The
port's modules that only the routes need are imported inside them, so that
the scenes load against any checkout of the port (``tools/torch_*.py
--root``).

Tolerances (``tests/test_parity_full.py:22-49``): selections equal but for
knife-edge pixels (< 0.1% flipped); len / act / dsd rtol 1e-5 atol 1e-5;
weights and images atol 1e-4 on agreeing pixels.  Backward kernels against
their plain versions: max |kernel - plain| <= 1e-4 max |plain| per tensor.
K3f against its plain version: 1e-5 absolute.  The similarity kernel
against its plain version in float64: 1e-6 absolute; its gradient's kernel
against autograd of the plain version in float64: 2e-6 of each row's scale
(``sim_grad_err``).
"""
from __future__ import annotations

import ctypes
import math
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

import voge_tpu_torch as vt
from voge_tpu_torch.aggregation import expend_sigma
from voge_tpu_torch.rays import camera_rays

KERNELS = {  # PERF.md section 6's kernels -> (library, source, replaced TPU kernel)
    # the coarse stage: K1 and the two kernels that, with slot_runs, replace
    # the XLA sort and row slicing around it (voge_tpu/ops/coarse.py:417-440)
    "emit_rows": ("emit", "voge_tpu_torch/csrc/emit.cu",
                  "voge_tpu/ops/pallas_coarse.py:38"),
    "coarse_globals": ("emit", "voge_tpu_torch/csrc/emit.cu",
                       "voge_tpu/ops/pallas_coarse.py:38"),
    "coarse_rows": ("emit", "voge_tpu_torch/csrc/emit.cu",
                    "voge_tpu/ops/pallas_coarse.py:38"),
    "fine_select": ("fine_select", "voge_tpu_torch/csrc/fine_select.cu",
                    "voge_tpu/ops/pallas_fine2.py:89"),
    "attr_merge": ("attr_merge", "voge_tpu_torch/csrc/attr_merge.cu",
                   "voge_tpu/ops/pallas_attr.py:64"),
    "fold_weights": ("fold_weights", "voge_tpu_torch/csrc/fold_weights.cu",
                     "voge_tpu/ops/pallas_fine2.py:627"),
    "fine_bwd": ("fine_bwd", "voge_tpu_torch/csrc/fine_bwd.cu",
                 "voge_tpu/ops/pallas_bwd.py:573"),
    "attr_merge_bwd": ("attr_merge_bwd", "voge_tpu_torch/csrc/attr_merge_bwd.cu",
                       "voge_tpu/ops/pallas_attr.py:90"),
    "fine_select_global": ("fine_select", "voge_tpu_torch/csrc/fine_select.cu",
                           "voge_tpu/ops/pallas_fine2.py:803"),
    "fine_bwd_global": ("fine_bwd", "voge_tpu_torch/csrc/fine_bwd.cu",
                        "voge_tpu/ops/pallas_bwd.py:255"),
    "attr_scatter": ("attr_merge_bwd", "voge_tpu_torch/csrc/attr_merge_bwd.cu",
                     "voge_tpu/ops/pallas_attr.py:168"),
    "attr_dw": ("attr_merge_bwd", "voge_tpu_torch/csrc/attr_merge_bwd.cu",
                "voge_tpu/ops/pallas_attr.py:190"),
    "fine_select_bins": ("fine_select", "voge_tpu_torch/csrc/fine_select.cu",
                         "voge_tpu/ops/pallas_fine.py:64"),
    # the global backward's two halves: K3's kernels with the fold off (the
    # per-Gaussian half) and its per-slot kernel alone (the per-ray half)
    "fine_bwd_gauss": ("fine_bwd", "voge_tpu_torch/csrc/fine_bwd.cu",
                       "voge_tpu/ops/pallas_bwd.py:162"),
    "fine_bwd_rays": ("fine_bwd", "voge_tpu_torch/csrc/fine_bwd.cu",
                      "voge_tpu/ops/pallas_bwd.py:213"),
    # the grouping of slots by id that rows 10, 11 (and K3) take: part of the
    # port of the scatter kernel, whose one-hot match it replaces
    "slot_runs": ("slot_runs", "voge_tpu_torch/csrc/slot_runs.cu",
                  "voge_tpu/ops/pallas_attr.py:168"),
    # pose scoring's similarity and its gradient in the stack, which
    # voge_tpu leaves to XLA
    "feature_similarity": ("similarity", "voge_tpu_torch/csrc/similarity.cu",
                           "none: XLA (voge_tpu/models/pose.py)"),
    "feature_similarity_grad": ("similarity", "voge_tpu_torch/csrc/similarity.cu",
                                "none: XLA's VJP (voge_tpu/models/pose.py)"),
}
LAUNCHERS = tuple(KERNELS)   # their wrappers, each counted as ``launch.<name>``
# the coarse stage's kernels, which no other path launches, and with the
# grouping its launchers
COARSE_KERNELS = ("emit_rows", "coarse_globals", "coarse_rows")
COARSE = COARSE_KERNELS + ("slot_runs",)
# the two small kernels behind K2's global entry (its cone cull's glue):
# one launch each a launch of it
GLUE_LAUNCHERS = ("cull_rows", "block_cones")
# the kernels one call of each main path launches
PATH_KERNELS = {
    "fitting_step": (*COARSE, "fine_select", "fine_bwd"),
    "white_background_step": (*COARSE, "fine_select", "fine_bwd", "attr_merge", "attr_merge_bwd"),
    "shapefit_step": ("fine_select_global", "fine_bwd_global", "attr_merge", "attr_merge_bwd",
                      "slot_runs"),
    "texture_chain": (*COARSE, "fine_select", "attr_scatter", "attr_merge"),
    "sampler_backward": ("attr_scatter", "attr_dw", "attr_merge", "slot_runs"),
    "two_stage_step": ("fine_select_bins", "fine_bwd_global", "slot_runs"),
    "cloud_100k_forward": (*COARSE, "fine_select"),
    "cloud_300k_step": ("fine_select_global", "attr_merge", "attr_dw", "fine_bwd_global",
                        "slot_runs"),
    "frozen_300k_step": ("fine_select_global", "fine_bwd_rays"),
    "pose_score_and_refine": (*COARSE, "fine_select", "fine_bwd_rays", "attr_merge", "attr_dw",
                              "feature_similarity", "feature_similarity_grad"),
    # refine_pose over a batch: the frozen scene's per-ray half, the merge's
    # weight gradient, the similarity and its gradient
    "pose_refine_batch": (*COARSE, "fine_select", "fine_bwd_rays", "attr_merge", "attr_dw",
                          "feature_similarity", "feature_similarity_grad"),
    "occlusion_step": (*COARSE, "fine_select", "fine_bwd", "attr_merge", "attr_merge_bwd"),
    "batch8_step": (*COARSE, "fine_select", "fine_bwd"),
}

SF_B, SF_HW, SF_K = 5, (128, 128), 25   # the ShapeFitting step (bench.py:234-290)
TEX_HW, TEX_K = (256, 672), 80          # texture extraction (bench.py:189-231)
CLOUD_HW, CLOUD_K = (320, 320), 20      # the point-cloud render (bench.py:108-137)
POSE_B, POSE_HW = 8, (256, 256)         # batched pose hypotheses (bench.py:324-361)
OCC_HW, OCC_K, OCC_MPPB = (400, 400), 60, 1500   # occlusion (bench.py:140-186)
OCC_COLORS = ([[0, 0.2, 1], [0, 0.2, 1], [0, 1, 0.2], [0, 1, 0.2], [0, 1, 1], [0, 1, 1]],
              [[1, 0.2, 0], [1, 0.2, 0], [1, 1, 0], [1, 1, 0], [0.2, 1, 0], [0.2, 1, 0]])
B8 = 8                                            # the headline at B = 8 (bench.py:324-361)
THR_ACT = -math.log(0.01 + 1.0 / 1e10)

FLIP_MAX, LAD_TOL, W_TOL = 1e-3, 1e-5, 1e-4
GRAD_TOL = 1e-4      # backward kernels against their plain versions, of the largest entry
MERGE_TOL = 1e-5     # K3f against its plain version, absolute
SIM_TOL = 1e-6       # the similarity kernel against its plain version in float64, absolute
SIM_GRAD_TOL = 2e-6  # its gradient's kernel against autograd in float64, of a row's scale


# ---- scenes ------------------------------------------------------------------

def scene(n, hw, focal, dev):
    """Cuboid scene of ``n`` requested Gaussians, camera (6, 10, 70)."""
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), n,
                                         percentage=0.6, as_obj=True, device=dev)
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70, device=dev)
    cams = (R, T, torch.tensor([[focal, focal]], device=dev),
            torch.tensor([[hw[1] / 2, hw[0] / 2]], device=dev))
    colors = ((g.verts.detach() + 1) / 3).contiguous()
    return g, cams, colors


def stage_inputs(g, cams, hw):
    """Rays and camera-centred (points, isigmas) as render_pipeline makes
    them."""
    rays, origins = camera_rays(*cams, hw)
    points = g.verts.detach()[None] - origins[:, None, :]
    isig = 2.0 * expend_sigma(g.sigmas.detach())[None].expand(1, -1, 3, 3)
    return rays, points, isig


def seeded(shape, dev, seed):
    return torch.randn(shape, device=dev, generator=torch.Generator(dev).manual_seed(seed))


def bench_loss(frag):
    """bench.py's loss: mean((attr_img - 0.5)^2) + mean(silhouette^2)."""
    return ((frag.attr_img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()


def fitting_step(g, cams, colors, hw, ctx=None):
    """Fragments, loss and (verts, sigmas, colours) leaves of one fitting
    step."""
    verts = g.verts.detach().requires_grad_(True)
    sigmas = g.sigmas.detach().requires_grad_(True)
    cols = colors.detach().requires_grad_(True)
    if ctx is None:
        ctx = vt.precompute_camera_ctx(*cams, hw, verts.shape[0], max_assign=20)
    frag = vt.render_pipeline(verts, sigmas, *cams, image_size=hw, max_assign=20,
                              cam_ctx=ctx, attrs=cols)
    return frag, bench_loss(frag), (verts, sigmas, cols)


def shapefit_scene(dev):
    """``bench.py:234-290``'s ShapeFitting scene through the port's own
    converters: ``ico_sphere(4)`` (2,562 Gaussians) through
    ``naive_vertices_converter(percentage=0.5)``, colours 0.5, five views at
    dist 2.7, elevations ``linspace(-10, 30, 5)``, azimuths ``linspace(-60,
    60, 5)``, focal 126 at 128x128; targets RGB 0.3 and silhouette 0.
    :return: (verts (N, 3), inverse sigmas (N,), colours (N, 3), (R, T,
        focal, principal), (target_rgb, target_sil))"""
    v, f = vt.ico_sphere(4)
    verts, isig, _ = vt.naive_vertices_converter(v, f, percentage=0.5)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    R, T = vt.look_at_view_transform(dist=[2.7] * SF_B, elev=list(np.linspace(-10, 30, SF_B)),
                                     azim=list(np.linspace(-60, 60, SF_B)), device=dev)
    cams = (R, T, t(np.full((SF_B, 2), 126.0)), t(np.full((SF_B, 2), 64.0)))
    targets = (t(np.full((SF_B,) + SF_HW + (3,), 0.3)), t(np.zeros((SF_B,) + SF_HW)))
    return t(verts), t(isig), t(np.full((len(verts), 3), 0.5)), cams, targets


def shapefit_loss(verts, isig, colors, cams, targets):
    """The ShapeFitting loss through ``render_pipeline(max_point_per_bin=-1)``,
    ``interpolate_attr`` and ``get_silhouette``; (fragments, loss)."""
    frag = vt.render_pipeline(verts, isig, *cams, image_size=SF_HW, max_assign=SF_K,
                              max_point_per_bin=-1)
    rgb = vt.interpolate_attr(frag, colors)
    loss = ((vt.get_silhouette(frag) - targets[1]) ** 2).mean() + ((rgb - targets[0]) ** 2).mean()
    return frag, loss


def texture_scene(dev):
    """``bench.py:204-214``'s texture scene through the port's own
    converters: ``ico_sphere(5)`` (10,242 Gaussians) through
    ``naive_vertices_converter(percentage=0.5, max_sig_rate=2)``, one view at
    ``dist=3, elev=0.1, azim=0.6`` (radians), focal 1800, principal (336,
    128), and the random image of ``np.random.RandomState(0)``.
    :return: (verts (N, 3), inverse sigmas (N,), (R, T, focal, principal),
        image (1, 256, 672, 3))"""
    v, f = vt.ico_sphere(5)
    verts, isig, _ = vt.naive_vertices_converter(v, f, percentage=0.5, max_sig_rate=2)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    R, T = vt.look_at_view_transform(dist=3, elev=0.1, azim=0.6, degrees=False, device=dev)
    cams = (R, T, t([[1800.0, 1800.0]]), t([[336.0, 128.0]]))
    image = t(np.random.RandomState(0).uniform(size=(1,) + TEX_HW + (3,)))
    return t(verts), t(isig), cams, image


def texture_chain(verts, isig, cams, image, ctx):
    """``bench.py:220-227``: render at K = 80, pull the image back onto the
    Gaussians, re-render; (fragments, weight sums, texture, image)."""
    frag = vt.render_pipeline(verts, isig, *cams, image_size=TEX_HW, max_assign=TEX_K,
                              cam_ctx=ctx)
    feat, wsum = vt.sample_features(frag, image, n_vert=verts.shape[0])
    texture = feat / (1e-8 + wsum[:, None])
    return frag, wsum, texture, vt.to_white_background(frag, texture)


def cloud_scene(n, dev):
    """``bench.py:117-123``'s point-cloud scene at ``n`` points:
    ``RandomState(0).uniform(-1, 1, (n, 3))`` through
    ``fixed_pointcloud_converter(radius=0.01)``, one view at ``dist=4,
    elev=20, azim=30``, focal 400, principal (160, 160).
    :return: (verts (n, 3), inverse sigmas (n,), (R, T, focal, principal))"""
    pts = np.random.RandomState(0).uniform(-1, 1, size=(n, 3)).astype(np.float32)
    verts, isig, _ = vt.fixed_pointcloud_converter(pts, radius=0.01)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    R, T = vt.look_at_view_transform(dist=4, elev=20, azim=30, device=dev)
    return t(verts), t(isig), (R, T, t([[400.0, 400.0]]), t([[160.0, 160.0]]))


def cloud_step(verts, isig, cams, colors):
    """The no-coarse point-cloud step: ``render_pipeline(max_point_per_bin=
    -1)`` -> ``interpolate_attr`` -> ``bench.py``'s loss, with verts, sigmas,
    R and T as leaves; (fragments, loss, leaves)."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (verts, isig, cams[0], cams[1])]
    frag = vt.render_pipeline(leaves[0], leaves[1], leaves[2], leaves[3], cams[2], cams[3],
                              image_size=CLOUD_HW, max_assign=CLOUD_K, max_point_per_bin=-1)
    img = vt.interpolate_attr(frag, colors)
    loss = ((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
    return frag, loss, leaves


def occlusion_scene(dev):
    """``bench.py:140-186``'s scene (6,778 Gaussians), its camera and colours."""
    cg = vt.converter.Cuboid.cuboid_gauss
    v0, s0, c0 = cg((-0.8, 0.8), (-0.4, 0.4), (-0.6, 0.6), 4000, colors=np.array(OCC_COLORS[0]),
                    percentage=0.7)
    v1, s1, c1 = cg((-1, 1), (-1, 1), (-0.3, 0.3), 3000, colors=np.array(OCC_COLORS[1]),
                    percentage=0.7)
    t = lambda x: torch.tensor(np.asarray(x).astype(np.float32), device=dev)
    verts = t(np.concatenate([v0 + np.array([[0.5, 0, 1]]), v1], 0))
    R, T = vt.look_at_view_transform(dist=5, elev=10, azim=20, device=dev)
    cams = (R, T, torch.tensor([[300.0, 300.0]], device=dev),
            torch.tensor([[200.0, 200.0]], device=dev))
    return verts, t(np.concatenate([s0, s1], 0)), t(np.concatenate([c0, c1], 0)), cams


def batch8_cams(dev, hw=(256, 256)):
    R, T = vt.look_at_view_transform(dist=[6.0] * B8, elev=list(np.linspace(5, 25, B8)),
                                     azim=list(np.linspace(50, 90, B8)), device=dev)
    return (R, T, torch.full((B8, 2), 300.0, device=dev),
            torch.tensor([[hw[1] / 2, hw[0] / 2]] * B8, device=dev))


# ---- comparisons ---------------------------------------------------------------

def compare_select(got, want):
    """Flips under FLIP_MAX, len / act / dsd and weights / image on agreeing
    pixels within their tolerances."""
    agree = (got[0] == want[0]).all(-1)
    flips = 1.0 - agree.float().mean().item()
    assert flips < FLIP_MAX, f"select flips {flips}"
    for g, w in zip(got[1:4], want[1:4]):
        torch.testing.assert_close(g[agree], w[agree], rtol=LAD_TOL, atol=LAD_TOL)
    for g, w in zip(got[4:], want[4:]):
        if g is None:
            continue
        e = (g[agree] - w[agree]).abs().max().item()
        assert e <= W_TOL, f"select weights/image error {e}"


def equal_select(got, want):
    """Selections and len / act / dsd equal to the bit; weights and image
    within W_TOL."""
    assert torch.equal(got[0], want[0]), "select: the selections differ"
    for g, w in zip(got[1:4], want[1:4]):
        assert torch.equal(g, w), "select: len / act / dsd differ"
    for g, w in zip(got[4:], want[4:]):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=W_TOL)


def grad_err(got, want, what=""):
    """max |kernel - plain| / max |plain| within GRAD_TOL."""
    scale = want.abs().max().item()
    assert scale > 0, f"{what}: plain result is all zero"
    e = (got - want).abs().max().item() / scale
    assert e <= GRAD_TOL, f"{what}: kernel vs plain {e:.3e}"
    return e


def sim_grad_err(got, want, pred, grad, what=""):
    """The similarity gradient's kernel (``got``) against autograd of the
    plain version in float64 (``want``) on float32 ``pred`` (B, H, W, C) and
    ``grad`` (B,): the largest gap, each row's scaled by n_pix / |grad[b]| x
    (|p| + 1e-8), within SIM_GRAD_TOL.  A row's gradient is that scale's
    inverse times a sum of two terms each at most 1 (a unit vector's entries;
    a background pixel, p = 0, only the first, 1e8 times a foreground
    pixel's), so the measure is float32's rounding of each row alone (float32
    autograd of the expression reads ~1e-7)."""
    n_pix = pred.shape[1] * pred.shape[2]
    scale = (n_pix / grad.double().abs())[:, None, None, None] \
        * (torch.linalg.norm(pred.double(), dim=-1, keepdim=True) + 1e-8)
    e = ((got.double() - want) * scale).abs().max().item()
    assert e <= SIM_GRAD_TOL, f"{what}: kernel vs autograd in float64 {e:.3e} of a row's scale"
    return e


def hold_runs(idx, n_rows):
    """``slot_runs`` against its plain version (torch.sort + searchsorted):
    the run starts and the valid prefix of ``order`` equal to the bit, two
    runs equal; returns the valid slots."""
    from voge_tpu_torch.ops.cuda_attr import slot_runs, slot_runs_plain

    order, starts = slot_runs(idx, n_rows)
    again = slot_runs(idx, n_rows)
    p_order, p_starts = slot_runs_plain(idx, n_rows)
    assert order.dtype == torch.int32 and starts.dtype == torch.int64, "slot_runs: dtypes"
    v = int(p_starts[-1])
    assert torch.equal(starts, p_starts) and torch.equal(order[:v], p_order[:v]), \
        "slot_runs: not the plain version's grouping"
    assert torch.equal(again[1], starts) and torch.equal(again[0][:v], order[:v]), \
        "slot_runs: two runs differ"
    return v


def fold_then_pair(rays, table, idx, length, act, dsd, w, g_len, g_act, g_dsd, g_w,
                   agg_ow, want_rays=True):
    """The global backward as the fold's entry and the two halves, with the
    unified entry's arguments and results."""
    from voge_tpu_torch.ops.cuda_fine_bwd import fine_bwd_gauss, fine_bwd_rays, fold_weights

    g3 = [g_len, g_act, g_dsd]
    if g_w is not None:
        g3 = [d if g is None else g + d
              for g, d in zip(g3, fold_weights(length, act, dsd, w, g_w, agg_ow))]
    halves = (rays, table, idx, length, dsd, *g3)
    return fine_bwd_gauss(*halves), fine_bwd_rays(*halves) if want_rays else None


# ---- routes and launches --------------------------------------------------------

@contextmanager
def plain_path():
    """Route a render and its backward through the plain versions on CUDA
    tensors: every module attribute through which a main path calls a
    kernel wrapper."""
    from voge_tpu_torch import sampler
    from voge_tpu_torch.ops import (
        coarse, cuda_attr, cuda_coarse, cuda_fine, cuda_fine_bwd, cuda_similarity, fine,
    )

    # the similarity's wrapper takes its gradient's kernel too
    swaps = [(cuda_similarity, "feature_similarity", cuda_similarity.feature_similarity_plain),
             (coarse, "emit_rows", cuda_coarse.emit_rows_plain),
             (coarse, "slot_runs", cuda_attr.slot_runs_plain),
             (coarse, "coarse_globals", cuda_coarse.coarse_globals_plain),
             (coarse, "coarse_rows", cuda_coarse.coarse_rows_plain),
             (fine, "fine_select_bins", cuda_fine.fine_select_bins_plain),
             (sampler, "attr_scatter", cuda_attr.attr_scatter_plain),
             (sampler, "attr_dw", cuda_attr.attr_dw_plain),
             (sampler, "attr_merge", cuda_attr.attr_merge_plain),
             (fine, "fine_select", cuda_fine.fine_select_plain),
             (fine, "fine_bwd", cuda_fine_bwd.fine_bwd_plain),
             (fine, "fine_select_global", cuda_fine.fine_select_global_plain),
             (fine, "fine_bwd_global", cuda_fine_bwd.fine_bwd_global_plain),
             (fine, "fine_bwd_rays", cuda_fine_bwd.fine_bwd_rays_plain),
             (cuda_attr, "attr_merge", cuda_attr.attr_merge_plain),
             (cuda_attr, "attr_merge_bwd", cuda_attr.attr_merge_bwd_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, fn in swaps:
            setattr(m, n, fn)
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


@contextmanager
def no_plain_version():
    """Make every kernel's plain version, and the coarse stage's int64 route,
    raise: a main path inside it ran on the kernels alone."""
    from voge_tpu_torch.ops import (
        coarse, cuda_attr, cuda_coarse, cuda_fine, cuda_fine_bwd, cuda_similarity,
    )

    def refuse(name):
        def fn(*_a, **_k):
            raise RuntimeError(f"the plain version {name} ran on the main path")
        return fn

    saved = [(m, n, getattr(m, n))
             for m in (cuda_attr, cuda_coarse, cuda_fine, cuda_fine_bwd, cuda_similarity)
             for n in dir(m) if n.endswith("_plain")]
    saved.append((coarse, "_emit_candidates_sorted", coarse._emit_candidates_sorted))
    try:
        for m, n, _ in saved:
            setattr(m, n, refuse(n))
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def launched(name):
    from voge_tpu_torch import trace

    return trace.counts().get(f"launch.{name}", 0)


@contextmanager
def main_path(required=(), kernels_only=False, dense=False):
    """The block as a main path: every wrapper's launches counted from its
    start (the dict it yields, filled at its end, zero for each of
    LAUNCHERS that did not launch), with every plain version made to raise
    if ``kernels_only``.  Each kernel in ``required`` launched, K2 global's
    glue once each a launch of it, and the dense route not taken unless
    ``dense``."""
    from voge_tpu_torch import trace
    from voge_tpu_torch.ops import dense_select

    counts = {}
    dense_select.calls = 0
    with trace.tracing(), (no_plain_version() if kernels_only else nullcontext()):
        yield counts
        torch.cuda.synchronize()
        counts.update(dict.fromkeys(LAUNCHERS, 0))
        counts.update({k[len("launch."):]: v for k, v in trace.counts().items()
                       if k.startswith("launch.")})
    for k in required:
        assert counts[k] > 0, f"{k} was not launched on the main path"
    assert all(counts.get(k, 0) == counts["fine_select_global"] for k in GLUE_LAUNCHERS), \
        f"K2's global entry ran without its cone cull: {counts}"
    if not dense:
        assert dense_select.calls == 0, "a render at K <= 128 took the dense route"


# ---- memory that ends where the mapping ends ------------------------------------

class _Prop(ctypes.Structure):      # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                ("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("win32_meta", ctypes.c_void_p), ("compression", ctypes.c_ubyte),
                ("rdma", ctypes.c_ubyte), ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _Access(ctypes.Structure):    # CUmemAccessDesc
    _fields_ = [("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int), ("flags", ctypes.c_int)]


class AtTheEnd:
    """``n`` float32 (or int32, by ``dtype``) on the card whose last one
    ends where mapped memory ends: CUDA's virtual memory API (the driver,
    through ctypes) reserves a granule more than it maps, so a read past the
    end faults with an illegal address instead of reading a neighbour's
    bytes in the caching allocator's block.  ``tensor`` views it; ``free``
    unmaps it."""

    def __init__(self, n, device, dtype=torch.float32):
        cu = self.cu = ctypes.CDLL("libcuda.so.1")
        u64, size = ctypes.c_uint64, ctypes.c_size_t
        prop = _Prop(type=1, loc_type=1, loc_id=device.index or 0)    # pinned, on the device
        gran = size()
        _ok(cu.cuMemGetAllocationGranularity(ctypes.byref(gran), ctypes.byref(prop), 0))
        self.mapped = -(-n * 4 // gran.value) * gran.value
        self.reserved = self.mapped + gran.value
        self.base, self.handle = u64(), u64()
        _ok(cu.cuMemAddressReserve(ctypes.byref(self.base), size(self.reserved), size(0),
                                   u64(0), u64(0)))
        _ok(cu.cuMemCreate(ctypes.byref(self.handle), size(self.mapped), ctypes.byref(prop),
                           u64(0)))
        _ok(cu.cuMemMap(self.base, size(self.mapped), size(0), self.handle, u64(0)))
        access = _Access(loc_type=1, loc_id=prop.loc_id, flags=3)     # read and write
        _ok(cu.cuMemSetAccess(self.base, size(self.mapped), ctypes.byref(access), size(1)))
        ptr = self.base.value + self.mapped - n * 4
        typestr = {torch.float32: "<f4", torch.int32: "<i4"}[dtype]
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": typestr,
                                         "data": (ptr, False), "version": 3}
        self.tensor = torch.as_tensor(self, device=device)
        assert self.tensor.data_ptr() == ptr

    def free(self):
        torch.cuda.synchronize()
        self.tensor = None
        size = ctypes.c_size_t
        _ok(self.cu.cuMemUnmap(self.base, size(self.mapped)))
        _ok(self.cu.cuMemRelease(self.handle))
        _ok(self.cu.cuMemAddressFree(self.base, size(self.reserved)))


def _ok(err):
    assert err == 0, f"CUDA driver error {err}"
