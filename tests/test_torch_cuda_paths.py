"""The port on the card at the main paths' own shapes: each kernel against
its plain version on those paths' inputs, each main path with its launches
counted, and the paths held to ``voge_tpu``'s golden files (``tests/data``),
to the float64 oracle, to the plain path and to their single-device twins.

These tests need an NVIDIA GPU (marker ``cuda``) and skip elsewhere.  The
GPU machine has no JAX, so this file imports only torch, numpy and the port,
and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_paths.py

The shapes are the main paths' (``bench.py``'s scenes): the 10K cuboid at
256x256 (the headline), the 1K cuboid at 128x128, the ShapeFitting trainer
(2,562 Gaussians, 5 views, 128x128, K = 25, no coarse stage), texture
extraction (10,242 Gaussians, 256x672, K = 80), the point clouds (100,000
points with a coarse stage; 300,000 without, 320x320, K = 20) and the pose
batch (the headline scene seen by 8 cameras).  ``tests/test_torch_cuda.py``
holds the same kernels on small random scenes, and K2's entries at every K
also on the 1K cuboid at 128x128.  The scenes, the routes and the kernels'
tolerances are ``tests/cuda_common.py``'s, which ``chip_smoke.py`` shares.

Tolerances (``tests/test_parity_full.py:22-49``): selections equal but for
knife-edge pixels (< 0.1% flipped); len / act / dsd rtol 1e-5 atol 1e-5;
weights and images atol 1e-4 on agreeing pixels.  Backward kernels against
their plain versions: max |kernel - plain| <= 1e-4 max |plain| per tensor.
Gradients against a golden file: normwise relative error <= 1e-3 per
gradient and the loss to a relative 1e-5.  The fold's entry + the split
pair against the unified global entry: normwise 1e-5.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import math
import warnings
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

import voge_tpu_torch as vt
from voge_tpu_torch import trace
from voge_tpu_torch.aggregation import expend_sigma
from voge_tpu_torch.ops import coarse, cuda_fine, cuda_fine_bwd, dense_select, fine
from voge_tpu_torch.ops.cuda_attr import (
    attr_dw, attr_dw_plain, attr_merge, attr_merge_bwd, attr_merge_bwd_plain,
    attr_merge_plain, attr_scatter, attr_scatter_plain, slot_runs,
)
from voge_tpu_torch.ops.cuda_coarse import (
    coarse_globals, coarse_globals_plain, coarse_rows, coarse_rows_plain, emit_rows,
    emit_rows_plain,
)
from voge_tpu_torch.ops.cuda_fine import (
    fine_select, fine_select_bins, fine_select_bins_plain, fine_select_global,
    fine_select_global_plain, fine_select_plain,
)
from voge_tpu_torch.ops.cuda_fine_bwd import (
    fine_bwd, fine_bwd_gauss, fine_bwd_gauss_plain, fine_bwd_global, fine_bwd_global_plain,
    fine_bwd_plain, fine_bwd_rays, fine_bwd_rays_plain, fold_weights, fold_weights_plain,
    group_width,
)
from voge_tpu_torch.rays import camera_rays

from cuda_common import (
    B8, CLOUD_HW, CLOUD_K, COARSE, COARSE_KERNELS, FLIP_MAX, GRAD_TOL, LAD_TOL, MERGE_TOL,
    OCC_HW, OCC_K, OCC_MPPB, PATH_KERNELS, POSE_B, POSE_HW, SF_B, SF_HW, SF_K, TEX_HW, TEX_K,
    THR_ACT, W_TOL, AtTheEnd, batch8_cams, bench_loss, cloud_scene, cloud_step,
    compare_select, equal_select, fitting_step, fold_then_pair, grad_err, hold_runs, launched,
    main_path, no_plain_version, occlusion_scene, plain_path, scene, seeded, shapefit_loss,
    shapefit_scene, stage_inputs, texture_chain, texture_scene,
)

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parent / "data"
GOLDEN = DATA / "voge_tpu_golden_1k_128.npz"
GOLDEN_GRAD = {"1k": DATA / "voge_tpu_golden_grad_1k_128.npz",
               "headline": DATA / "voge_tpu_golden_grad_10k_256.npz"}
GOLDEN_SF = DATA / "voge_tpu_golden_shapefit_128.npz"
GOLDEN_TEX = DATA / "voge_tpu_golden_texture_256x672.npz"
GOLDEN_OCC = DATA / "voge_tpu_golden_occlusion_400.npz"
GOLDEN_B8 = DATA / "voge_tpu_golden_batch8_256.npz"
GOLDEN_LK = DATA / "voge_tpu_golden_large_k_64.npz"
GOLD_GRAD_TOL, GOLD_LOSS_TOL = 1e-3, 1e-5
# pose: scores within 1e-5 and parameters after three Adam steps within 1e-4
# of the plain path's
PAIR_TOL, SCORE_TOL, POSE_TOL = 1e-5, 1e-5, 1e-4
LK_K = 200                                        # the dense route: K above MAX_K
LK_MODES = {"coarse": (0.01, None), "no_coarse": (1e-8, -1)}   # mode -> (thr, max_point_per_bin)
# (mesh shape, model axis, ring), every shard on the one card
SHARD_MESHES = {"dp_2x1": ((2, 1), None, False), "gather_2x2": ((2, 2), "model", False),
                "ring_2x2": ((2, 2), "model", True), "gather_1x4": ((1, 4), "model", False)}
FIT_TOL = 1e-4       # ShapeFitter(mesh=) against the unsharded trainer, after three steps
DEMO_ITERS = 2       # the optimization demos' depth, cut from 400 / 200 / 320


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ---- comparisons ---------------------------------------------------------------

def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def rel_t(got, want):
    """Normwise relative error of two tensors, in float64 on their device."""
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def digest_flips(idx, gold_valid, gold_ids):
    """Share of pixels whose selections' digest (count, sum of ids) differs
    from a golden file's."""
    valid = (idx >= 0).sum(-1)
    ids = torch.where(idx >= 0, idx, 0).long().sum(-1)
    gv = torch.as_tensor(gold_valid.astype(np.int64), device=idx.device).reshape(valid.shape)
    gi = torch.as_tensor(gold_ids.astype(np.int64), device=idx.device).reshape(ids.shape)
    return 1.0 - ((valid == gv) & (ids == gi)).float().mean().item()


def hold_golden(tag, loss, grads, gold, prefix="", oracle=None):
    """The loss within GOLD_LOSS_TOL and each gradient within GOLD_GRAD_TOL
    (normwise) of a golden file's; with ``oracle`` (float64 gradients on the
    card) the sigma gradient is held to the oracle instead (``voge_tpu``'s
    float32 sigma gradient is ~1.5e-3 from its float64 value where |mu| ~ 6)."""
    e = abs(loss - float(gold[prefix + "loss"])) / abs(float(gold[prefix + "loss"]))
    assert e <= GOLD_LOSS_TOL, f"{tag} loss {loss} vs golden {float(gold[prefix + 'loss'])}"
    for i, name in enumerate(("verts", "sigmas", "colors")):
        x = grads[i]
        assert bool(torch.isfinite(x).all()), f"{tag}: non-finite {name} gradient"
        if oracle is not None and name == "sigmas":
            e = rel_t(x, oracle[i])
            assert e <= GOLD_GRAD_TOL, f"{tag}: sigma gradient vs the float64 oracle {e:.3e}"
        else:
            e = rel(x.cpu().numpy(), gold[f"{prefix}grad_{name}"])
            assert e <= GOLD_GRAD_TOL, f"{tag}: {name} gradient vs golden {e:.3e}"


# ---- routes and launches --------------------------------------------------------

@contextmanager
def sorted_route():
    """The coarse stage by its int64 route (``ops.coarse._emit_candidates_sorted``)."""
    saved = coarse._emit_candidates
    coarse._emit_candidates = coarse._emit_candidates_sorted
    try:
        yield
    finally:
        coarse._emit_candidates = saved


def compacted_unused(counts):
    assert all(counts[k] == 0 for k in (*COARSE_KERNELS, "fine_select", "fine_bwd")), \
        "the compacted path's kernels ran on the no-coarse path"


def host_syncs(fn, n):
    """Host reads of device data in each of ``n`` calls of ``fn``, counted on
    the host by torch's sync debug mode."""
    fn()
    torch.cuda.synchronize()
    saved = torch.cuda.get_sync_debug_mode()
    counts = []
    try:
        torch.cuda.set_sync_debug_mode("warn")
        for _ in range(n):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
            counts.append(sum("synchronizing CUDA operation" in str(w.message)
                              for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode(saved)
    return counts


# ---- the kernels' checks -----------------------------------------------------------

def hold_k3(name, b_args):
    """K3's entry ``name`` against its plain version and two runs equal to
    the bit; on the compacted entry also with the per-ray mean-gradient sums
    (``return_mu``), the other outputs equal to the bit to the call without
    them.  Where it sums the ray gradient, the per-ray half on the same
    arguments (the fold and any d_w fused in), with and without the mean
    sums, equal to the entry to the bit and held to its plain version."""
    kfn, pfn = ((fine_bwd, fine_bwd_plain) if name == "fine_bwd"
                else (fine_bwd_global, fine_bwd_global_plain))
    same = lambda a, b: (a is None and b is None) or torch.equal(a, b)
    kb, again, pb = kfn(*b_args), kfn(*b_args), pfn(*b_args)
    assert kb[0].shape == pb[0].shape == (b_args[1].shape[0], kb[0].shape[1]), \
        "K3: not one row per Gaussian"
    grad_err(kb[0], pb[0], "K3 rows")
    assert torch.equal(kb[0], again[0]), "K3: two runs differ"
    k_mu = None
    if name == "fine_bwd":
        km, km2 = kfn(*b_args, return_mu=True), kfn(*b_args, return_mu=True)
        assert same(km[0], kb[0]) and same(km[1], kb[1]), \
            "K3: the mean sums change the rows or the ray gradient"
        assert torch.equal(km[2], km2[2]), "K3: two runs of g_mu differ"
        grad_err(km[2], pfn(*b_args, return_mu=True)[2], "K3 g_mu")
        k_mu = km[2]
    if b_args[-1]:
        grad_err(kb[1], pb[1], "K3 rays")
        assert torch.equal(kb[1], again[1]), "K3: two runs differ"
        rays, table, idx, length, act, dsd, w, gl, ga, gd, gw, ow = b_args[:12]
        extra = dict(attrs=b_args[12], g_img=b_args[13]) if name == "fine_bwd" else {}
        halves = (rays, table, idx, length, dsd, gl, ga, gd)
        kw = dict(act=act, w=w, g_w=gw, agg_ow=ow, **extra)
        fr = fine_bwd_rays(*halves, **kw)
        fr_m, fr_mu = fine_bwd_rays(*halves, **kw, return_mu=True)
        assert torch.equal(fr, kb[1]) and torch.equal(fr_m, kb[1]), \
            "K3: the per-ray half differs from the entry"
        assert k_mu is None or torch.equal(fr_mu, k_mu), \
            "K3: the per-ray half's g_mu differs from the entry's"
        pr, pr_mu = fine_bwd_rays_plain(*halves, **kw, return_mu=True)
        grad_err(fr, pr, "fine_bwd_rays fused")
        grad_err(fr_mu, pr_mu, "fine_bwd_rays g_mu")
    else:
        assert kb[1] is None and pb[1] is None, "K3: unasked ray gradient"
    return kb


def hold_halves(rays, table, sel, cots):
    """Each half against its plain version, the fold's entry + the pair
    against the unified entry (equal to the bit where the per-Gaussian
    kernel takes 32 lanes; within PAIR_TOL elsewhere), two runs equal to the
    bit; returns the halves' inputs with only g_w set."""
    idx, length, act, dsd, w = sel
    kept = None
    warp = group_width(idx.numel(), table.shape[0]) == 32
    for kind, (gl, ga, gd, gw) in (("all", cots), ("no g_w", (*cots[:3], None)),
                                   ("only g_w", (None, None, None, cots[3]))):
        u_rows, u_rays = fine_bwd_global(rays, table, *sel, gl, ga, gd, gw, 1.0, True)
        g3 = [gl, ga, gd]
        if gw is not None:
            folded = fold_weights(length, act, dsd, w, gw, 1.0)
            g3 = [d if g is None else g + d for g, d in zip(g3, folded)]
        kept = (rays, table, idx, length, dsd, *g3)
        rows, g_rays = fine_bwd_gauss(*kept), fine_bwd_rays(*kept)
        assert torch.equal(rows, fine_bwd_gauss(*kept)) and torch.equal(
            g_rays, fine_bwd_rays(*kept)), f"split halves {kind}: two runs differ"
        grad_err(rows, fine_bwd_gauss_plain(*kept), f"fine_bwd_gauss {kind}")
        grad_err(g_rays, fine_bwd_rays_plain(*kept), f"fine_bwd_rays {kind}")
        e = max(rel_t(rows, u_rows), rel_t(g_rays, u_rays))
        assert e <= PAIR_TOL, f"fold + pair vs unified entry {kind}: {e:.3e}"
        equal = torch.equal(rows, u_rows) and torch.equal(g_rays, u_rays)
        assert equal or not warp, \
            f"fold + pair vs unified entry {kind}: not equal to the bit at 32 lanes a Gaussian"
    return kept


def hold_cull_glue(rays, table, bin_size):
    """The global entry's glue at these inputs against the plain versions
    (float64 inside both; float32 out): the block cones and unit means to
    1e-6, q to a relative 1e-5, the same rows never culled; the two-level
    route's super-tile cones to 1e-6 and level 1's masks equal."""
    B = rays.shape[0]
    P = table.shape[0] // B
    th, tw = cuda_fine.global_tile(False, bin_size)
    cones, rows = cuda_fine.block_cones(rays, th, tw), cuda_fine.cull_rows(table, THR_ACT)
    cones_p = cuda_fine.block_cones_plain(rays, th, tw)
    rows_p = cuda_fine.cull_rows_plain(table, THR_ACT)
    e_cone = (cones - cones_p).abs().max().item()
    e_u = (rows[:, :3] - rows_p[:, :3]).abs().max().item()
    e_q = ((rows[:, 3] - rows_p[:, 3]).abs() / rows_p[:, 3].clamp(min=1e-30)).max().item()
    assert e_cone <= 1e-6 and e_u <= 1e-6 and e_q <= 1e-5 and torch.equal(
        rows[:, 3] > 0, rows_p[:, 3] > 0), \
        f"K2 global glue kernels vs plain: cones {e_cone}, u {e_u}, q {e_q}"
    S = cuda_fine._SUPER
    w_cones, sup, (TH4, TW4) = cuda_fine.two_level_cones(rays)
    e_sup = (sup - cuda_fine.super_cones_plain(w_cones, B, TH4, TW4, 2 * S)).abs().max().item()
    assert e_sup <= 1e-6, f"K2 global level 1: super-tile cones vs plain {e_sup}"
    assert torch.equal(cuda_fine.cull_lists(rows, sup, B, P),
                       cuda_fine.cull_lists_plain(rows, sup, B, P)), \
        "K2 global level 1: masks differ from the plain version"


def edge_slots(dev, n_pix, K, d, n_rows, seed):
    """Seeded slots: a fifth of the ids -1, a ninth at or beyond ``n_rows``;
    weights summing to at most 1 a pixel; attribute rows in [0, 1]; a
    per-pixel cotangent."""
    gen = torch.Generator(dev).manual_seed(seed)
    idx = torch.randint(-n_rows // 4, n_rows + n_rows // 8, (n_pix, K), device=dev,
                        generator=gen, dtype=torch.int32).clamp(min=-1)
    w = torch.rand((n_pix, K), device=dev, generator=gen) / K
    attrs = torch.rand((n_rows, d), device=dev, generator=gen)
    g = torch.randn((n_pix, d), device=dev, generator=gen)
    return idx, w, attrs, g


def hold_attr_pair(idx, w, attrs, g):
    """K3f and attr_dw on one input against their plain versions (K3f within
    MERGE_TOL, ids beyond the table read as empty slots; attr_dw within
    GRAD_TOL of the plain one's largest entry, exactly 0 where that is all
    0) and two runs equal to the bit."""
    img, img2 = attr_merge(idx, w, attrs), attr_merge(idx, w, attrs)
    want = attr_merge_plain(torch.where(idx < attrs.shape[0], idx, -1), w, attrs)
    e_m = (img - want).abs().max().item()
    assert e_m <= MERGE_TOL, f"K3f: kernel vs plain {e_m:.3e}"
    assert torch.equal(img, img2), "K3f: two runs differ"
    d_w, d_w2 = attr_dw(idx, attrs, g), attr_dw(idx, attrs, g)
    want_w = attr_dw_plain(idx, attrs, g)
    scale = want_w.abs().max().item()
    if scale > 0:
        e_d = (d_w - want_w).abs().max().item() / scale
        assert e_d <= GRAD_TOL, f"attr_dw: kernel vs plain {e_d:.3e}"
    else:
        assert not d_w.any(), "attr_dw: nonzero where no slot is valid"
    assert torch.equal(d_w, d_w2), "attr_dw: two runs differ"


# ---- the main paths' inputs, built once a module ------------------------------

@pytest.fixture(scope="module")
def head(dev):
    """The 10K cuboid at 256x256 and its K = 20 selections with colours."""
    g, cams, colors = scene(10000, (256, 256), 300.0, dev)
    rays, points, isig = stage_inputs(g, cams, (256, 256))
    c = fine.compact_candidates(*cams, points, isig, (256, 256), 0.01, 20)
    table = fine.feature_table(points, isig)
    sel = fine_select(rays, table, c.bits_c, c.ids_c, c.counts_c, c.thr_act, 20, c.bin_size,
                      1.0, colors)
    return dict(g=g, cams=cams, colors=colors, rays=rays, points=points, isig=isig, sel=sel,
                P=points.shape[1], g_att=seeded(sel[0].shape[:-1] + (3,), dev, 30))


@pytest.fixture(scope="module")
def small(dev):
    """The 1K cuboid at 128x128: its stage's inputs, feature table, bins."""
    g, cams, colors = scene(1000, (128, 128), 150.0, dev)
    rays, points, isig = stage_inputs(g, cams, (128, 128))
    bs, mppb = coarse.coarse_bin_config((128, 128), 20, points.shape[1])
    bp = vt.ops.rasterize_coarse(*cams, points, isig, (128, 128), 0.01, bs, mppb)
    bits = torch.randint(0, 16, (math.prod(coarse.supertile_grid(128, 128, bs)),
                                 points.shape[1]), dtype=torch.int32, device=dev,
                         generator=torch.Generator(dev).manual_seed(41))
    return dict(g=g, cams=cams, colors=colors, rays=rays, points=points, isig=isig,
                table=fine.feature_table(points, isig), bs=bs, bp=bp, bits=bits)


@pytest.fixture(scope="module")
def pose8(dev, head):
    """The headline scene seen by the pose batch's 8 cameras at K = 20."""
    g, colors = head["g"], head["colors"]
    R, T = vt.look_at_view_transform(dist=[6.0] * POSE_B, elev=list(np.linspace(5, 25, POSE_B)),
                                     azim=list(np.linspace(50, 90, POSE_B)), device=dev)
    cams = (R, T, torch.tensor([[300.0, 300.0]] * POSE_B, device=dev),
            torch.tensor([[128.0, 128.0]] * POSE_B, device=dev))
    rays, origins = camera_rays(*cams, POSE_HW)
    points = g.verts.detach()[None] - origins[:, None, :]
    isig = 2.0 * expend_sigma(g.sigmas.detach())[None].expand(POSE_B, -1, 3, 3)
    c = fine.compact_candidates(*cams, points, isig, POSE_HW, 0.01, 20)
    attrs = colors.repeat(POSE_B, 1).contiguous()
    sel = fine_select(rays, fine.feature_table(points, isig), c.bits_c, c.ids_c,
                      c.counts_c, c.thr_act, 20, c.bin_size, 1.0, attrs)
    return dict(cams=cams, rays=rays, points=points, isig=isig, attrs=attrs, sel=sel,
                table=fine.feature_table(points, isig))


@pytest.fixture(scope="module")
def sf(dev):
    """The ShapeFitting shapes: rays, the feature table, the global entry's
    selections."""
    verts, isig, colors, cams, targets = shapefit_scene(dev)
    rays, origins = camera_rays(*cams, SF_HW)
    P = verts.shape[0]
    points = verts[None] - origins[:, None, :]
    isig3 = (2.0 * expend_sigma(isig))[None].expand(SF_B, P, 3, 3)
    table = fine.feature_table(points, isig3)
    bs, mppb = fine.production_bin_geometry(SF_HW, SF_K, P, None, -1)
    assert mppb == -1, "the ShapeFitting geometry has a coarse stage"
    args = (rays, table, None, THR_ACT, SF_K, bs, 1.0)
    sel = fine_select_global(*args)
    return dict(verts=verts, isig=isig, colors=colors, cams=cams, targets=targets, rays=rays,
                table=table, bs=bs, args=args, sel=sel,
                cots=[seeded(sel[1].shape, dev, 50 + q) for q in range(4)])


@pytest.fixture(scope="module")
def tex(dev):
    """The texture scene, its K = 80 render and the sampler's inputs."""
    verts, isig, cams, image = texture_scene(dev)
    N = verts.shape[0]
    ctx = vt.precompute_camera_ctx(*cams, TEX_HW, N, max_assign=TEX_K)
    frag = vt.render_pipeline(verts, isig, *cams, image_size=TEX_HW, max_assign=TEX_K,
                              cam_ctx=ctx)
    rays, origins = camera_rays(*cams, TEX_HW)
    points = verts[None] - origins[:, None, :]
    isg = 2.0 * expend_sigma(isig)[None]
    aug = torch.cat([image, torch.ones_like(image[..., :1])], dim=-1).contiguous()
    return dict(verts=verts, isig=isig, cams=cams, image=image, N=N, ctx=ctx, frag=frag,
                idx=frag.vert_index, w=frag.vert_weight, rays=rays, points=points, isg=isg,
                aug=aug, g_aug=seeded((N, 4), dev, 60))


@pytest.fixture(scope="module")
def bins(dev, head):
    """``rasterize_coarse``'s lists at the headline, the cap raised so that
    no bin truncates, and K2's per-bin-list entry at K = 20 on them."""
    g, cams = head["g"], head["cams"]
    rays, points, isig = head["rays"], head["points"], head["isig"]
    bs, mppb = coarse.coarse_bin_config((256, 256), 20, head["P"])
    bp, cnt = vt.ops.rasterize_coarse(*cams, points, isig, (256, 256), 0.01, bs, mppb,
                                      return_counts=True)
    densest = int(cnt.max())
    if densest > mppb:
        mppb = densest
        bp = vt.ops.rasterize_coarse(*cams, points, isig, (256, 256), 0.01, bs, mppb)
    table = fine.feature_table(points, isig)
    args = (rays, table, bp, THR_ACT, 20, bs)
    return dict(bs=bs, mppb=mppb, bp=bp, cnt=cnt, table=table, args=args,
                sel=fine_select_bins(*args),
                cots=[seeded(rays.shape[:3] + (20,), dev, 80 + q) for q in range(3)])


@pytest.fixture(scope="module")
def c300(dev):
    """The 300,000-point cloud, no coarse stage: K2's global entry's
    selections and the halves' inputs with only g_w set."""
    verts, isig, cams = cloud_scene(300_000, dev)
    rays, origins = camera_rays(*cams, CLOUD_HW)
    points = verts[None] - origins[:, None, :]
    isg = (2.0 * expend_sigma(isig))[None]
    table = fine.feature_table(points, isg)
    bs, mppb = fine.production_bin_geometry(CLOUD_HW, CLOUD_K, verts.shape[0], None, -1)
    assert mppb == -1, "the 300K geometry has a coarse stage"
    args = (rays, table, None, THR_ACT, CLOUD_K, bs, 1.0)
    sel = fine_select_global(*args)
    cots = [seeded(sel[1].shape, dev, 90 + q) for q in range(4)]
    folded = fold_weights(sel[1], sel[2], sel[3], sel[4], cots[3], 1.0)
    halves = (rays, table, sel[0], sel[1], sel[3], *folded)
    return dict(verts=verts, isig=isig, cams=cams, rays=rays, points=points, isg=isg,
                table=table, bs=bs, args=args, sel=sel, cots=cots, halves=halves,
                colors=((verts + 1) / 2).contiguous())


@pytest.fixture(scope="module")
def c100(dev):
    """The 100,000-point cloud of ``bench.py:108-137`` with its coarse stage."""
    verts, isig, cams = cloud_scene(100_000, dev)
    _, origins = camera_rays(*cams, CLOUD_HW)
    points = verts[None] - origins[:, None, :]
    return dict(verts=verts, isig=isig, cams=cams, origins=origins, points=points,
                isg=(2.0 * expend_sigma(isig))[None])


# ---- the kernels at the main paths' shapes -----------------------------------------

@pytest.mark.parametrize("tag", ["small", "headline"])
def test_compacted_kernels_at_the_main_shapes(dev, tag):
    """K2's compacted entry at K = 5 and 20 with and without attributes, the
    fold, K3 (with and without attributes and ray gradients; the mean sums
    and the per-ray half) with seeded cotangents, then K3f and K4b on the
    K = 20 selections with colours, on the 1K scene at 128x128 and the 10K
    headline at 256x256."""
    n, hw, focal = {"small": (1000, (128, 128), 150.0), "headline": (10000, (256, 256), 300.0)}[tag]
    g, cams, colors = scene(n, hw, focal, dev)
    rays, points, isig = stage_inputs(g, cams, hw)
    for K in (5, 20):
        c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
        assert int(c.overflow_c.sum()) == 0, f"{tag} overflow"
        table = fine.feature_table(points, isig)
        for attrs in (None, colors):
            args = (rays, table, c.bits_c, c.ids_c, c.counts_c, c.thr_act, K, c.bin_size, 1.0,
                    attrs)
            got = fine_select(*args)
            compare_select(got, fine_select_plain(*args))
        sel = got  # K, attrs = this K, colours
        g_cot = [seeded(sel[1].shape, dev, 10 + q) for q in range(4)]
        g_img = seeded(rays.shape, dev, 20)
        f_args = (*sel[1:5], g_cot[3], 1.0)
        for a, b in zip(fold_weights(*f_args), fold_weights_plain(*f_args)):
            grad_err(a, b, f"fold {tag} K={K}")
        feats = fine.feature_table(points, isig)
        for with_attrs in (False, True):
            for want_rays in (False, True):
                hold_k3("fine_bwd", (rays, feats, *sel[:5], *g_cot, 1.0,
                                     colors if with_attrs else None,
                                     g_img if with_attrs else None, want_rays))
    idx, w = got[0], got[4]
    e = (attr_merge(idx, w, colors) - attr_merge_plain(idx, w, colors)).abs().max().item()
    assert e <= 1e-5, f"K3f {tag} error {e}"
    g_att = seeded(idx.shape[:-1] + (3,), dev, 30)
    for a, b in zip(attr_merge_bwd(idx, w, colors, g_att),
                    attr_merge_bwd_plain(idx, w, colors, g_att)):
        grad_err(a, b, f"K4b {tag}")


@pytest.mark.parametrize("K", [5, 40, 80, 128])
def test_k3_and_the_fold_at_every_k_on_the_1k_scene(dev, small, K):
    """K3's compacted entry with colours, with and without rays, and the fold
    on the 1K scene's selections at K."""
    rays, points, isig, cams = small["rays"], small["points"], small["isig"], small["cams"]
    colors = small["colors"].contiguous()
    c = fine.compact_candidates(*cams, points, isig, (128, 128), 0.01, K)
    tab = fine.feature_table(points, isig)
    sel = fine_select(rays, tab, c.bits_c, c.ids_c, c.counts_c, c.thr_act, K, c.bin_size, 1.0,
                      colors)
    g_cot = [seeded(sel[1].shape, dev, 100 + q) for q in range(4)]
    g_img = seeded(rays.shape, dev, 104)
    for want_rays in (False, True):
        hold_k3("fine_bwd", (rays, small["table"], *sel[:5], *g_cot, 1.0, colors, g_img,
                             want_rays))
    f_args = (*sel[1:5], g_cot[3], 1.0)
    for a, b in zip(fold_weights(*f_args), fold_weights_plain(*f_args)):
        grad_err(a, b, f"fold 1K K={K}")


def test_k3_at_the_pose_batch(dev, pose8):
    """K3's compacted entry on the headline scene seen by 8 cameras (K = 20,
    ray gradients), with and without the colours."""
    sel, attrs = pose8["sel"], pose8["attrs"]
    g_cot = [seeded(sel[1].shape, dev, 110 + q) for q in range(4)]
    for with_attrs in (False, True):
        hold_k3("fine_bwd", (pose8["rays"], pose8["table"], *sel[:5], *g_cot, 1.0,
                             attrs if with_attrs else None,
                             seeded(pose8["rays"].shape, dev, 114) if with_attrs else None, True))


# ---- K2's compacted entry reads its candidates' rows by id -------------------------

SCORE_B = 32    # the pose scorer's chunk (portbench's score32 cell)


def test_compacted_select_at_the_score_batch(dev, head):
    """K2's compacted entry on the headline scene seen by 32 poses at
    256x256 (K = 20, no attributes: the pose scorer's render), reading its
    rows from the (32 * P, 16) feature table by id: equal to its plain
    version (``equal_select``), two runs equal to the bit, and the select
    counts the per-slot copy it spares."""
    g = head["g"]
    R, T = vt.look_at_view_transform(
        dist=[6.0] * SCORE_B, elev=list(np.linspace(5, 25, SCORE_B)),
        azim=list(np.linspace(0, 360, SCORE_B, endpoint=False)), device=dev)
    cams = (R, T, torch.tensor([[300.0, 300.0]] * SCORE_B, device=dev),
            torch.tensor([[128.0, 128.0]] * SCORE_B, device=dev))
    rays, origins = camera_rays(*cams, (256, 256))
    points = g.verts.detach()[None] - origins[:, None, :]
    isig = 2.0 * expend_sigma(g.sigmas.detach())[None].expand(SCORE_B, -1, 3, 3)
    c = fine.compact_candidates(*cams, points, isig, (256, 256), 0.01, 20)
    assert int(c.overflow_c.sum()) == 0 and (c.ids_c < 0).any()
    args = (rays, fine.feature_table(points, isig), c.bits_c, c.ids_c, c.counts_c, c.thr_act,
            20, c.bin_size, 1.0, None)
    with trace.tracing():
        got = fine_select(*args)
        n = trace.counts()
    assert n["select.copy_bytes_avoided"] == 64 * c.ids_c.numel()
    assert all(torch.equal(a, b) for a, b in zip(got[:5], fine_select(*args)[:5]))
    equal_select(got, fine_select_plain(*args))
    assert (got[0] >= 0).any() and int(got[0].max()) >= (SCORE_B - 1) * head["P"]


@pytest.mark.parametrize("attrs", [False, True])
def test_compacted_select_reads_nothing_past_the_table_or_the_counts(dev, small, attrs):
    """The feature table (the 1K scene's rows for two cameras at one pose)
    and the slots' ids each end at the end of mapped memory, so a read one
    row past the table or one id past the slots faults.  The last supertile
    is full (its count is M) and its last slot names the table's last row,
    in every sub-bin, so the kernel stages that row; the slots past every
    other count hold valid ids and all four bits, so a kernel that read a
    slot at or past its count would take it as a candidate and differ from
    the plain version; two counted slots of the densest supertile name -1
    and the row one past the table, which no ray may take."""
    rays1, points1, isig1, cams1 = small["rays"], small["points"], small["isig"], small["cams"]
    c = fine.compact_candidates(*cams1, points1, isig1, (128, 128), 0.01, 20)
    B, P = 2, points1.shape[1]
    rays = rays1.expand(B, -1, -1, -1).contiguous()
    table = fine.feature_table(points1.expand(B, -1, -1), isig1.expand(B, -1, -1, -1))
    nb1, M = c.ids_c.shape
    gen = torch.Generator(dev).manual_seed(43)
    img = torch.arange(2 * nb1, device=dev)[:, None] // nb1
    counts = torch.cat([c.counts_c, c.counts_c])
    counts[-1] = M
    pos = torch.cat([c.pos_c, c.pos_c])
    pos[-1] = torch.arange(M, device=dev) * (P - 1) // M
    pos[-1, -1] = P - 1
    occupied = torch.arange(M, device=dev)[None] < counts[:, None]
    past = torch.randint(0, P, (2 * nb1, M), device=dev, generator=gen)
    ids = (img * P + torch.where(occupied, pos, past)).to(torch.int32)
    bits = torch.where(occupied, torch.cat([c.bits_c, c.bits_c]), 0xF).to(torch.int32)
    bits[-1, -1] = 0xF
    dense = int(counts[:-1].argmax())
    ids[dense, :2] = torch.tensor([-1, B * P], dtype=torch.int32, device=dev)
    assert int(ids[-1, -1]) == B * P - 1 and int(counts[-1]) == M and int(counts[dense]) > 2
    colors = torch.rand((B * P, 3), device=dev, generator=gen) if attrs else None
    args = (rays, table, bits, ids, counts, c.thr_act, 20, c.bin_size, 1.0, colors)
    want = fine_select_plain(*args)
    bufs = [AtTheEnd(table.numel(), dev), AtTheEnd(ids.numel(), dev, torch.int32)]
    try:
        t_end, i_end = bufs[0].tensor.view(table.shape), bufs[1].tensor.view(ids.shape)
        t_end.copy_(table)
        i_end.copy_(ids)
        got = fine_select(rays, t_end, bits, i_end, counts, *args[5:])
        torch.cuda.synchronize()
    finally:
        for b in bufs:
            b.free()
    equal_select(got, want)
    assert (got[0] >= 0).any() and (got[0] >= P).any()


def test_global_entries_at_the_shapefit_shapes(dev, sf):
    """K2's global entry with and without a random sub-bin bits plane
    (selections exact), its cull's glue, and K3's global entry with the
    weight cotangent set, zero, absent and alone, with and without ray
    gradients: the skipped fold equal to the bit to a zero g_w."""
    rays, table, bs = sf["rays"], sf["table"], sf["bs"]
    nb = SF_B * math.prod(coarse.supertile_grid(*SF_HW, bs))
    bits_sf = torch.randint(0, 16, (nb, table.shape[0] // SF_B), dtype=torch.int32, device=dev,
                            generator=torch.Generator(dev).manual_seed(40))
    for bits in (None, bits_sf):
        args = (rays, table, bits, THR_ACT, SF_K, bs, 1.0)
        got, want = fine_select_global(*args), fine_select_global_plain(*args)
        assert torch.equal(got[0], want[0]), f"K2 global bits={bits is not None}: selections differ"
        compare_select(got, want)
    hold_cull_glue(rays, table, bs)
    g_sf = sf["cots"]
    zero_gw = {}
    for kind, cots in (("all", g_sf), ("zero g_w", g_sf[:3] + [torch.zeros_like(g_sf[3])]),
                       ("no g_w", g_sf[:3] + [None]), ("only g_w", [None, None, None, g_sf[3]])):
        for want_rays in (False, True):
            out = hold_k3("fine_bwd_global", (rays, table, *sf["sel"], *cots, 1.0, want_rays))
            if kind == "zero g_w":
                zero_gw[want_rays] = out
            elif kind == "no g_w":   # the fold skipped: the same bits as a zero g_w
                assert all(a is None and b is None or torch.equal(a, b)
                           for a, b in zip(out, zero_gw[want_rays])), \
                    "K3 global shapefit: the skipped fold differs from a zero g_w"


def test_attr_halves_and_k2_at_the_texture_shapes(dev, tex):
    """``attr_scatter`` and ``attr_dw`` on the texture render's slots (4, 8
    and 11 channels), and K2's compacted entry on its rows at K = 80 with
    and without attributes (selections exact and the render's own)."""
    idx, w, aug, N = tex["idx"], tex["w"], tex["aug"], tex["N"]
    grad_err(attr_scatter(idx, w, aug, N), attr_scatter_plain(idx, w, aug, N),
             "attr_scatter texture")
    grad_err(attr_dw(idx, tex["g_aug"], aug), attr_dw_plain(idx, tex["g_aug"], aug),
             "attr_dw texture")
    for d in (8, 11):   # wider rows: one and two channel passes of the scatter
        g_d = seeded(idx.shape[:3] + (d,), dev, 61)
        a_d = seeded((N, d), dev, 62)
        grad_err(attr_scatter(idx, w, g_d, N), attr_scatter_plain(idx, w, g_d, N),
                 f"attr_scatter d={d}")
        grad_err(attr_dw(idx, a_d, g_d), attr_dw_plain(idx, a_d, g_d), f"attr_dw d={d}")
    cams, points, isg = tex["cams"], tex["points"], tex["isg"]
    c = fine.compact_candidates(*cams, points, isg, TEX_HW, 0.01, TEX_K)
    assert int(c.overflow_c.sum()) == 0, "texture coarse stage overflow"
    tab = fine.feature_table(points, isg)
    colors = torch.rand((N, 3), device=dev, generator=torch.Generator(dev).manual_seed(65))
    for attrs in (None, colors):
        args = (tex["rays"], tab, c.bits_c, c.ids_c, c.counts_c, c.thr_act, TEX_K, c.bin_size,
                1.0, attrs)
        got, want = fine_select(*args), fine_select_plain(*args)
        assert torch.equal(got[0], want[0]), f"K2 texture attrs={attrs is not None}: selections differ"
        compare_select(got, want)
        if attrs is None:
            assert torch.equal(got[0], idx), "K2 texture: not the render's selections"


@pytest.mark.parametrize("K", [1, 3, 20, 80, 128])
@pytest.mark.parametrize("d", [1, 3, 4, 5, 8, 33])
def test_attr_merge_and_dw_on_seven_pixels(dev, d, K):
    """K3f and ``attr_dw`` on 7 pixels of seeded slots (ids of -1 and beyond
    the table of 300 rows)."""
    hold_attr_pair(*edge_slots(dev, 7, K, d, 300, 70 + d + K + 7))


@pytest.mark.parametrize("shape", ["headline", "texture"])
def test_attr_merge_and_dw_at_the_main_shapes(head, tex, shape):
    """K3f and ``attr_dw`` on the headline's K = 20 selections with colours
    and on the texture render's slots with the photo's channels."""
    if shape == "headline":
        sel = head["sel"]
        hold_attr_pair(sel[0], sel[4], head["colors"], head["g_att"])
    else:
        hold_attr_pair(tex["idx"], tex["w"], tex["g_aug"], tex["aug"])


def test_bins_entry_and_k3_global_on_the_headline_lists(dev, head, bins):
    """K2's per-bin-list entry on ``rasterize_coarse``'s lists at the
    headline at K = 5, 20 and 80 (selections exact), and K3's global entry on
    its outputs with no weights (the fold skipped, equal to the bit to a zero
    w and g_w)."""
    rays, table, bp, bs = head["rays"], bins["table"], bins["bp"], bins["bs"]
    for K in (5, 20, 80):
        args = (rays, table, bp, THR_ACT, K, bs)
        got, want = fine_select_bins(*args), fine_select_bins_plain(*args)
        assert torch.equal(got[0], want[0]), f"K2 bins K={K}: selections differ"
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=LAD_TOL, atol=LAD_TOL)
    sel = bins["sel"]
    cots = [seeded(sel[1].shape, dev, 120 + q) for q in range(3)]
    skipped = hold_k3("fine_bwd_global", (rays, table, *sel, None, *cots, None, 1.0, True))
    zero = torch.zeros_like(sel[1])
    assert all(torch.equal(a, b) for a, b in zip(
        skipped, fine_bwd_global(rays, table, *sel, zero, *cots, zero, 1.0, True))), \
        "K3 two-stage: the skipped fold differs from a zero g_w"


@pytest.mark.parametrize("shape", ["shapefit", "cloud_300k"])
def test_split_halves_at_the_main_shapes(sf, c300, shape):
    """The global backward's two halves at the ShapeFitting shapes and on the
    300,000-point cloud, with seeded cotangents."""
    s = sf if shape == "shapefit" else c300
    hold_halves(s["rays"], s["table"], s["sel"], s["cots"])


def test_global_select_on_the_300k_cloud(dev, c300):
    """K2's global entry at 300,000 points: a 32x32 crop equal to the whole
    image's and to the plain version, the whole image against the coarse
    path's selections, two runs equal, equal to the bit with the cull off;
    its glue against the plain versions; the benchmark cell's four cameras
    on the two-level route, equal to the bit with the cull off."""
    rays, table, args, sel = c300["rays"], c300["table"], c300["args"], c300["sel"]
    y0 = x0 = 160   # a 32x32 window of the rays against all 300,000 Gaussians
    crop = rays[:, y0:y0 + 32, x0:x0 + 32].contiguous()
    got = fine_select_global(crop, table, None, THR_ACT, CLOUD_K, c300["bs"], 1.0)
    assert all(torch.equal(a, b[:, y0:y0 + 32, x0:x0 + 32]) for a, b in zip(got, sel)), \
        "K2 global 300K: the crop's selections are not the whole image's"
    # the plain version in 8x8 tiles (its dense arrays are rays x Gaussians)
    want = fine_select_global_plain(crop, table, None, THR_ACT, CLOUD_K, 4, 1.0)
    assert torch.equal(got[0], want[0]), "K2 global 300K crop: selections differ from the plain version"
    compare_select(got, want)
    del got, want
    sel_r, ovf = fine.ray_tracing(c300["cams"], c300["points"], c300["isg"], rays, CLOUD_HW,
                                  0.01, CLOUD_K)
    assert int(ovf) == 0, "300K coarse path overflow"
    agree = (sel_r[0] == sel[0]).all(-1)
    flips = 1.0 - agree.float().mean().item()
    assert flips < FLIP_MAX, f"K2 global 300K vs the coarse path: {flips} of the pixels differ"
    for a, b in zip(sel[1:4], sel_r[1:4]):
        torch.testing.assert_close(a[agree], b[agree], rtol=LAD_TOL, atol=LAD_TOL)
    del sel_r
    assert all(torch.equal(a, b) for a, b in zip(sel, fine_select_global(*args))), \
        "K2 global 300K: two runs differ"
    assert all(torch.equal(a, b) for a, b in zip(sel, fine_select_global(*args, _cull=False))), \
        "K2 global 300K: the cull changed a result"
    hold_cull_glue(rays, table, c300["bs"])
    # the benchmark cell's four cameras over the cloud: the two-level route
    cams = c300["cams"]
    R4, T4 = vt.look_at_view_transform(dist=[4.0] * 4, elev=[10.0, 16.7, 23.3, 30.0],
                                       azim=[20.0, 30.0, 40.0, 50.0], device=dev)
    cams4 = (R4, T4, cams[2].expand(4, 2), cams[3].expand(4, 2))
    rays4, origins4 = camera_rays(*cams4, CLOUD_HW)
    table4 = fine.feature_table(c300["verts"][None] - origins4[:, None, :],
                                c300["isg"].expand(4, -1, 3, 3))
    args4 = (rays4, table4, None, THR_ACT, CLOUD_K, c300["bs"], 1.0)
    with trace.tracing():
        sel4 = fine_select_global(*args4)
        assert launched("cull_lists") == 1, "K2 global 300K B=4: the two-level route did not run"
    assert all(torch.equal(a, b) for a, b in zip(sel4, fine_select_global(*args4, _cull=False))), \
        "K2 global 300K B=4: the two-level cull changed a result"


@pytest.fixture(scope="module")
def main_ids(head, sf, tex, bins, pose8, c300):
    """Every main path's slot ids and row counts."""
    return {"headline": (head["sel"][0], head["P"]),
            "shapefit": (sf["sel"][0], sf["table"].shape[0]),
            "texture": (tex["idx"], tex["N"]),
            "two_stage": (bins["sel"][0], bins["table"].shape[0]),
            "pose_b8": (pose8["sel"][0], pose8["rays"].shape[0] * head["P"]),
            "cloud_300k": (c300["sel"][0], c300["verts"].shape[0])}


@pytest.mark.parametrize("path", ["headline", "shapefit", "texture", "two_stage", "pose_b8",
                                  "cloud_300k"])
def test_slot_runs_on_each_main_paths_ids(main_ids, path):
    """The grouping of slots by id on the slot ids of each main path (one to
    three radix passes)."""
    hold_runs(*main_ids[path])


@pytest.fixture(scope="module")
def coarse_cells(dev, head, tex, pose8, c100):
    """The coarse stage's inputs at the headline, quickstart, texture, 100K
    and pose B = 8 shapes."""
    g_q, cams_q, _ = scene(1000, (256, 256), 300.0, dev)
    _, points_q, isig_q = stage_inputs(g_q, cams_q, (256, 256))
    return {"headline": (head["cams"], head["points"], head["isig"], (256, 256), 20),
            "quickstart": (cams_q, points_q, isig_q, (256, 256), 20),
            "texture": (tex["cams"], tex["points"], tex["isg"], TEX_HW, TEX_K),
            "cloud_100k": (c100["cams"], c100["points"], c100["isg"], CLOUD_HW, CLOUD_K),
            "pose_b8": (pose8["cams"], pose8["points"], pose8["isig"], POSE_HW, 20)}


@pytest.mark.parametrize("tag", ["headline", "quickstart", "texture", "cloud_100k", "pose_b8"])
def test_coarse_stage_at_the_main_shapes(dev, coarse_cells, tag):
    """The stage (``compact_candidates``, and with the inverse map) against
    the int64 route, bit for bit; each kernel (K1, the grouping, the globals,
    the rows with and without the inverse map) against its plain version at
    every window the render emitted with; the int64 keys' runs are the rows'
    counts; the texture scene alone re-emits; one host read a render, two
    where it re-emits, counted on the host call by call."""
    cams, points, isig, hw, K = coarse_cells[tag]
    B, P = points.shape[:2]
    call = lambda: fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
    c = call()
    with sorted_route():
        ref = call()
    assert all(torch.equal(a, b) for a, b in zip(c[:5], ref[:5])), \
        f"coarse stage {tag}: not the int64 route's rows"
    assert int(c.overflow_c.sum()) == 0, f"coarse stage {tag}: overflow"
    bs = c.bin_size
    kw = dict(row_align=fine._pick_cand_chunk(P), return_dst=True)
    d_new = coarse.emit_supertile_candidates(*cams, points, isig, hw, 0.01, bs, 0, **kw)
    with sorted_route():
        d_ref = coarse.emit_supertile_candidates(*cams, points, isig, hw, 0.01, bs, 0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(d_new[:5], c[:5])) and all(
        torch.equal(a, b) for a, b in zip(d_new[5], d_ref[5])), \
        f"coarse stage {tag}: the inverse map is not the int64 route's"
    nst, BH2, BW2, S, win0 = coarse.emission_geometry(P, hw, bs)
    win = math.isqrt(d_new[5][0].shape[-1])
    M = c.pos_c.shape[1]
    for w in sorted({win0, win}):
        k1 = (*cams, points, isig, 0.01, bs, hw, nst, BH2, BW2, w)
        em = emit_rows(*k1)
        assert all(torch.equal(a, b) for a, b in zip(em, emit_rows_plain(*k1))), \
            f"K1 {tag} win {w}: kernel and plain differ"
        rid, bits, planes, over, info = em
        order, starts = slot_runs(rid, B * nst)
        info_p = info.clone()
        g_args = (over, planes, starts, info, min(64, P), nst, BW2, bs, hw)
        glob = coarse_globals(*g_args)
        want = coarse_globals_plain(*g_args[:3], info_p, *g_args[4:])
        assert all(torch.equal(a, b) for a, b in zip(glob, want)) and torch.equal(info, info_p), \
            f"coarse_globals {tag} win {w}: kernel and plain differ"
        r_args = (order, starts, bits, glob[0], glob[2], glob[3], M, nst)
        for with_dst in (False, True):
            rows = coarse_rows(*r_args, with_dst)
            assert all(torch.equal(a, b)
                       for a, b in zip(rows, coarse_rows_plain(*r_args, with_dst))), \
                f"coarse_rows {tag} win {w} dst={with_dst}: kernel and plain differ"
    assert all(torch.equal(a, b) for a, b in zip(rows[:5], c[:5])), \
        f"coarse_rows {tag}: not the stage's rows"
    # the int64 keys the route sorts (local cells, then global members)
    idx = torch.arange(P, device=dev)[:, None]
    big = B * nst * S * 16
    gpos, g_valid, bits_g, _ = glob
    kg = ((torch.arange(B * nst, device=dev).reshape(B, 1, nst) * S + gpos.long()[..., None])
          * 16 + bits_g.long())
    keys = torch.cat([torch.where(rid >= 0, (rid.long() * S + idx) * 16 + bits.long(),
                                  big).reshape(-1),
                      torch.where((bits_g != 0) & g_valid[..., None], kg, big).reshape(-1)])
    edges = torch.arange(B * nst + 1, device=dev) * (S * 16)
    assert torch.equal(torch.searchsorted(torch.sort(keys)[0], edges).diff(),
                       c.counts_c.long()), f"coarse stage {tag}: the int64 keys' runs"
    assert (win != win0) == (tag == "texture"), "the texture scene alone re-emits"
    syncs = host_syncs(call, 10)
    assert syncs == [2 if tag == "texture" else 1] * len(syncs), \
        f"coarse stage {tag}: not one host read a render (two when it re-emits): {syncs}"


def test_fold_then_pair_equals_the_unified_entry_at_the_main_shapes(head, sf, bins, c300):
    """The fold's entry + the split pair against the unified entry on the
    same cotangents (normwise PAIR_TOL) at the 300,000-point step's (only g_w,
    ray gradient), the ShapeFitting step's (only g_w, no ray gradient) and
    the two-stage tracer's (g_len, g_act, g_dsd, no weights, ray gradient)."""
    two = tuple(x.detach() for x in vt.ops.ray_tracing_fine(
        head["points"].reshape(-1, 3), head["isig"].reshape(-1, 3, 3), head["rays"], bins["bp"],
        0.01, bins["bs"], 20))
    k3 = {"cloud_300k": (c300["rays"], c300["table"], *c300["sel"], None, None, None,
                         c300["cots"][3], 1.0, True),
          "shapefit": (sf["rays"], sf["table"], *sf["sel"], None, None, None, sf["cots"][3],
                       1.0, False),
          "two_stage": (head["rays"], bins["table"], *two, None, *bins["cots"], None, 1.0, True)}
    for tag, args in k3.items():
        for a, b in zip(fold_then_pair(*args), fine_bwd_global(*args)):
            assert (a is None and b is None) or rel_t(a, b) <= PAIR_TOL, \
                f"fold + pair vs the unified entry at the {tag} shapes"


def test_rows_6_and_7_compose_at_the_300k_cloud(c300):
    """``fine_bwd_gauss``'s stages composed at the lanes the rule picks equal
    ``fine_bwd_gauss``; a frozen scene's backward as one launch with the fold
    fused in equals the fold's entry followed by the unfused per-ray launch."""
    halves, sel = c300["halves"], c300["sel"]
    rays, table, idx, length, dsd = halves[:5]
    coef = cuda_fine_bwd._slots_stage(rays, table, idx, length, None, dsd, None,
                                      (*halves[5:], None), 1.0, None, None, True, False)[0]
    order, starts = slot_runs(idx, table.shape[0])
    composed = cuda_fine_bwd._runs_stage(rays, table, coef, None, None, order, starts,
                                         group_width(idx.numel(), table.shape[0]))
    assert torch.equal(composed, fine_bwd_gauss(*halves)), \
        "row 6 at 300K: the composed stages differ from fine_bwd_gauss"
    idx_c, len_c, act_c, dsd_c, w_c = sel
    frozen = (rays, table, idx_c, len_c, dsd_c, None, None, None)
    g_w = c300["cots"][3]
    fused = fine_bwd_rays(*frozen, act=act_c, w=w_c, g_w=g_w, agg_ow=1.0)
    unfused = fine_bwd_rays(*frozen[:5], *fold_weights(len_c, act_c, dsd_c, w_c, g_w, 1.0))
    assert torch.equal(fused, unfused), \
        "frozen 300K backward: the fused launch differs from the fold + the per-ray half"


def test_library_calls_compute_the_kernels_functions(head, tex):
    """The one-call PyTorch yardsticks ``chip_smoke.py`` times beside the
    kernels compute their functions: ``index_add_`` the texture scatter's
    (within 1e-4 of its largest entry), ``embedding_bag`` the headline
    merge's (within 1e-5)."""
    idx_s, w_s, g_s, N = tex["idx"], tex["w"], tex["aug"], tex["N"]
    ok = idx_s >= 0
    seg = torch.where(ok, idx_s, N).long().reshape(-1)
    vals = (torch.where(ok, w_s, 0.0)[..., None] * g_s[..., None, :]).reshape(-1, 4)
    acc = torch.zeros((N + 1, 4), device=idx_s.device).index_add_(0, seg, vals)
    e = (acc[:N] - attr_scatter(idx_s, w_s, g_s, N)).abs().max().item()
    assert e <= GRAD_TOL * acc.abs().max().item(), f"index_add_ vs attr_scatter {e}"
    idx, w, attrs = head["sel"][0], head["sel"][4], head["colors"]
    bag_idx = torch.where(idx >= 0, idx, attrs.shape[0]).long().reshape(-1, idx.shape[-1])
    bag_rows = torch.cat([attrs, torch.zeros_like(attrs[:1])])
    bag = torch.nn.functional.embedding_bag(bag_idx, bag_rows, per_sample_weights=w.reshape(
        bag_idx.shape), mode="sum", padding_idx=attrs.shape[0])
    e = (bag.reshape(idx.shape[:-1] + (-1,)) - attr_merge(idx, w, attrs)).abs().max().item()
    assert e <= 1e-5, f"embedding_bag vs attr_merge {e}"


# ---- the main paths at full width ---------------------------------------------------

def test_headline_forward(dev, head):
    """``render_pipeline(attrs=)`` and ``GaussianRenderer`` (also with numpy
    ``R``, ``T`` beside cameras on the card) + ``to_white_background`` at the
    headline: K1, K2, K3f launched, overflow 0, finite, the two entries'
    selections equal, the fused image equal to the merge's."""
    g, cams, colors = head["g"], head["cams"], head["colors"]
    R, T = cams[:2]
    hw = (256, 256)
    with main_path((*COARSE, "fine_select", "attr_merge")):
        frag = vt.render_pipeline(g.verts, g.sigmas, *cams, image_size=hw, max_assign=20,
                                  attrs=colors)
        cam_obj = vt.PerspectiveCameras(focal_length=300.0, principal_point=((128.0, 128.0),),
                                        image_size=(hw,), device=dev)
        renderer = vt.GaussianRenderer(cam_obj, vt.GaussianRenderSettings(image_size=hw))
        frag2 = renderer(g, R=R, T=T)
        white = vt.to_white_background(frag2, colors)
        frag_np = renderer(g, R=R.cpu().numpy().astype(np.float64), T=T.cpu().numpy())
    assert frag_np.vert_index.is_cuda and torch.equal(frag_np.vert_index, frag2.vert_index) \
        and torch.equal(frag_np.vert_weight, frag2.vert_weight), \
        "GaussianRenderer with numpy R, T differs from the call with card tensors"
    for f in (frag, frag2):
        assert vt.get_overflow_points(f) == 0, "headline overflow_points != 0"
        assert torch.isfinite(f.vert_weight).all().item(), "non-finite weights"
    assert frag.attr_img.shape == (1, 256, 256, 3) and white.shape == (1, 256, 256, 3)
    assert torch.isfinite(frag.attr_img).all().item() and torch.isfinite(white).all().item()
    assert torch.equal(frag.vert_index, frag2.vert_index), "render paths disagree"
    fused_vs_merge = (frag.attr_img - vt.interpolate_attr(frag, colors)).abs().max().item()
    assert fused_vs_merge <= 1e-5, f"fused attr image vs merge {fused_vs_merge}"


@pytest.mark.parametrize("tag", ["headline", "1k"])
def test_fitting_step_against_its_golden_file(dev, head, tag):
    """The fitting step (``render_pipeline(attrs=, cam_ctx=)`` -> bench's
    loss -> backward; K1, K2, K3) at the headline, two backward runs equal
    to the bit, and at 1K 128x128: the loss and the gradients of verts,
    sigmas and colours against ``voge_tpu_golden_grad_{10k_256,1k_128}.npz``."""
    gold = np.load(GOLDEN_GRAD[tag])
    if tag == "headline":
        g, cams, colors = head["g"], head["cams"], head["colors"]
        ctx = vt.precompute_camera_ctx(*cams, (256, 256), g.verts.shape[0], max_assign=20)
        with main_path(PATH_KERNELS["fitting_step"]):
            frag, loss, params = fitting_step(g, cams, colors, (256, 256), ctx)
            grads = torch.autograd.grad(loss, params, retain_graph=True)
            grads2 = torch.autograd.grad(loss, params)
        for name, a, b in zip(("verts", "sigmas", "colors"), grads, grads2):
            assert bool(torch.isfinite(a).all()), f"non-finite {name} gradient"
            assert torch.equal(a, b), f"{name} gradient differs between two backward runs"
    else:
        g, cams, colors = scene(1000, (128, 128), 150.0, dev)
        frag, loss, params = fitting_step(g, cams, colors, (128, 128))
        grads = torch.autograd.grad(loss, params)
    assert vt.get_overflow_points(frag) == 0, f"{tag} fitting step overflow_points != 0"
    lv = loss.item()
    e = abs(lv - float(gold["loss"])) / abs(float(gold["loss"]))
    assert e <= GOLD_LOSS_TOL, f"golden {tag} loss {lv} vs {float(gold['loss'])}"
    for name, x in zip(("verts", "sigmas", "colors"), grads):
        e = rel(x.cpu().numpy(), gold["grad_" + name])
        assert e <= GOLD_GRAD_TOL, f"golden {tag} grad {name} rel err {e:.3e}"


def test_quickstart_white_background_step_matches_the_plain_path(dev):
    """The 1K quickstart through ``GaussianRenderer`` -> ``to_white_background``
    -> mean-squared loss -> backward (K1, K2, K3, K3f, K4b): gradients
    against the plain path on the card."""
    hw = (256, 256)
    q, qcams, qcolors = scene(1000, hw, 300.0, dev)
    qcam = vt.PerspectiveCameras(focal_length=300.0, principal_point=((128.0, 128.0),),
                                 image_size=(hw,), device=dev)
    qrend = vt.GaussianRenderer(qcam, vt.GaussianRenderSettings(image_size=hw))
    target = torch.rand((1, 256, 256, 3), device=dev, generator=torch.Generator(dev).manual_seed(7))

    def white_step():
        cols = qcolors.detach().requires_grad_(True)
        img = vt.to_white_background(qrend(q, R=qcams[0], T=qcams[1]), cols)
        return torch.autograd.grad(((img - target) ** 2).mean(), (q.verts, cols))

    with main_path(PATH_KERNELS["white_background_step"]):
        wg = white_step()
    with plain_path():
        wp = white_step()
    for n, a, b in zip(("verts", "colors"), wg, wp):
        grad_err(a, b, f"white-background grad {n}")


def test_1k_forward_against_its_golden_file(dev):
    """The 1K cuboid at 128x128, K = 20, colours: selections, weights and
    image against ``voge_tpu_golden_1k_128.npz``."""
    gold = np.load(GOLDEN)
    g1, cams1, colors1 = scene(1000, (128, 128), 150.0, dev)
    f1 = vt.render_pipeline(g1.verts, g1.sigmas, *cams1, image_size=(128, 128), max_assign=20,
                            attrs=colors1)
    gi = torch.as_tensor(gold["vert_index"], device=dev)
    agree = (f1.vert_index == gi).all(-1)
    flips = 1.0 - agree.float().mean().item()
    assert flips < FLIP_MAX, f"golden flips {flips}"
    for name, val in (("vert_weight", f1.vert_weight), ("attr_img", f1.attr_img)):
        ref = torch.as_tensor(gold[name], device=dev)
        e = (val[agree] - ref[agree]).abs().max().item()
        assert e <= W_TOL, f"golden {name} error {e}"
    assert vt.get_overflow_points(f1) == 0, "golden scene overflow"


def test_quickstart_bounds(dev):
    """The 1K quickstart at 256x256: its weight sum and silhouette in their
    bounds, the white background's corners white."""
    q, qcams, qcolors = scene(1000, (256, 256), 300.0, dev)
    fq = vt.render_pipeline(q.verts, q.sigmas, *qcams, image_size=(256, 256), max_assign=20)
    wsum = fq.vert_weight.sum().item()
    sil = vt.get_silhouette(fq).mean().item()
    qimg = vt.to_white_background(fq, qcolors)
    assert 25000 < wsum < 31000 and 0.25 < sil < 0.45, f"quickstart bounds {wsum} {sil}"
    assert qimg[0, 0, 0].min().item() > 0.999 and qimg[0, -1, -1].min().item() > 0.999, \
        "quickstart corners not white"


def test_shapefit_step_against_its_golden_file(sf):
    """The full-width ShapeFitting step (K2 global, K3 global, K3f, K4b, no
    K1): overflow 0, two backward runs equal to the bit, the loss and the
    gradients against ``voge_tpu_golden_shapefit_128.npz``."""
    gold = np.load(GOLDEN_SF)
    with main_path(PATH_KERNELS["shapefit_step"]) as counts:
        leaves = [x.clone().requires_grad_(True) for x in (sf["verts"], sf["isig"], sf["colors"])]
        frag, loss = shapefit_loss(*leaves, sf["cams"], sf["targets"])
        gr = torch.autograd.grad(loss, leaves, retain_graph=True)
        gr2 = torch.autograd.grad(loss, leaves)
    compacted_unused(counts)
    assert vt.get_overflow_points(frag) == 0, "shapefit overflow_points != 0"
    e = abs(loss.item() - float(gold["loss"])) / abs(float(gold["loss"]))
    assert e <= GOLD_LOSS_TOL, f"shapefit loss {loss.item()} vs {float(gold['loss'])}"
    for name, a, b in zip(("verts", "sigmas", "colors"), gr, gr2):
        assert bool(torch.isfinite(a).all()), f"non-finite shapefit {name} gradient"
        assert torch.equal(a, b), f"shapefit {name} gradient differs between two backward runs"
        e = rel(a.cpu().numpy(), gold["grad_" + name])
        assert e <= GOLD_GRAD_TOL, f"shapefit grad {name} rel err {e:.3e}"


def test_three_shape_fitter_steps_against_the_golden_file(dev, sf):
    """Three ``models.ShapeFitter`` steps (default optimizer) at the
    ShapeFitting shapes: each loss to a relative 1e-5 and the parameters'
    displacement to a normwise relative 1e-3 of the golden file's."""
    gold = np.load(GOLDEN_SF)
    with main_path(PATH_KERNELS["shapefit_step"]) as counts:
        fitter = vt.ShapeFitter({"verts": sf["verts"], "colors": sf["colors"]},
                                {"sigmas": sf["isig"]}, image_size=SF_HW, focal=sf["cams"][2][0],
                                principal=sf["cams"][3][0], max_assign=SF_K, device=dev)
        fit_loss = [fitter.step(sf["cams"][0], sf["cams"][1], *sf["targets"]) for _ in range(3)]
    compacted_unused(counts)
    for i, (a, b) in enumerate(zip(fit_loss, gold["fit_loss"])):
        assert abs(a - float(b)) / abs(float(b)) <= GOLD_LOSS_TOL, \
            f"ShapeFitter step {i} loss {a} vs {float(b)}"
    for name, x0 in (("verts", sf["verts"]), ("colors", sf["colors"])):
        moved = (fitter.params[name].detach() - x0).cpu().numpy()
        e = rel(moved, gold[f"fit_{name}"] - x0.cpu().numpy())
        assert e <= GOLD_GRAD_TOL, f"ShapeFitter {name} rel err {e:.3e}"


def test_texture_chain_against_its_golden_file(tex):
    """Texture extraction at full width (render at K = 80 ->
    ``sample_features`` -> normalise -> ``to_white_background``; K1, K2,
    ``attr_scatter``, K3f, no plain version): overflow 0; selections,
    texture, weight sums and image against
    ``voge_tpu_golden_texture_256x672.npz``."""
    gold = np.load(GOLDEN_TEX)
    with main_path(PATH_KERNELS["texture_chain"], kernels_only=True):
        frag, wsum, tex_t, img = texture_chain(tex["verts"], tex["isig"], tex["cams"],
                                               tex["image"], tex["ctx"])
    assert vt.get_overflow_points(frag) == 0, "texture overflow_points != 0"
    assert img.shape == (1,) + TEX_HW + (3,) and bool(torch.isfinite(img).all()) \
        and bool(torch.isfinite(tex_t).all()), "texture image / texture not finite"
    same = (frag.valid_num[0].cpu().numpy() == gold["valid_num"])
    stride = TEX_HW[0] // gold["image"].shape[0]
    e = {"wsum": float(np.abs(wsum.cpu().numpy() - gold["wsum"]).max() / gold["wsum"].max()),
         "texture": float(np.abs(tex_t.cpu().numpy() - gold["texture"]).max()),
         "image": float(np.abs(img[0, ::stride, ::stride].cpu().numpy()
                               - gold["image"])[same[::stride, ::stride]].max(initial=0.0)),
         "weight_sum": float(np.abs(
             frag.vert_weight.sum(-1)[0, ::stride, ::stride].cpu().numpy()
             - gold["weight_sum"])[same[::stride, ::stride]].max(initial=0.0))}
    assert float(1.0 - same.mean()) < FLIP_MAX, f"texture selections: {1.0 - same.mean()} flipped"
    for k, v in e.items():
        assert v <= W_TOL, f"texture {k} vs voge_tpu golden: {v:.3e}"


def test_sampler_backward_matches_the_plain_path(dev, tex):
    """One backward through the sampler alone, the texture render's weights
    and the photo as leaves (``attr_dw``, K3f, the grouping): against the
    plain path, two runs equal to the bit."""
    N, frag = tex["N"], tex["frag"]
    cf, cw = seeded((N, 3), dev, 63), seeded((N,), dev, 64)

    def sampler_grads():
        w = frag.vert_weight.detach().clone().requires_grad_(True)
        img = tex["image"].clone().requires_grad_(True)
        fr = vt.Fragments(w, frag.vert_index, frag.valid_num, frag.vert_hit_length)
        feat, wsum = vt.sample_features(fr, img, n_vert=N)
        loss = (feat * cf).sum() + (wsum * cw).sum()
        first = torch.autograd.grad(loss, (w, img), retain_graph=True)
        return first, torch.autograd.grad(loss, (w, img))

    with main_path(PATH_KERNELS["sampler_backward"], kernels_only=True):
        sg, sg2 = sampler_grads()
    with plain_path():
        sp, _ = sampler_grads()
    for name, a, b, c in zip(("weights", "image"), sg, sg2, sp):
        assert torch.equal(a, b), f"sampler {name} gradient differs between two backward runs"
        grad_err(a, c, f"sampler grad {name}")


def test_two_stage_tracer_at_the_headline(head, bins):
    """``rasterize_coarse`` -> ``ray_tracing_fine`` -> a seeded linear loss at
    full width on the headline scene (K2's per-bin-list entry, K3's global
    entry with the ray gradient): no bin truncated, selections against the
    render path's, forward + backward against the plain path, two backward
    runs equal to the bit."""
    cams, points, isig, rays = head["cams"], head["points"], head["isig"], head["rays"]
    bs, mppb, cots = bins["bs"], bins["mppb"], bins["cots"]
    isg = isig.reshape(-1, 3, 3)

    def two_stage():
        bp = vt.ops.rasterize_coarse(*cams, points, isig, (256, 256), 0.01, bs, mppb)
        leaves = [x.detach().clone().requires_grad_(True) for x in (points.reshape(-1, 3), isg, rays)]
        sel = vt.ops.ray_tracing_fine(*leaves, bp, 0.01, bs, 20)
        v = sel[1] * cots[0] + sel[2] * cots[1] + sel[3] * cots[2]
        loss = torch.where(sel[0] >= 0, v, torch.zeros_like(v)).sum()
        return sel, torch.autograd.grad(loss, leaves)

    with main_path(PATH_KERNELS["two_stage_step"], kernels_only=True) as counts:
        sel, gr = two_stage()
        _, gr_b = two_stage()
    assert all(counts[k] == 0 for k in (*COARSE_KERNELS, "fine_select", "fine_select_global")), \
        "two-stage tracer: another path's select ran"
    assert int(bins["cnt"].max()) <= mppb, "two-stage tracer: a bin was truncated"
    sel_r, ovf = fine.ray_tracing(cams, points, isig, rays, (256, 256), 0.01, 20)
    assert int(ovf) == 0, "headline render overflow"
    agree = (sel[0] == sel_r[0]).all(-1)
    flips = 1.0 - agree.float().mean().item()
    assert flips < FLIP_MAX, f"two-stage vs render path: {flips} of the pixels differ"
    for a, b in zip(sel[1:], sel_r[1:4]):
        torch.testing.assert_close(a[agree], b[agree], rtol=LAD_TOL, atol=LAD_TOL)
    with plain_path():
        sel_p, gr_p = two_stage()
    assert torch.equal(sel[0], sel_p[0]), "two-stage: kernel and plain selections differ"
    for name, a, b, c in zip(("mus", "isigmas", "rays"), gr, gr_b, gr_p):
        assert bool(torch.isfinite(a).all()), f"two-stage: non-finite {name} gradient"
        assert torch.equal(a, b), f"two-stage {name} gradient differs between two backward runs"
        grad_err(a, c, f"two-stage grad {name}")


def test_cloud_100k_forward(c100):
    """``bench.py:108-137``'s published point cloud (100,000 fixed-radius
    Gaussians, 320x320, K = 20, default coarse stage; K1, K2's compacted
    entry, no plain version): overflow 0, selections against K2's global
    entry."""
    verts, isig, cams = c100["verts"], c100["isig"], c100["cams"]
    ctx = vt.precompute_camera_ctx(*cams, CLOUD_HW, verts.shape[0], max_assign=CLOUD_K)
    with main_path(PATH_KERNELS["cloud_100k_forward"], kernels_only=True) as counts:
        frag = vt.render_pipeline(verts, isig, *cams, image_size=CLOUD_HW, max_assign=CLOUD_K,
                                  cam_ctx=ctx)
    assert counts["fine_select_global"] == 0, "point cloud forward: the global select ran"
    assert vt.get_overflow_points(frag) == 0, "point cloud 100K overflow_points != 0"
    assert frag.vert_weight.shape == (1,) + CLOUD_HW + (CLOUD_K,) and bool(
        torch.isfinite(frag.vert_weight).all()), "point cloud 100K weights"
    assert torch.equal(ctx.origins, c100["origins"]), "point cloud 100K: the camera context's origins"
    bs, _ = fine.production_bin_geometry(CLOUD_HW, CLOUD_K, verts.shape[0], None, None)
    sel_g = fine_select_global(ctx.rays, fine.feature_table(c100["points"], c100["isg"]), None,
                               THR_ACT, CLOUD_K, bs, 1.0)
    agree = (frag.vert_index == sel_g[0]).all(-1)
    flips = 1.0 - agree.float().mean().item()
    assert flips < FLIP_MAX, f"point cloud 100K vs the global select: {flips} flipped"
    e = (frag.vert_weight[agree] - sel_g[4][agree]).abs().max().item()
    assert e <= W_TOL, f"point cloud 100K weights vs the global select: {e}"


def test_cloud_300k_step_equals_the_fold_and_pair(c300, monkeypatch):
    """The 300,000-point step past ``voge_tpu``'s branch point (K2 global,
    K3f, K4b's d_w half, K3's unified entry; no split, no compacted kernel):
    overflow 0, the selections held above, two backward runs equal to the
    bit, gradients of verts, sigmas, R and T against the same step on the
    fold's entry and the two halves."""
    args = (c300["verts"], c300["isig"], c300["cams"], c300["colors"])
    with main_path(PATH_KERNELS["cloud_300k_step"], kernels_only=True) as counts:
        frag, loss, leaves = cloud_step(*args)
        gr = torch.autograd.grad(loss, leaves, retain_graph=True)
        gr2 = torch.autograd.grad(loss, leaves)
    assert all(counts[k] == 0 for k in ("fold_weights", "fine_bwd_gauss", "fine_bwd_rays")), \
        "300K step: the split backward ran"
    compacted_unused(counts)
    assert vt.get_overflow_points(frag) == 0, "300K step overflow_points != 0"
    assert torch.equal(frag.vert_index, c300["sel"][0]), "300K step: not the selections held above"
    monkeypatch.setattr(fine, "fine_bwd_global", fold_then_pair)
    with trace.tracing():
        _, loss_u, leaves_u = cloud_step(*args)
        gu = torch.autograd.grad(loss_u, leaves_u)
        assert launched("fine_bwd_gauss") == 1, "the split pair did not run"
    for name, a, b, c in zip(("verts", "sigmas", "R", "T"), gr, gr2, gu):
        assert bool(torch.isfinite(a).all()), f"300K step: non-finite {name} gradient"
        assert torch.equal(a, b), f"300K step: {name} gradient differs between two backward runs"
        e = rel_t(a, c)
        assert e <= PAIR_TOL, f"300K step grad {name} vs the fold + pair {e:.3e}"


def test_frozen_scene_on_the_300k_cloud(dev, c300):
    """Only the cameras need a gradient: one launch of the per-ray half with
    the fold fused in, no per-Gaussian pass and no grouping; the ray
    gradient equal to the full backward's."""
    verts, cams, sel = c300["verts"], c300["cams"], c300["sel"]
    cw = seeded(sel[4].shape, dev, 95)

    def frozen_step(frozen):
        Rl, Tl = (x.detach().clone().requires_grad_(True) for x in cams[:2])
        r, o = camera_rays(Rl, Tl, cams[2], cams[3], CLOUD_HW)
        pts = (verts[None] - o[:, None, :]).detach().requires_grad_(not frozen)
        s, _ = fine.ray_tracing((Rl, Tl, cams[2], cams[3]), pts, c300["isg"], r, CLOUD_HW, 0.01,
                                CLOUD_K, max_points_per_bin=-1)
        loss = (s[4].sum(-1).clamp(max=1.0) ** 2).mean() + (s[4] * cw).mean()
        return torch.autograd.grad(loss, (Rl, r))     # (T moves the origins, not the rays)

    with main_path(PATH_KERNELS["frozen_300k_step"], kernels_only=True) as counts:
        fz = frozen_step(True)
    assert counts["fine_bwd_rays"] == 1 and counts["fold_weights"] == 0, \
        "frozen scene: the backward was not one launch of the per-ray half"
    assert counts["fine_bwd_gauss"] == 0 and counts["fine_bwd_global"] == 0 \
        and counts["slot_runs"] == 0, "frozen scene: a per-Gaussian pass or a grouping ran"
    with trace.tracing():
        full = frozen_step(False)
        assert launched("slot_runs") == 1, "the full step's per-Gaussian pass did not group the slots"
    assert all(bool(torch.isfinite(x).all()) for x in fz), "frozen scene: non-finite gradient"
    assert torch.equal(fz[1], full[1]), "frozen scene: the ray gradient is not the full step's"


@pytest.fixture(scope="module")
def pose(dev, head):
    """``bench.py:324-361``'s batched shape: the headline scene's scorer, its
    8 cameras and hypothesis 3's features as the target."""
    g, colors = head["g"], head["colors"]
    Rh, Th = vt.look_at_view_transform(dist=[6.0] * POSE_B, elev=list(np.linspace(5, 25, POSE_B)),
                                       azim=list(np.linspace(50, 90, POSE_B)), device=dev)
    scorer = vt.PoseHypothesisScorer(g.verts.detach(), g.sigmas.detach(), colors, focal=300.0,
                                     principal=(128.0, 128.0), image_size=POSE_HW, max_assign=20,
                                     chunk=POSE_B, device=dev)
    with torch.no_grad():
        target = scorer.render_features(Rh[3:4], Th[3:4])[0][0]
    return dict(scorer=scorer, R=Rh, T=Th, target=target,
                init=(6.0, math.radians(12.0), math.radians(64.0), 0.0))


def test_pose_scoring_and_refinement_at_b8(pose):
    """``PoseHypothesisScorer.score`` of 8 hypotheses in one chunk and three
    ``refine_pose`` steps (K1, K2, K3f, K4b's d_w half, the similarity
    kernel once for the score and once a step, its gradient's kernel once a
    step, K3's per-ray half alone, no grouping outside the coarse stage):
    the steps equal to the bit to the same steps with K3 whole; kernel path
    against plain path."""
    scorer, Rh, Th, target = pose["scorer"], pose["R"], pose["T"], pose["target"]
    with torch.no_grad():
        frag = vt.render_pipeline(scorer.verts, scorer.sigmas, Rh, Th,
                                  scorer.focal.expand(POSE_B, 2),
                                  scorer.principal.expand(POSE_B, 2), image_size=POSE_HW,
                                  max_assign=20)
    assert vt.get_overflow_points(frag) == 0, "pose batch overflow_points != 0"

    def pose_run():
        scores = scorer.score(Rh, Th, target)
        params, sim = vt.refine_pose(scorer, target, pose["init"], steps=3, lr=0.01)
        return scores, torch.stack([params[k] for k in ("dist", "elev", "azim", "theta")]), sim

    with main_path(PATH_KERNELS["pose_score_and_refine"], kernels_only=True) as counts:
        sc_k, pose_k, sim_k = pose_run()
    assert counts["fine_bwd"] == 0 and counts["fine_bwd_gauss"] == 0 \
        and counts["fine_bwd_rays"] == 3, "pose refinement: K3's per-Gaussian pass ran"
    assert counts["slot_runs"] == counts["emit_rows"], \
        "pose refinement: a grouping ran outside the coarse stage"
    assert counts["feature_similarity"] == 1 + 3 and counts["feature_similarity_grad"] == 3, \
        "pose: score's chunk and each refinement step did not take the similarity kernels"
    scorer.verts.requires_grad_(True)
    try:
        with trace.tracing():
            _, pose_f, sim_f = pose_run()
            assert launched("fine_bwd") == 3, "pose refinement: K3 did not run whole"
    finally:
        scorer.verts.requires_grad_(False)
    assert torch.equal(pose_k, pose_f) and sim_k == sim_f, \
        "pose refinement: the per-ray route differs from K3 whole"
    with plain_path():
        sc_p, pose_p, sim_p = pose_run()
    assert sc_k.shape == (POSE_B,) and int(sc_k.argmax()) == 3, f"pose scores {sc_k.tolist()}"
    e_sc = (sc_k - sc_p).abs().max().item()
    assert e_sc <= SCORE_TOL, f"pose scores kernel vs plain path {e_sc:.3e}"
    e_po = (pose_k - pose_p).abs().max().item()
    assert e_po <= POSE_TOL and abs(sim_k - sim_p) <= SCORE_TOL, \
        f"pose refinement kernel vs plain path {e_po:.3e}"


def test_pose_refinement_camera_gradients(dev, pose):
    """One refinement step's camera gradients (R, T and the four pose
    scalars) held to the plain path's, and equal to the bit to K3 whole's."""
    scorer, target = pose["scorer"], pose["target"]

    def pose_grads():
        params = [torch.tensor(v, dtype=torch.float32, device=dev, requires_grad=True)
                  for v in pose["init"]]
        R, T = vt.models.pose_matrices(*(p[None] for p in params))
        R_l, T_l = R.detach().requires_grad_(True), T.detach().requires_grad_(True)
        pred, _ = scorer.render_features(R_l, T_l)
        loss = -vt.models.feature_similarity(pred, target[None])[0]
        g_R, g_T = torch.autograd.grad(loss, (R_l, T_l))
        g_p = torch.autograd.grad((R * g_R).sum() + (T * g_T).sum(), params)
        return g_R, g_T, torch.stack(g_p)

    with no_plain_version():
        gr_k = pose_grads()
    scorer.verts.requires_grad_(True)
    try:
        gr_f = pose_grads()
    finally:
        scorer.verts.requires_grad_(False)
    assert all(torch.equal(a, b) for a, b in zip(gr_k, gr_f)), \
        "pose refinement: the camera gradients of the per-ray route differ from K3 whole"
    with plain_path():
        gr_p = pose_grads()
    for n, a, b in zip(("R", "T", "pose"), gr_k, gr_p):
        grad_err(a, b, f"pose refinement camera gradient {n}")


def test_batched_pose_refinement_at_b8(dev, pose):
    """``refine_pose`` of the pose batch's 8 cameras at once, 3 Adam steps,
    each pose offset from its camera and refined against its own target
    (the headline scene with 128 seeded features, as the benchmark's
    ``cuboid10k.refine_b32``): per step one launch of K3's per-ray half, no
    per-Gaussian K3, ``attr_dw``, the similarity kernel and its gradient's
    kernel launched; two runs equal to the bit; kernel path against plain
    path."""
    steps = 3
    scorer = pose["scorer"]
    feats = seeded((scorer.verts.shape[0], 128), dev, 115)
    feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
    s128 = vt.PoseHypothesisScorer(scorer.verts, scorer.sigmas, feats, focal=300.0,
                                   principal=(128.0, 128.0), image_size=POSE_HW, max_assign=20,
                                   chunk=POSE_B, device=dev)
    with torch.no_grad():
        targets = s128.render_features(pose["R"], pose["T"])[0]
    true = torch.tensor([[6.0, math.radians(e), math.radians(a), 0.0] for e, a in
                         zip(np.linspace(5, 25, POSE_B), np.linspace(50, 90, POSE_B))], device=dev)
    offset = torch.tensor([0.2, math.radians(3.0), math.radians(-6.0), math.radians(4.0)],
                          device=dev)
    init = true + offset * torch.linspace(-1, 1, POSE_B, device=dev)[:, None]

    def run():
        p, sims = vt.refine_pose(s128, targets, init, steps=steps, lr=0.02)
        return torch.stack([p[k] for k in ("dist", "elev", "azim", "theta")], -1), sims

    with main_path(PATH_KERNELS["pose_refine_batch"], kernels_only=True) as counts:
        pose_k, sim_k = run()
    assert counts["fine_bwd_rays"] == steps and counts["fine_bwd"] == 0 \
        and counts["fine_bwd_gauss"] == 0, f"batched refinement: K3's routes {counts}"
    assert counts["attr_dw"] == steps and counts["attr_merge_bwd"] == 0, \
        f"batched refinement: the merge's backward {counts}"
    assert counts["feature_similarity"] == steps and counts["feature_similarity_grad"] == steps, \
        f"batched refinement: the similarity's kernels {counts}"
    assert counts["slot_runs"] == counts["emit_rows"], \
        "batched refinement: a grouping ran outside the coarse stage"
    again = run()
    assert torch.equal(pose_k, again[0]) and torch.equal(sim_k, again[1]), \
        "batched refinement: two runs differ"
    assert (pose_k - init).abs().max().item() > 0.02, "batched refinement: the poses did not move"
    with plain_path():
        pose_p, sim_p = run()
    e_po = (pose_k - pose_p).abs().max().item()
    e_sim = (sim_k - sim_p).abs().max().item()
    assert e_po <= POSE_TOL and e_sim <= SCORE_TOL, \
        f"batched refinement kernel vs plain path: poses {e_po:.3e}, similarities {e_sim:.3e}"


def test_occlusion_step_against_its_golden_file(dev, monkeypatch):
    """``bench.py:140-186``'s occlusion step at full width (6,778 Gaussians,
    400x400, K = 60, ``max_point_per_bin=1500``; K1, K2, K3, K3f, K4b): the
    capacity's ``m_min`` branch taken with the floor as the larger term (a
    spy), overflow 0, two backward runs equal to the bit, the loss and the
    gradients and the selections' digest against
    ``voge_tpu_golden_occlusion_400.npz``."""
    verts, sig, col, cams = occlusion_scene(dev)
    ctx = vt.precompute_camera_ctx(*cams, OCC_HW, verts.shape[0], max_assign=OCC_K,
                                   max_point_per_bin=OCC_MPPB)
    picks = []
    pick = fine._pick_m_max

    def spy(*a):
        picks.append((a, pick(*a)))
        return picks[-1][1]

    gold = np.load(GOLDEN_OCC)
    monkeypatch.setattr(fine, "_pick_m_max", spy)
    with main_path(PATH_KERNELS["occlusion_step"], kernels_only=True):
        leaves = [x.detach().requires_grad_(True) for x in (verts, sig, col)]
        frag = vt.render_pipeline(leaves[0], leaves[1], *cams, image_size=OCC_HW,
                                  max_assign=OCC_K, max_point_per_bin=OCC_MPPB, cam_ctx=ctx)
        img = vt.interpolate_attr(frag, leaves[2])
        loss = ((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
        gr = torch.autograd.grad(loss, leaves, retain_graph=True)
        gr2 = torch.autograd.grad(loss, leaves)
    (P_pad, bins_, cc, m_min), m_out = picks[0]
    heuristic = -(-max(256, 8 * P_pad // bins_) // cc) * cc
    assert len(picks) == 1 and m_min == 4 * OCC_MPPB and m_out > heuristic, \
        f"occlusion: the capacity's m_min branch was not the larger term: {picks}"
    assert verts.shape[0] == 6778 and vt.get_overflow_points(frag) == 0 == int(gold["overflow"]), \
        "occlusion: overflow_points != 0 or not 6,778 Gaussians"
    for a, b in zip(gr, gr2):
        assert torch.equal(a, b), "occlusion: the gradients differ between two backward runs"
    flips = digest_flips(frag.vert_index, gold["valid_num"], gold["id_sum"])
    assert flips < FLIP_MAX, f"occlusion: selections' digest differs on {flips} of the pixels"
    hold_golden("occlusion", loss.item(), gr, gold)


def test_batch8_step_against_its_golden_file(dev, head):
    """The headline step at B = 8 (``bench.py:324-361``, forward + backward;
    K1, K2, K3): overflow 0, two backward runs equal to the bit, the
    selections' digest, the loss and the gradients against
    ``voge_tpu_golden_batch8_256.npz``."""
    g, colors = head["g"], head["colors"]
    cams8 = batch8_cams(dev)
    ctx8 = vt.precompute_camera_ctx(*cams8, (256, 256), g.verts.shape[0], max_assign=20)
    gold = np.load(GOLDEN_B8)
    with main_path(PATH_KERNELS["batch8_step"], kernels_only=True):
        leaves = [x.detach().requires_grad_(True) for x in (g.verts, g.sigmas, colors)]
        frag = vt.render_pipeline(leaves[0], leaves[1], *cams8, image_size=(256, 256),
                                  max_assign=20, cam_ctx=ctx8, attrs=leaves[2])
        loss = bench_loss(frag)
        gr = torch.autograd.grad(loss, leaves, retain_graph=True)
        gr2 = torch.autograd.grad(loss, leaves)
    assert frag.vert_index.shape[0] == B8 and vt.get_overflow_points(frag) == 0, \
        "B = 8: overflow_points != 0"
    for a, b in zip(gr, gr2):
        assert torch.equal(a, b), "B = 8: the gradients differ between two backward runs"
    flips = digest_flips(frag.vert_index, gold["valid_num"], gold["id_sum"])
    assert flips < FLIP_MAX, f"B = 8: selections' digest differs on {flips} of the pixels"
    hold_golden("B = 8 step", loss.item(), gr, gold)


def test_float64_oracle_at_the_headline(head):
    """The dense route in float64 on the card at the headline: its
    selections against the kernels', and the kernels' float32 gradients
    within 1e-3 (normwise) of it."""
    g, cams, colors = head["g"], head["cams"], head["colors"]
    fr32, l32, p32 = fitting_step(g, cams, colors, (256, 256))
    g32 = torch.autograd.grad(l32, p32)
    v, s, c = (x.detach().double().requires_grad_(True) for x in (g.verts, g.sigmas, colors))
    fr64 = vt.oracle.render(v, s, *cams, image_size=(256, 256), max_assign=20, attrs=c)
    g64 = torch.autograd.grad(bench_loss(fr64), (v, s, c))
    flips = 1.0 - (fr64.vert_index == fr32.vert_index).all(-1).float().mean().item()
    assert flips < FLIP_MAX and vt.get_overflow_points(fr64) == 0, \
        f"headline: the float64 oracle's selections differ on {flips} of the pixels"
    for i, name in enumerate(("verts", "sigmas", "colors")):
        e = rel_t(g32[i], g64[i])
        assert e <= GOLD_GRAD_TOL, f"headline {name}: port vs oracle {e:.3e}"


def dense_step(verts, sigmas, cams, colors, hw, mode, f64=False):
    """A K = 200 render in ``mode`` -> bench's loss -> its gradients
    (``f64``: the float64 oracle)."""
    thr, mppb = LK_MODES[mode]
    dt = torch.float64 if f64 else torch.float32
    v, s, c = (x.detach().to(dt).requires_grad_(True) for x in (verts, sigmas, colors))
    render = vt.oracle.render if f64 else vt.render_pipeline
    frag = render(v, s, *cams, image_size=hw, max_assign=LK_K,
                  thr_activation=thr, max_point_per_bin=mppb, attrs=c)
    sil = vt.get_silhouette(frag)
    loss = ((frag.attr_img - 0.5) ** 2).mean() + (sil ** 2).mean()
    return frag, sil, loss, torch.autograd.grad(loss, (v, s, c))


@pytest.mark.parametrize("mode", ["coarse", "no_coarse"])
@pytest.mark.parametrize("hw,focal", [((256, 256), 300.0), ((64, 64), 75.0)])
def test_dense_route_at_k200(dev, hw, focal, mode):
    """K = 200 through the dense route (one dense select, no K2, K3 or K1
    launch; K3f, K4b and the grouped scatter of its backward) on the 10K
    cuboid in both modes (thr 0.01 with the coarse stage, thr 1e-8 without)
    against the float64 oracle on the card; at 64x64 also against
    ``voge_tpu_golden_large_k_64.npz`` (the sigma gradient against the
    oracle: the file's float32 one is ~1.5e-3 off)."""
    gk, camk, colk = scene(10000, hw, focal, dev)
    with main_path(("attr_merge", "attr_merge_bwd", "attr_scatter", "slot_runs"),
                   kernels_only=True, dense=True) as counts:
        frag, sil, loss, grads = dense_step(gk.verts, gk.sigmas, camk, colk, hw, mode)
    assert dense_select.calls == 1 and all(counts[k] == 0 for k in (
        "fine_select", "fine_select_global", "fine_bwd", "fine_bwd_global", *COARSE_KERNELS)), \
        f"K = {LK_K} {mode}: the route was not the dense one alone"
    assert vt.get_overflow_points(frag) == 0, f"K = {LK_K} {mode}: overflow_points != 0"
    past = int((frag.valid_num > 128).sum())
    o_frag, o_sil, _, o_grads = dense_step(gk.verts, gk.sigmas, camk, colk, hw, mode, f64=True)
    agree = (frag.vert_index == o_frag.vert_index).all(-1)
    flips = 1.0 - agree.float().mean().item()
    assert flips < FLIP_MAX, f"K = {LK_K} {mode}: {flips} of the pixels flip against the oracle"
    for name, a, b in (("w", frag.vert_weight, o_frag.vert_weight),
                       ("img", frag.attr_img, o_frag.attr_img), ("sil", sil, o_sil)):
        e = (a.double()[agree] - b[agree]).abs().max().item()
        assert e <= W_TOL, f"K = {LK_K} {mode}: {name} vs oracle {e:.3e}"
    for i, name in enumerate(("verts", "sigmas", "colors")):
        e = rel_t(grads[i], o_grads[i])
        assert e <= GOLD_GRAD_TOL, f"K = {LK_K} {mode}: grad {name} vs oracle {e:.3e}"
    if hw == (64, 64):
        gold = np.load(GOLDEN_LK)
        pre = f"{mode}_"
        assert past == int((gold[pre + "valid_num"] > 128).sum()) > 0, \
            f"K = {LK_K} {mode}: pixels past 128 hits differ from the golden file"
        gflips = digest_flips(frag.vert_index, gold[pre + "valid_num"], gold[pre + "id_sum"])
        assert gflips < FLIP_MAX, f"K = {LK_K} {mode}: digest flips {gflips} against golden"
        same = torch.as_tensor((gold[pre + "valid_num"] == frag.valid_num[0].cpu().numpy()),
                               device=dev)
        for name, a in (("attr_img", frag.attr_img[0]), ("silhouette", sil[0])):
            e = (a - torch.as_tensor(gold[pre + name], device=dev))[same].abs().max().item()
            assert e <= W_TOL, f"K = {LK_K} {mode}: {name} vs golden"
        hold_golden(f"K = {LK_K} {mode}", loss.item(), grads, gold, pre, o_grads)


# ---- the sharded render, ShapeFitter(mesh=), the demos -----------------------------

@pytest.fixture(scope="module")
def padded(dev, head):
    """The 10K cuboid padded to a multiple of 4 with far-away Gaussians, and
    ``bench.py:324-361``'s 8 cameras."""
    g, colors = head["g"], head["colors"]
    n = g.verts.shape[0]
    n_pad = -(-n // 4) * 4
    pad = lambda x, v: torch.cat([x.detach(), torch.full((n_pad - n,) + x.shape[1:], v,
                                                         device=dev)])
    return pad(g.verts, 100.0), pad(g.sigmas, 1.0), pad(colors, 0.5), batch8_cams(dev)


def sharded_step(padded, mesh=None, model_axis="model", ring=False):
    from voge_tpu_torch.parallel import interpolate_attr_sharded, render_pipeline_sharded

    verts, sigmas, cols, cams8 = padded
    kw = dict(image_size=(256, 256), max_assign=20)
    leaves = [x.detach().requires_grad_(True) for x in (verts, sigmas, cols)]
    if mesh is None:
        frag = vt.render_pipeline(leaves[0], leaves[1], *cams8, **kw)
        img = vt.interpolate_attr(frag, leaves[2])
    else:
        frag = render_pipeline_sharded(leaves[0], leaves[1], *cams8, mesh=mesh,
                                       model_axis=model_axis, ring=ring, **kw)
        img = interpolate_attr_sharded(frag, leaves[2], mesh)
    loss = ((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
    return frag, loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("tag", list(SHARD_MESHES))
def test_sharded_headline_step_against_the_single_device_step(dev, padded, tag):
    """``render_pipeline_sharded`` at the headline on a mesh of the one card
    (data 2 with the scene replicated; (2, 2) all-gather; (2, 2) ring; (1, 4)
    all-gather) against the single-device step: overflow 0, ``vert_index``
    flips, weights on agreeing pixels, the loss and the gradients of verts,
    sigmas and colours, two runs equal to the bit."""
    from voge_tpu_torch.parallel import make_mesh

    shape, axis, ring = SHARD_MESHES[tag]
    f1, l1, g1 = sharded_step(padded)
    assert vt.get_overflow_points(f1) == 0, "sharded headline: the single-device overflow != 0"
    mesh = make_mesh(("data", "model"), shape, devices=[dev] * (shape[0] * shape[1]))
    with main_path((*COARSE, "fine_select", "fine_bwd", "attr_merge", "attr_merge_bwd"),
                   kernels_only=True):
        fs, ls, gs = sharded_step(padded, mesh, axis, ring)
        _, ls2, gs2 = sharded_step(padded, mesh, axis, ring)
    assert all(torch.equal(a, b) for a, b in zip(gs, gs2)) and torch.equal(ls, ls2), \
        f"sharded {tag}: two runs differ"
    agree = (fs.vert_index == f1.vert_index).all(-1)
    flips = 1.0 - agree.float().mean().item()
    assert flips < FLIP_MAX, f"sharded {tag}: vert_index flips on {flips} of the pixels"
    e = (fs.vert_weight - f1.vert_weight)[agree].abs().max().item()
    assert e <= W_TOL, f"sharded {tag}: weights {e:.3e}"
    e = abs(ls.item() - l1.item()) / l1.item()
    assert e <= GOLD_LOSS_TOL, f"sharded {tag}: loss {e:.3e}"
    for name, a, b in zip(("verts", "sigmas", "colors"), gs, g1):
        e = rel_t(a, b)
        assert e <= GOLD_GRAD_TOL, f"sharded {tag}: {name} gradient {e:.3e}"


@pytest.mark.parametrize("shape", [(1, 2), (5, 1)])
def test_shape_fitter_on_a_mesh_of_the_card(dev, shape):
    """``ShapeFitter(mesh=)`` at the ShapeFitting shapes (no coarse stage):
    three steps against the unsharded trainer, each loss within 1e-5
    relative, the parameters within 1e-4."""
    from voge_tpu_torch.parallel import make_mesh

    verts, isig, col, cams, targets = shapefit_scene(dev)

    def fit(mesh=None):
        f = vt.ShapeFitter({"verts": verts, "colors": col}, {"sigmas": isig},
                           image_size=SF_HW, focal=cams[2][0], principal=cams[3][0],
                           max_assign=SF_K, mesh=mesh, device=None if mesh else dev)
        return f, [f.step(cams[0], cams[1], *targets) for _ in range(3)]

    ref, ref_losses = fit()
    with main_path(("fine_select_global", "fine_bwd_global", "attr_merge", "attr_merge_bwd"),
                   kernels_only=True):
        f, losses = fit(make_mesh(("data", "model"), shape, devices=[dev] * (shape[0] * shape[1])))
    e_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    e_par = max((f.params[k] - ref.params[k]).abs().max().item() for k in f.params)
    assert e_loss <= GOLD_LOSS_TOL and e_par <= FIT_TOL, \
        f"ShapeFitter(mesh={shape}) against the unsharded trainer: loss {e_loss}, params {e_par}"


def test_sharded_texture_helpers_against_the_single_device_ones(dev, tex):
    """``interpolate_attr_sharded`` / ``sample_features_sharded`` (forward and
    backward) at the texture shapes with two cameras on a (2, 1) mesh of the
    card, the scene replicated, against the single-device helpers."""
    from voge_tpu_torch.parallel import (
        interpolate_attr_sharded, make_mesh, render_pipeline_sharded, sample_features_sharded,
    )

    verts, isig, cams = tex["verts"], tex["isig"], tex["cams"]
    R2, T2 = vt.look_at_view_transform(dist=[3.0, 3.0], elev=[0.1, 0.1],
                                       azim=[0.6, 0.6 - math.pi / 6], degrees=False, device=dev)
    cams_t = (R2, T2, cams[2].expand(2, 2), cams[3].expand(2, 2))
    N = verts.shape[0]
    image = torch.as_tensor(np.random.RandomState(0).uniform(size=(2,) + TEX_HW + (3,))
                            .astype(np.float32), device=dev)
    cols = ((verts + 1) / 2).contiguous()
    cot = seeded((2 * N, 3), dev, 31)
    mesh = make_mesh(("data", "model"), (2, 1), devices=[dev, dev])

    def texture_pair(sharded):
        v, im = verts.detach().requires_grad_(True), image.detach().requires_grad_(True)
        kt = dict(image_size=TEX_HW, max_assign=TEX_K)
        if sharded:
            frag = render_pipeline_sharded(v, isig, *cams_t, mesh=mesh, model_axis=None, **kt)
            img = interpolate_attr_sharded(frag, cols, mesh)
            feat, wsum = sample_features_sharded(frag, im, 2 * N, mesh)
        else:
            frag = vt.render_pipeline(v, isig, *cams_t, **kt)
            img = vt.interpolate_attr(frag, cols)
            feat, wsum = vt.sample_features(frag, im, n_vert=2 * N)
        grads = torch.autograd.grad((feat * cot).sum() + wsum.sum(), (v, im))
        return frag, img, feat, wsum, grads

    t1 = texture_pair(False)
    with main_path((*COARSE, "fine_select", "attr_merge", "attr_scatter", "attr_dw", "fine_bwd"),
                   kernels_only=True):
        ts = texture_pair(True)
    assert vt.get_overflow_points(ts[0]) == 0 == vt.get_overflow_points(t1[0]), \
        "sharded texture helpers: overflow_points != 0"
    agree = (ts[0].vert_index == t1[0].vert_index).all(-1)
    e = {"flips": 1.0 - agree.float().mean().item(),
         "img": (ts[1] - t1[1])[agree].abs().max().item()}
    for name, a, b in (("feat", ts[2], t1[2]), ("wsum", ts[3], t1[3]),
                       ("grad_image", ts[4][1], t1[4][1])):
        e[name] = (a - b).abs().max().item() / b.abs().max().item()
    e["grad_verts"] = rel_t(ts[4][0], t1[4][0])
    assert e["flips"] < FLIP_MAX and all(e[k] <= W_TOL for k in ("img", "feat", "wsum", "grad_image")) \
        and e["grad_verts"] <= GOLD_GRAD_TOL, f"sharded texture helpers against single device: {e}"


_it = dict(iters=DEMO_ITERS)
DEMOS = {  # name -> (kwargs, PNGs, coarse stage, kernels required)
    "render_cuboid": ({}, ["cuboid"], True, (*COARSE, "fine_select", "attr_merge")),
    "render_bunny": ({}, ["bunny"], True, (*COARSE, "fine_select", "attr_merge")),
    "render_pointclouds": ({}, ["pointcloud"], True, (*COARSE, "fine_select", "attr_merge")),
    "light_diffusion": ({}, [f"light_diffusion_{i}" for i in range(3)], True,
                        (*COARSE, "fine_select", "attr_merge")),
    "shape_fitting": (_it, ["shape_fitting_result", "shape_fitting_target"], False,
                      ("fine_select_global", "fine_bwd_global", "attr_merge", "attr_merge_bwd")),
    # constant colours / face ids: K4b's d_w half alone (attr_dw)
    "reason_occlusion": (_it, ["reason_occ_after", "reason_occ_before", "reason_occ_target"],
                         True, (*COARSE, "fine_select", "fine_bwd", "attr_merge", "attr_dw")),
    "efficient_cuboid": (_it, ["efficient_cuboid"], True,
                         (*COARSE, "fine_select", "fine_select_global", "fine_bwd_global",
                          "attr_merge", "attr_dw")),
    "extract_texture": ({}, ["extract_texture_rerender"], True,
                        (*COARSE, "fine_select", "attr_scatter", "attr_merge")),
}


@pytest.mark.parametrize("name", list(DEMOS))
def test_demo_at_its_own_size(dev, monkeypatch, tmp_path, name):
    """The demo on the card at its own size (the optimization demos cut to
    two steps), into a temporary directory: its PNGs, a finite loss, the
    coarse stage's overflow 0 on every render that has one (a spy on
    ``ops.fine.compact_candidates``); ``extract_texture`` skips without the
    upstream car data."""
    dkw, pngs, has_coarse, required = DEMOS[name]
    mod = importlib.import_module(f"voge_tpu_torch.demo.{name}")
    out_dir = tmp_path / name
    seen = []
    real = fine.compact_candidates

    def spy(*a, **k):
        c = real(*a, **k)
        seen.append(c.overflow_c.sum())
        return c

    monkeypatch.setattr(fine, "compact_candidates", spy)
    buf = io.StringIO()
    with main_path(kernels_only=True) as counts, contextlib.redirect_stdout(buf):
        ret = mod.main(device=dev, out_dir=out_dir, **dkw)
    if name == "extract_texture" and "skipped: no reference car data" in buf.getvalue():
        assert ret is None and not out_dir.exists(), "extract_texture: skipped but wrote"
        return
    for k in required:
        assert counts[k] > 0, f"demo {name}: {k} was not launched"
    got = sorted(p.stem for p in out_dir.glob("*.png"))
    assert got == sorted(pngs), f"demo {name}: wrote {got}, not {pngs}"
    assert ret is None or math.isfinite(ret), f"demo {name}: returned {ret}"
    ovf = [int(x) for x in seen]
    assert bool(ovf) == has_coarse and not any(ovf), \
        f"demo {name}: the coarse stage's overflow per render {ovf}"
