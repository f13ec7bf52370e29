"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip elsewhere.  The
GPU machine has no JAX, so this file imports only torch and the port, and is
run there without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: K1 and K3f's inputs give equal outputs (K1 bit for bit, K3f to
1e-5: the kernel's sum may contract into FMAs); K2 selections equal but for
knife-edge pixels (< 0.1% flipped), len / act / dsd rtol 1e-5 atol 1e-5 and
weights / images atol 1e-4 on agreeing pixels.  The backward kernels (the
fold, K3, K4b) and the gradients of a whole render: max |kernel - plain| <=
1e-4 max |plain| per tensor (f32 sums in another order); two backward runs
equal to the bit.  The global entries of K2 and K3 (the no-coarse path):
selections equal to the plain version's, the rest as above.  The two halves
of the split global backward: each within 1e-4 of its plain version's
largest entry at every lane width of the per-Gaussian kernel, two runs equal
to the bit; the pair after the fold, and the per-ray half with the fold
fused in, equal to the bit to the unified entry on the same inputs (the same
kernels; 32 lanes a Gaussian at these shapes).  The k-NN converter on
the card against the CPU, and pose scoring / refinement through the kernels
against the plain path.  The loaders, the checkpoint and the pose entry
points called without a device: everything on the card.
"""
import math

import numpy as np
import pytest
import torch

import voge_tpu_torch as vt
from voge_tpu_torch import trace
from voge_tpu_torch.aggregation import expend_sigma
from voge_tpu_torch.ops import coarse, cuda_attr, fine
from voge_tpu_torch.ops.cuda_attr import (
    attr_merge, attr_merge_bwd, attr_merge_bwd_plain, attr_merge_plain,
)
from voge_tpu_torch.ops.cuda_coarse import (
    coarse_globals, coarse_globals_plain, coarse_rows, coarse_rows_plain, emit_rows,
    emit_rows_plain,
)
from voge_tpu_torch.ops.cuda_fine import (
    fine_select, fine_select_global, fine_select_global_plain, fine_select_plain,
)
from voge_tpu_torch.ops.cuda_fine_bwd import (
    fine_bwd, fine_bwd_gauss, fine_bwd_gauss_plain, fine_bwd_global, fine_bwd_global_plain,
    fine_bwd_plain, fine_bwd_rays, fine_bwd_rays_plain, fold_weights, fold_weights_plain,
)
from voge_tpu_torch.rays import camera_rays

from cuda_common import (
    equal_select, fold_then_pair, grad_err, hold_runs, plain_path, scene, stage_inputs,
)

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _counted():
    """Every test runs under the port's tracing, which counts each kernel
    wrapper's launches (``launch.<name>``)."""
    with trace.tracing():
        yield


def launches(fn) -> int:
    """The launches of kernel wrapper ``fn`` counted since the test began."""
    return trace.counts().get(f"launch.{fn.__name__}", 0)


def _stage(dev, kind):
    """Two cameras over a random anisotropic scene (with one oversize
    global member) or the 1K cuboid at 52x60, or the 1K cuboid at 128x128
    from the quickstart's one camera (``1k_128``): rays, camera-centred
    points and precisions, colours."""
    if kind == "1k_128":
        g, cams, colors = scene(1000, (128, 128), 150.0, dev)
        return (cams, (128, 128), *stage_inputs(g, cams, (128, 128)), colors)
    B, hw = 2, (52, 60)
    if kind == "random":
        rng = np.random.RandomState(3)
        verts = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
        a = rng.uniform(-1, 1, size=(400, 3, 3)).astype(np.float32)
        isig = (np.einsum("pij,pkj->pik", a, a) + 2 * np.eye(3, dtype=np.float32)) * 60.0
        isig[7] = np.eye(3, dtype=np.float32) * 1e-3
        verts, isig = torch.as_tensor(verts, device=dev), torch.as_tensor(isig, device=dev)
    else:
        g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000,
                                             percentage=0.6, as_obj=True, device=dev)
        verts, isig = g.verts.detach(), expend_sigma(g.sigmas.detach())
    R, T = vt.look_at_view_transform(dist=[4.5, 6.0], elev=[10.0, 35.0],
                                     azim=[70.0, -20.0], device=dev)
    cams = (R, T, torch.tensor([[70.0, 70.0], [60.0, 80.0]], device=dev),
            torch.tensor([[30.0, 26.0], [29.0, 25.0]], device=dev))
    rays, origins = camera_rays(*cams, hw)
    points = verts[None] - origins[:, None, :]
    isig = (2.0 * isig)[None].expand(B, -1, 3, 3)
    colors = torch.rand(B * verts.shape[0], 3, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    return cams, hw, rays, points, isig, colors


@pytest.fixture(scope="module", params=["random", "cuboid"])
def stage(request, dev):
    """``_stage``'s two small scenes."""
    return _stage(dev, request.param)


@pytest.fixture(scope="module", params=["random", "cuboid", "1k_128"])
def every_k_stage(request, dev):
    """``_stage``'s two small scenes and the 1K cuboid at 128x128."""
    return _stage(dev, request.param)


def test_emit_kernel_equals_plain(stage):
    cams, hw, _, points, isig, _ = stage
    bs = 10
    nst, BH2, BW2, _, win = coarse.emission_geometry(points.shape[1], hw, bs)
    args = (*cams, points, isig, 0.01, bs, hw, nst, BH2, BW2, win)
    before = launches(emit_rows)
    got = emit_rows(*args)
    want = emit_rows_plain(*args)
    torch.cuda.synchronize()
    assert launches(emit_rows) == before + 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _coarse_scene(dev, kind):
    """(cameras, camera-centred points, precisions, image size, n_globals,
    M, row_align) of a random anisotropic scene: 'globals' (B = 2, three
    oversize Gaussians), 'overflow' (fixed rows of 8), 'reemit' (two
    oversize Gaussians and one global slot: the render emits again with a
    wider window), 'b8' (eight cameras)."""
    rng = np.random.RandomState({"globals": 5, "overflow": 6, "reemit": 7, "b8": 8}[kind])
    B = 8 if kind == "b8" else 2
    P = 3000 if kind == "b8" else 700
    verts = torch.as_tensor(rng.uniform(-1, 1, (P, 3)).astype(np.float32), device=dev)
    a = rng.uniform(-1, 1, (P, 3, 3)).astype(np.float32)
    isig = (np.einsum("pij,pkj->pik", a, a) + 2 * np.eye(3, dtype=np.float32)) * 300.0
    for p in {"globals": (3, 300, 301), "reemit": (11, 400), "b8": (9,)}.get(kind, ()):
        isig[p] = np.eye(3, dtype=np.float32) * (4.0 if kind == "reemit" else 1e-3)
    R, T = vt.look_at_view_transform(dist=list(np.linspace(3.5, 5.0, B)),
                                     elev=list(np.linspace(-20, 40, B)),
                                     azim=list(np.linspace(-80, 80, B)), device=dev)
    hw = (96, 128)
    cams = (R, T, torch.full((B, 2), 90.0, device=dev),
            torch.tensor([[64.0, 48.0]] * B, device=dev))
    _, origins = camera_rays(*cams, hw)
    points = verts[None] - origins[:, None, :]
    isg = torch.as_tensor(isig, device=dev)[None].expand(B, P, 3, 3).contiguous()
    ng, M, align = {"globals": (64, 0, 8), "overflow": (64, 8, 0), "reemit": (1, 0, 8),
                    "b8": (64, 0, 8)}[kind]
    return cams, points, isg, hw, ng, M, align


@pytest.mark.parametrize("kind", ["globals", "overflow", "reemit", "b8"])
def test_coarse_stage_kernels_equal_plain(dev, kind):
    """The emission, the globals and the rows kernels against their plain
    versions on the same inputs, bit for bit (the rows with and without
    the inverse map), and the whole stage against the int64 route."""
    cams, points, isg, hw, ng, M, align = _coarse_scene(dev, kind)
    B, P = points.shape[:2]
    bs = 8
    nst, BH2, BW2, _, win = coarse.emission_geometry(P, hw, bs)
    em = emit_rows(*cams, points, isg, 0.01, bs, hw, nst, BH2, BW2, win)
    for x, y in zip(em, emit_rows_plain(*cams, points, isg, 0.01, bs, hw, nst, BH2, BW2, win)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    rid, bits, planes, over, info = em
    order, starts = cuda_attr.slot_runs(rid, B * nst)
    ng = min(ng, P)
    info_p = info.clone()
    glob = coarse_globals(over, planes, starts, info, ng, nst, BW2, bs, hw)
    glob_p = coarse_globals_plain(over, planes, starts, info_p, ng, nst, BW2, bs, hw)
    for x, y in zip(glob, glob_p):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(info, info_p)
    densest, dropped, wider = info.tolist()
    assert densest > 0 and (dropped > 0) == (kind == "reemit")
    if kind == "reemit":
        assert wider > win
    width = M or -(-densest // 8) * 8
    for with_dst in (False, True):
        rows = coarse_rows(order, starts, bits, glob[0], glob[2], glob[3], width, nst, with_dst)
        want = coarse_rows_plain(order, starts, bits, glob[0], glob[2], glob[3], width, nst,
                                 with_dst)
        for x, y in zip(rows, want):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert (int(rows[4].sum()) > 0) == (kind in ("overflow", "reemit"))
    for with_dst in (False, True):
        a = coarse.emit_supertile_candidates(*cams, points, isg, hw, 0.01, bs, M, ng, align,
                                             with_dst)
        win0 = coarse.emission_geometry(P, hw, bs)[-1]
        b = coarse._emit_candidates_sorted(*cams, points, isg, hw, 0.01, bs, M, ng, align,
                                           with_dst, win0)
        for x, y in zip(a[:5], b[:5]):
            assert torch.equal(x, y)
        if with_dst:
            for x, y in zip(a[5], b[5]):
                assert torch.equal(x, y)
    if kind == "reemit":
        assert int(a[4].sum()) == 0 and a[5][0].shape[-1] > win * win


@pytest.mark.parametrize("K", [5, 20, 40, 80])
@pytest.mark.parametrize("with_attrs", [False, True])
def test_select_kernel_matches_plain(stage, K, with_attrs):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
    table = fine.feature_table(points, isig)
    args = (rays, table, c.bits_c, c.ids_c, c.counts_c, c.thr_act, K,
            c.bin_size, 0.9, colors if with_attrs else None)
    before = launches(fine_select)
    got = fine_select(*args)
    want = fine_select_plain(*args)
    torch.cuda.synchronize()
    assert launches(fine_select) == before + 1
    agree = (got[0] == want[0]).all(-1)
    assert 1.0 - agree.float().mean().item() < 1e-3
    assert (got[0] >= 0).any()
    for g, w in zip(got[1:4], want[1:4]):
        torch.testing.assert_close(g[agree], w[agree], rtol=1e-5, atol=1e-5)
    for g, w in zip(got[4:], want[4:]):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g[agree], w[agree], rtol=0, atol=1e-4)


def test_attr_kernel_matches_plain(stage):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, 20)
    table = fine.feature_table(points, isig)
    idx, _, _, _, w, _ = fine_select_plain(rays, table, c.bits_c, c.ids_c,
                                           c.counts_c, c.thr_act, 20, c.bin_size, 1.0)
    before = launches(attr_merge)
    got = attr_merge(idx, w, colors)
    assert launches(attr_merge) == before + 1
    torch.testing.assert_close(got, attr_merge_plain(idx, w, colors), rtol=0, atol=1e-5)


def test_wrappers_check_their_inputs(stage):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, 20)
    table = fine.feature_table(points, isig)
    with pytest.raises(TypeError):
        fine_select(rays, table, c.bits_c.long(), c.ids_c, c.counts_c,
                    c.thr_act, 20, c.bin_size, 1.0)
    with pytest.raises(ValueError):
        fine_select(rays.cpu(), table, c.bits_c, c.ids_c, c.counts_c,
                    c.thr_act, 20, c.bin_size, 1.0)
    with pytest.raises(ValueError):
        attr_merge(c.ids_c[:, ::2], torch.ones_like(c.ids_c[:, ::2], dtype=torch.float32),
                   colors)
    sel = fine_select(rays, table, c.bits_c, c.ids_c, c.counts_c, c.thr_act, 20,
                      c.bin_size, 1.0)
    feats = fine.feature_table(points, isig)
    with pytest.raises(ValueError):
        fine_bwd(rays, feats, *sel[:5], None, None, None, sel[4][..., :3].contiguous(), 1.0)
    with pytest.raises(ValueError):     # the fold needs the weights
        fine_bwd(rays, feats, sel[0], sel[1], sel[2], sel[3], None, None, None, None,
                 sel[4], 1.0)
    with pytest.raises(ValueError):
        attr_merge_bwd(sel[0], sel[4], colors, torch.ones_like(rays).cpu())


def _cotangents(shape, dev, n, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(shape, device=dev, generator=gen) for _ in range(n)]


@pytest.mark.parametrize("K", [5, 20, 40, 128])
def test_fold_kernel_matches_plain(stage, K):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
    table = fine.feature_table(points, isig)
    _, l, a, d, w, _ = fine_select(rays, table, c.bits_c, c.ids_c, c.counts_c,
                                   c.thr_act, K, c.bin_size, 0.9)
    (gw,) = _cotangents(w.shape, rays.device, 1, K)
    before = launches(fold_weights)
    got = fold_weights(l, a, d, w, gw, 0.9)
    want = fold_weights_plain(l, a, d, w, gw, 0.9)
    torch.cuda.synchronize()
    assert launches(fold_weights) == before + 1
    for g, x in zip(got, want):
        grad_err(g, x)


@pytest.mark.parametrize("K", [5, 20, 25, 40, 128])
@pytest.mark.parametrize("want_rays", [False, True])
@pytest.mark.parametrize("with_attrs", [False, True])
def test_fine_bwd_kernel_matches_plain(stage, with_attrs, want_rays, K):
    """K3's compacted entry (B = 2) against its plain version: per-Gaussian
    rows, two runs equal to the bit."""
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
    table = fine.feature_table(points, isig)
    attrs = colors if with_attrs else None
    sel = fine_select(rays, table, c.bits_c, c.ids_c, c.counts_c, c.thr_act, K,
                      c.bin_size, 0.9, attrs)
    cots = _cotangents(sel[1].shape, rays.device, 4, 3)
    g_img = _cotangents(rays.shape, rays.device, 1, 4)[0] if with_attrs else None
    args = (rays, table, *sel[:5], *cots, 0.9, attrs, g_img, want_rays)
    before = launches(fine_bwd)
    got = fine_bwd(*args)
    again = fine_bwd(*args)
    want = fine_bwd_plain(*args)
    torch.cuda.synchronize()
    assert launches(fine_bwd) == before + 2
    assert got[0].shape == (table.shape[0], 15 if with_attrs else 12)
    grad_err(got[0], want[0])
    assert torch.equal(got[0], again[0])
    if want_rays:
        grad_err(got[1], want[1])
        assert torch.equal(got[1], again[1])
    else:
        assert got[1] is None and want[1] is None


def test_attr_merge_bwd_kernel_matches_plain(stage):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, 20)
    table = fine.feature_table(points, isig)
    idx, _, _, _, w, _ = fine_select(rays, table, c.bits_c, c.ids_c, c.counts_c,
                                     c.thr_act, 20, c.bin_size, 1.0)
    (g,) = _cotangents(rays.shape, rays.device, 1, 5)
    before = launches(attr_merge_bwd)
    got = attr_merge_bwd(idx, w, colors, g)
    again = attr_merge_bwd(idx, w, colors, g)
    want = attr_merge_bwd_plain(idx, w, colors, g)
    torch.cuda.synchronize()
    assert launches(attr_merge_bwd) == before + 2
    for x, y, z in zip(got, want, again):
        grad_err(x, y)
        assert torch.equal(x, z)


def test_render_gradients_kernel_path_match_plain_path(dev):
    """The fitting step's gradients through the kernels against the same
    step through the plain versions, and two kernel-path backward runs equal
    to the bit; the white-background path through K4b as well."""
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000,
                                         percentage=0.6, as_obj=True, device=dev)
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70, device=dev)
    f = torch.tensor([[150.0, 150.0]], device=dev)
    pp = torch.tensor([[64.0, 64.0]], device=dev)
    colors = ((g.verts.detach() + 1) / 3).contiguous().requires_grad_(True)

    def step():
        frag = vt.render_pipeline(g.verts, g.sigmas, R, T, f, pp, image_size=(128, 128),
                                  max_assign=20, attrs=colors)
        white = vt.to_white_background(frag, colors)
        loss = (((frag.attr_img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
                + white.square().mean())
        return torch.autograd.grad(loss, (g.verts, g.sigmas, colors))

    before = (launches(fine_bwd), launches(attr_merge_bwd))
    k1, k2 = step(), step()
    assert launches(fine_bwd) == before[0] + 2 and launches(attr_merge_bwd) == before[1] + 2
    with plain_path():
        p = step()
    torch.cuda.synchronize()
    for a, b, c in zip(k1, k2, p):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()
        grad_err(a, c)


def _global_select(stage, K, bits_kind):
    cams, hw, rays, points, isig, colors = stage
    table = fine.feature_table(points, isig)
    bs = 10
    bits = None
    if bits_kind == "random":
        nb = points.shape[0] * math.prod(coarse.supertile_grid(*hw, bs))
        gen = torch.Generator(rays.device).manual_seed(6)
        bits = torch.randint(0, 16, (nb, points.shape[1]), dtype=torch.int32,
                             device=rays.device, generator=gen)
    return rays, table, (rays, table, bits, -math.log(0.01 + 1e-10), K, bs, 0.9)


@pytest.mark.parametrize("K", [5, 25, 40])
@pytest.mark.parametrize("bits_kind", ["none", "random"])
def test_select_global_kernel_matches_plain(stage, K, bits_kind):
    _, _, args = _global_select(stage, K, bits_kind)
    before = launches(fine_select_global)
    got = fine_select_global(*args)
    want = fine_select_global_plain(*args)
    torch.cuda.synchronize()
    assert launches(fine_select_global) == before + 1
    assert torch.equal(got[0], want[0]) and (got[0] >= 0).any()
    for g, w in zip(got[1:4], want[1:4]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[4], want[4], rtol=0, atol=1e-4)


@pytest.mark.parametrize("want_rays", [False, True])
@pytest.mark.parametrize("g_w", ["set", "zero", "only"])
def test_fine_bwd_global_kernel_matches_plain(stage, want_rays, g_w):
    rays, table, args = _global_select(stage, 25, "none")
    sel = fine_select_global(*args)
    cots = _cotangents(sel[1].shape, rays.device, 4, 7)
    if g_w == "zero":
        cots[3] = torch.zeros_like(cots[3])
    elif g_w == "only":
        cots[:3] = [None] * 3
    b_args = (rays, table, *sel, *cots, 0.9, want_rays)
    before = launches(fine_bwd_global)
    got = fine_bwd_global(*b_args)
    again = fine_bwd_global(*b_args)
    want = fine_bwd_global_plain(*b_args)
    torch.cuda.synchronize()
    assert launches(fine_bwd_global) == before + 2
    assert got[0].shape == (table.shape[0], 12)
    grad_err(got[0], want[0])
    assert torch.equal(got[0], again[0])
    if want_rays:
        grad_err(got[1], want[1])
        assert torch.equal(got[1], again[1])
    else:
        assert got[1] is None and want[1] is None


def test_fine_bwd_long_and_empty_runs(stage):
    """Gaussians that hold more than 32 slots (a run longer than a warp) and
    Gaussians that hold none (an empty run: a zero row; seven rows that no
    slot names are added to the table), on both entries, and a selection
    with every slot empty."""
    rays, table, args = _global_select(stage, 25, "none")
    sel = fine_select_global(*args)
    table = torch.cat([table, table[:7]])
    held = torch.bincount(sel[0][sel[0] >= 0].long(), minlength=table.shape[0])
    assert held.max() > 32 and (held == 0).sum() >= 7
    cots = _cotangents(sel[1].shape, rays.device, 4, 13)
    attrs = torch.rand(table.shape[0], 5, device=rays.device,
                       generator=torch.Generator(rays.device).manual_seed(14))
    g_img = _cotangents(rays.shape[:3] + (5,), rays.device, 1, 15)[0]
    for fn, pfn, extra in ((fine_bwd, fine_bwd_plain, (attrs, g_img, True)),
                           (fine_bwd_global, fine_bwd_global_plain, (True,))):
        got = fn(rays, table, *sel, *cots, 0.9, *extra)
        want = pfn(rays, table, *sel, *cots, 0.9, *extra)
        grad_err(got[0], want[0])
        grad_err(got[1], want[1])
        assert not got[0][held == 0].any() and got[0][held > 32].abs().sum(-1).min() > 0
        empty = torch.full_like(sel[0], -1)
        rows, g_rays = fn(rays, table, empty, *sel[1:], *cots, 0.9, *extra)
        assert not rows.any() and not g_rays.any()


@pytest.mark.parametrize("entry", ["compacted", "global"])
def test_fine_bwd_skipped_fold_equals_zero_weight_cotangent(stage, entry):
    """Neither g_w nor attributes: the fold is skipped (and w may be absent),
    and the result equals the same call with an explicit zero g_w to the
    bit."""
    rays, table, args = _global_select(stage, 25, "none")
    sel = fine_select_global(*args)
    cots = _cotangents(sel[1].shape, rays.device, 3, 16)
    fn = fine_bwd if entry == "compacted" else fine_bwd_global
    skipped = fn(rays, table, *sel[:4], None, *cots, None, 0.9, want_rays=True)
    zero = fn(rays, table, *sel, *cots, torch.zeros_like(sel[4]), 0.9, want_rays=True)
    assert all(torch.equal(a, b) for a, b in zip(skipped, zero))
    grad_err(skipped[0], fine_bwd_global_plain(rays, table, *sel[:4], None, *cots, None, 0.9)[0])


def test_shape_fitter_kernel_path_matches_plain_path(dev):
    """Two ``ShapeFitter`` steps on the no-coarse path (``ico_sphere(3)``,
    three views at 64x64, K = 25) through the kernels and through the plain
    versions: the global entries and the attribute merge are launched and
    K1 is not; losses to a relative 1e-5 and the parameters' displacement to
    a normwise relative 1e-4."""
    v, f = vt.ico_sphere(3)
    verts, isig, _ = vt.naive_vertices_converter(v, f, percentage=0.5)
    R, T = vt.look_at_view_transform(dist=2.7, elev=[-10.0, 10.0, 30.0],
                                     azim=[-60.0, 0.0, 60.0], device=dev)
    t_rgb = torch.full((3, 64, 64, 3), 0.3, device=dev)
    t_sil = torch.zeros((3, 64, 64), device=dev)

    def run():
        fitter = vt.ShapeFitter({"verts": verts, "colors": np.full_like(verts, 0.5)},
                                {"sigmas": isig}, image_size=(64, 64), focal=63.0,
                                principal=(32.0, 32.0), device=dev)
        losses = [fitter.step(R, T, t_rgb, t_sil) for _ in range(2)]
        return losses, {k: p.detach() for k, p in fitter.params.items()}

    before = {fn: launches(fn) for fn in (fine_select_global, fine_bwd_global, attr_merge,
                                         attr_merge_bwd, emit_rows)}
    lk, pk = run()
    torch.cuda.synchronize()
    for fn, n in before.items():
        assert (launches(fn) > n) == (fn is not emit_rows), fn.__name__
    with plain_path():
        lp, pp = run()
    for a, b in zip(lk, lp):
        assert abs(a - b) <= 1e-5 * abs(b)
    for k in pk:
        x0 = torch.as_tensor(verts if k == "verts" else np.full_like(verts, 0.5), device=dev)
        moved_k, moved_p = pk[k] - x0, pp[k] - x0
        assert (moved_k - moved_p).norm() <= 1e-4 * moved_p.norm(), k


def _slots(dev, K, d, n_rows=300, n_pix=(2, 33, 41), seed=5):
    """Random selections (a third of the slots empty, some ids beyond the
    table), weights, per-pixel rows and per-id rows."""
    gen = torch.Generator(dev).manual_seed(seed)
    idx = torch.randint(-n_rows // 2, n_rows + 4, n_pix + (K,), device=dev, generator=gen,
                        dtype=torch.int32).clamp(min=-1)
    w = torch.rand(n_pix + (K,), device=dev, generator=gen)
    g = torch.randn(n_pix + (d,), device=dev, generator=gen)
    attrs = torch.randn((n_rows, d), device=dev, generator=gen)
    return idx, w, g, attrs


@pytest.mark.parametrize("K", [5, 20, 40, 80])
@pytest.mark.parametrize("d", [4, 8, 11])
def test_attr_halves_match_plain(dev, K, d):
    """``attr_scatter`` and ``attr_dw`` alone against their plain versions
    (max |kernel - plain| <= 1e-4 max |plain|), two runs equal to the bit,
    and K4b's two halves equal to the halves alone (one device code)."""
    from voge_tpu_torch.ops.cuda_attr import (
        attr_dw, attr_dw_plain, attr_scatter, attr_scatter_plain,
    )

    idx, w, g, attrs = _slots(dev, K, d)
    n_rows = attrs.shape[0]
    before = launches(attr_scatter), launches(attr_dw)
    out, out2 = attr_scatter(idx, w, g, n_rows), attr_scatter(idx, w, g, n_rows)
    d_w, d_w2 = attr_dw(idx, attrs, g), attr_dw(idx, attrs, g)
    torch.cuda.synchronize()
    assert (launches(attr_scatter), launches(attr_dw)) == (before[0] + 2, before[1] + 2)
    assert torch.equal(out, out2) and torch.equal(d_w, d_w2)
    want, want_w = attr_scatter_plain(idx, w, g, n_rows), attr_dw_plain(idx, attrs, g)
    assert (out - want).abs().max() <= 1e-4 * want.abs().max()
    assert (d_w - want_w).abs().max() <= 1e-4 * want_w.abs().max()
    assert not d_w[(idx < 0) | (idx >= n_rows)].any()
    both = attr_merge_bwd(idx, w, attrs, g)
    assert torch.equal(both[0], d_w) and torch.equal(both[1], out)
    only_w = attr_merge_bwd(idx, w, attrs, g, need_attr=False)
    only_a = attr_merge_bwd(idx, w, attrs, g, need_w=False)
    assert only_w[1] is None and only_a[0] is None
    assert torch.equal(only_w[0], d_w) and torch.equal(only_a[1], out)


@pytest.mark.parametrize("K", [1, 3, 20, 80, 128])
@pytest.mark.parametrize("d", [1, 3, 4, 5, 8, 33])
def test_attr_merge_and_dw_edge_shapes(dev, d, K):
    """K3f and ``attr_dw`` at their edge shapes on 1,001 pixels (no block's
    pixel count divides it), ids of -1 and ids beyond the table: K3f within
    1e-5 of its plain version (ids beyond the table read as empty slots, the
    kernel's contract), ``attr_dw`` within 1e-4 of the plain one's largest
    entry and 0 on the slots outside the table, two runs equal to the bit,
    the launch counters one up a call."""
    from voge_tpu_torch.ops.cuda_attr import attr_dw, attr_dw_plain

    n_rows = 300
    idx, w, g, attrs = _slots(dev, K, d, n_rows=n_rows, n_pix=(1001,), seed=7 * d + K)
    w = w / K                                   # weights summing to at most 1 a pixel
    attrs = attrs.abs()
    before = launches(attr_merge), launches(attr_dw)
    img, img2 = attr_merge(idx, w, attrs), attr_merge(idx, w, attrs)
    d_w, d_w2 = attr_dw(idx, attrs, g), attr_dw(idx, attrs, g)
    torch.cuda.synchronize()
    assert (launches(attr_merge), launches(attr_dw)) == (before[0] + 2, before[1] + 2)
    assert torch.equal(img, img2) and torch.equal(d_w, d_w2)
    outside = (idx < 0) | (idx >= n_rows)
    assert outside.any() and (idx >= n_rows).any()
    want = attr_merge_plain(torch.where(idx < n_rows, idx, -1), w, attrs)
    torch.testing.assert_close(img, want, rtol=0, atol=1e-5)
    want_w = attr_dw_plain(idx, attrs, g)
    assert (d_w - want_w).abs().max() <= 1e-4 * want_w.abs().max()
    assert not d_w[outside].any()


def test_attr_wrappers_refuse_bad_views(dev):
    """Every wrapper of the attribute family raises on a misaligned or
    non-contiguous view, a wrong dtype or a tensor on another device, and
    launches nothing then."""
    from voge_tpu_torch.ops.cuda_attr import attr_dw, attr_scatter, slot_runs

    idx, w, g, attrs = _slots(dev, 8, 4)
    n_rows = attrs.shape[0]
    flat = torch.empty(idx.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(idx.shape)          # contiguous, 4 bytes past a 16-byte boundary
    shifted.copy_(idx)
    strided = torch.empty(idx.shape[:-1] + (2 * idx.shape[-1],), dtype=torch.int32,
                          device=dev)[..., ::2]
    strided.copy_(idx)
    calls = {
        "attr_merge": lambda i, ww, a, gg: attr_merge(i, ww, a),
        "attr_dw": lambda i, ww, a, gg: attr_dw(i, a, gg),
        "attr_scatter": lambda i, ww, a, gg: attr_scatter(i, ww, gg, n_rows),
        "attr_merge_bwd": lambda i, ww, a, gg: attr_merge_bwd(i, ww, a, gg),
        "slot_runs": lambda i, ww, a, gg: slot_runs(i, n_rows),
    }
    fns = {"attr_merge": attr_merge, "attr_dw": attr_dw, "attr_scatter": attr_scatter,
           "attr_merge_bwd": attr_merge_bwd, "slot_runs": slot_runs}
    bad = [(shifted, w, attrs, g), (strided, w, attrs, g), (idx.long(), w, attrs, g)]
    mixed = [(idx.cpu(), w, attrs, g), (idx, w.double(), attrs.double(), g.double())]
    for name, call in calls.items():
        before = launches(fns[name])
        # slot_runs takes the ids alone, and runs its plain version on CPU ids
        for args in bad + ([] if name == "slot_runs" else mixed):
            with pytest.raises((TypeError, ValueError)):
                call(*args)
        assert launches(fns[name]) == before, name
        call(idx, w, attrs, g)                  # and launches on good views
        assert launches(fns[name]) == before + 1, name


def test_attr_scatter_long_runs(dev):
    """Runs of tens of thousands of slots on a few ids (the texture shapes'
    regime) and ids no slot holds."""
    from voge_tpu_torch.ops.cuda_attr import attr_scatter, attr_scatter_plain

    gen = torch.Generator(dev).manual_seed(9)
    idx = torch.randint(0, 6, (1, 64, 96, 80), device=dev, generator=gen, dtype=torch.int32) * 50
    w = torch.rand(idx.shape, device=dev, generator=gen)
    g = torch.rand(idx.shape[:3] + (4,), device=dev, generator=gen)
    out = attr_scatter(idx, w, g, 400)
    want = attr_scatter_plain(idx, w, g, 400)
    torch.cuda.synchronize()
    assert (out - want).abs().max() <= 1e-4 * want.abs().max()
    assert not out[1:50].any() and out[50].abs().sum() > 0
    assert torch.equal(out, attr_scatter(idx, w, g, 400))


def test_sampler_kernel_path_matches_plain(dev):
    """``sample_features`` forward and backward on the card (attr_scatter,
    attr_dw, K3f) against the plain path, two backward runs equal to the bit."""
    from voge_tpu_torch.ops.cuda_attr import attr_dw, attr_merge, attr_scatter

    idx, w, g, _ = _slots(dev, 20, 3, n_rows=500, seed=6)
    idx = torch.where(idx < 500, idx, -1)
    cf = torch.randn((500, 3), device=dev, generator=torch.Generator(dev).manual_seed(1))
    cw = torch.randn((500,), device=dev, generator=torch.Generator(dev).manual_seed(2))

    def run():
        wl, gl = w.clone().requires_grad_(True), g.clone().requires_grad_(True)
        frag = vt.Fragments(wl, idx, (idx >= 0).sum(-1), wl)
        feat, sw = vt.sample_features(frag, gl, n_vert=500)
        loss = (feat * cf).sum() + (sw * cw).sum()
        return feat, sw, torch.autograd.grad(loss, (wl, gl))

    before = launches(attr_scatter), launches(attr_dw), launches(attr_merge)
    feat, sw, grads = run()
    _, _, grads2 = run()
    torch.cuda.synchronize()
    assert (launches(attr_scatter), launches(attr_dw), launches(attr_merge)) == tuple(
        b + 2 for b in before)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    with plain_path():
        feat_p, sw_p, grads_p = run()
    for a, b in zip((feat, sw) + tuple(grads), (feat_p, sw_p) + tuple(grads_p)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    got = vt.scatter_max_weight(vt.Fragments(w, idx, (idx >= 0).sum(-1), w), n_vert=500)
    flat, wf = idx.reshape(-1).cpu().numpy(), w.reshape(-1).cpu().numpy()
    want = np.zeros(500, np.float32)
    np.maximum.at(want, flat[flat >= 0], wf[flat >= 0])
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("K", [5, 20, 40, 80])
@pytest.mark.parametrize("bin_size", [10, 7, (13, 20)])
def test_select_bins_kernel_equals_plain(stage, K, bin_size):
    """K2's per-bin-list entry against its plain version on lists from
    ``rasterize_coarse`` (edge bins with dead rays; a cap that truncates):
    selections and len / act / dsd equal, since both run the same arithmetic
    in the same order."""
    from voge_tpu_torch.ops.cuda_fine import fine_select_bins, fine_select_bins_plain

    cams, hw, rays, points, isig, _ = stage
    B, P = points.shape[:2]
    table = fine.feature_table(points, isig)
    bsh, bsw = (bin_size, bin_size) if isinstance(bin_size, int) else bin_size
    if bsh == bsw:
        bp = coarse.rasterize_coarse(*cams, points, isig, hw, 0.01, bsh, 96)
    else:   # rectangular bins: every Gaussian of the image, some entries empty
        BH, BW = (hw[0] - 1) // bsh + 1, (hw[1] - 1) // bsw + 1
        ids = torch.arange(B * P, device=rays.device, dtype=torch.int32).reshape(B, 1, 1, P)
        bp = ids.expand(B, BH, BW, P).clone()
        bp[..., ::7] = -1
    thr_act = -math.log(0.01 + 1e-10)
    before = launches(fine_select_bins)
    got = fine_select_bins(rays, table, bp, thr_act, K, bin_size)
    want = fine_select_bins_plain(rays, table, bp, thr_act, K, bin_size)
    torch.cuda.synchronize()
    assert launches(fine_select_bins) == before + 1
    assert (got[0] >= 0).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_two_stage_tracer_matches_plain_and_the_render_path(stage, monkeypatch):
    """``rasterize_coarse`` + ``ray_tracing_fine`` forward and backward on
    the card (K2's per-bin-list entry, K3's global entry with the cotangents
    of len, act and dsd and the ray gradient) against the plain path, two
    backward runs equal to the bit, and the forward against the
    emission-compacted ``ray_tracing`` with its emission binning by the
    lists' box (upstream's; K1 bins by the exact box, a superset)."""
    from voge_tpu_torch.ops.cuda_fine import fine_select_bins

    cams, hw, rays, points, isig, _ = stage
    B, P = points.shape[:2]
    K = 20
    bp, cnt = vt.ops.rasterize_coarse(*cams, points, isig, hw, 0.01, 10, P, return_counts=True)
    assert int(cnt.max()) <= P
    cots = [torch.randn(rays.shape[:3] + (K,), device=rays.device,
                        generator=torch.Generator(rays.device).manual_seed(70 + q))
            for q in range(3)]

    def run():
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (points.reshape(-1, 3), isig.reshape(-1, 3, 3), rays)]
        sel = vt.ops.ray_tracing_fine(*leaves, bp, 0.01, 10, K)
        v = sel[1] * cots[0] + sel[2] * cots[1] + sel[3] * cots[2]
        loss = torch.where(sel[0] >= 0, v, torch.zeros_like(v)).sum()
        return sel, torch.autograd.grad(loss, leaves)

    before = launches(fine_select_bins), launches(fine_bwd_global)
    sel, grads = run()
    _, grads2 = run()
    torch.cuda.synchronize()
    assert (launches(fine_select_bins), launches(fine_bwd_global)) == (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    from voge_tpu_torch.ops import cuda_fine, cuda_fine_bwd

    saved = fine.fine_select_bins, fine.fine_bwd_global
    fine.fine_select_bins = cuda_fine.fine_select_bins_plain
    fine.fine_bwd_global = cuda_fine_bwd.fine_bwd_global_plain
    try:
        sel_p, grads_p = run()
    finally:
        fine.fine_select_bins, fine.fine_bwd_global = saved
    for a, b in zip(sel, sel_p):
        assert torch.equal(a, b)
    for a, b in zip(grads, grads_p):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    from voge_tpu_torch.ops import cuda_coarse

    monkeypatch.setattr(coarse, "emit_rows", cuda_coarse.emit_rows_plain)
    monkeypatch.setattr(cuda_coarse, "_perspective_planes", cuda_coarse._upstream_planes)
    ref, overflow = vt.ops.ray_tracing(cams, points, isig, rays, hw, 0.01, K, bin_size=10)
    assert int(overflow) == 0
    for a, b in zip(sel, ref[:4]):
        assert torch.equal(a, b)


def test_texture_scale_coarse_stage_reemits(dev):
    """More Gaussians in view outgrow the 2x2 window than the global list
    holds: the emission runs again with a wider window (K1 at win 3) and
    drops nothing; kernel and plain rows are equal."""
    v, f = vt.ico_sphere(5)
    verts, isig, _ = vt.naive_vertices_converter(v, f, percentage=0.5, max_sig_rate=2)
    tt = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    R, T = vt.look_at_view_transform(dist=3, elev=0.1, azim=0.6, degrees=False, device=dev)
    cams = (R, T, tt([[1800.0, 1800.0]]), tt([[336.0, 128.0]]))
    hw = (256, 672)
    _, origins = camera_rays(*cams, hw)
    points = tt(verts)[None] - origins[:, None, :]
    isg = 2.0 * expend_sigma(tt(isig))[None]
    c = fine.compact_candidates(*cams, points, isg, hw, 0.01, 80)
    again = coarse.emit_supertile_candidates(*cams, points, isg, hw, 0.01, c.bin_size, 0,
                                             row_align=256, return_dst=True)
    assert int(c.overflow_c.sum()) == 0 and again[5][0].shape[-1] == 9
    assert all(torch.equal(a, b) for a, b in zip(again[:5], c[:5]))
    with plain_path():
        p = fine.compact_candidates(*cams, points, isg, hw, 0.01, 80)
    for a, b in zip(c[:5], p[:5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [5, 25, 40])
@pytest.mark.parametrize("cots_kind", ["all", "only_len", "none_act"])
def test_split_halves_match_plain(stage, K, cots_kind):
    rays, table, args = _global_select(stage, K, "none")
    idx, length, _, dsd, _ = fine_select_global(*args)
    cots = _cotangents(length.shape, rays.device, 3, 11)
    if cots_kind == "only_len":
        cots[1:] = [None, None]
    elif cots_kind == "none_act":
        cots[1] = None
    # some slots name no row of the table: they contribute nothing
    idx = torch.where(idx % 7 == 3, idx + table.shape[0], idx)
    halves = (rays, table, idx, length, dsd, *cots)
    before = (launches(fine_bwd_gauss), launches(fine_bwd_rays))
    rows, again = fine_bwd_gauss(*halves), fine_bwd_gauss(*halves)
    g_rays, g_again = fine_bwd_rays(*halves), fine_bwd_rays(*halves)
    torch.cuda.synchronize()
    assert (launches(fine_bwd_gauss), launches(fine_bwd_rays)) == (before[0] + 2, before[1] + 2)
    assert rows.shape == (table.shape[0], 12) and g_rays.shape == rays.shape
    assert torch.equal(rows, again) and torch.equal(g_rays, g_again)
    grad_err(rows, fine_bwd_gauss_plain(*halves))
    grad_err(g_rays, fine_bwd_rays_plain(*halves))
    empty = torch.full_like(idx, -1)
    assert not fine_bwd_gauss(rays, table, empty, length, dsd, *cots).any()
    assert not fine_bwd_rays(rays, table, empty, length, dsd, *cots).any()


@pytest.mark.parametrize("g_w", ["set", "only", "absent"])
def test_fold_then_split_pair_matches_unified_entry(stage, g_w):
    """``ops.fine.global_backward`` (the unified entry; for a frozen scene the
    per-ray half with the fold fused in, one launch) against the fold's
    entry + the split pair on the same inputs: equal to the bit (32 lanes a
    Gaussian here, as in the unified entry)."""
    rays, table, args = _global_select(stage, 25, "none")
    sel = fine_select_global(*args)
    cots = _cotangents(sel[1].shape, rays.device, 4, 7)
    if g_w == "only":
        cots[:3] = [None] * 3
    elif g_w == "absent":
        cots[3] = None
    want_rows, want_rays = fold_then_pair(rays, table, *sel, *cots, 0.9)
    fns = (fold_weights, fine_bwd_gauss, fine_bwd_rays, fine_bwd_global)
    before = [launches(fn) for fn in fns]
    rows, g_rays = fine.global_backward(rays, table, *sel, *cots, 0.9, True, True)
    none, frozen = fine.global_backward(rays, table, *sel, *cots, 0.9, False, True)
    torch.cuda.synchronize()
    assert [launches(fn) - b for fn, b in zip(fns, before)] == [0, 0, 1, 1]
    assert none is None and torch.equal(frozen, want_rays)
    assert torch.equal(rows, want_rows) and torch.equal(g_rays, want_rays)


@pytest.mark.parametrize("K", [1, 5, 20, 25, 64, 128])
@pytest.mark.parametrize("fold", ["none", "g_w", "g_w_attrs"])
def test_rays_only_launch_matches_unified_entry_and_plain(stage, K, fold):
    """The per-ray half: one launch of the per-slot kernel writing no
    coefficients, without the fold, with the fold of g_w, and with the fold
    of g_w and the attribute image's d_w (a frozen scene's backward): the ray
    gradient (and the per-ray mean gradients) equal to the bit to the unified
    entry's on the same inputs, within 1e-4 of the plain version."""
    rays, table, args = _global_select(stage, K, "none")
    sel = fine_select_global(*args)
    idx, length, act, dsd, w = sel
    cots = _cotangents(length.shape, rays.device, 4, 30 + K)
    kw, attrs, g_img = {}, None, None
    if fold != "none":
        kw = dict(act=act, w=w, g_w=cots[3], agg_ow=0.9)
    if fold == "g_w_attrs":
        attrs = torch.rand(table.shape[0], 3, device=rays.device,
                           generator=torch.Generator(rays.device).manual_seed(K))
        g_img = _cotangents(rays.shape, rays.device, 1, 40 + K)[0]
        kw.update(attrs=attrs, g_img=g_img)
    halves = (rays, table, idx, length, dsd, *cots[:3])
    before = launches(fine_bwd_rays)
    g_rays, g_mu = fine_bwd_rays(*halves, **kw, return_mu=True)
    again = fine_bwd_rays(*halves, **kw)
    torch.cuda.synchronize()
    assert launches(fine_bwd_rays) == before + 2 and torch.equal(g_rays, again)
    g_w = cots[3] if fold != "none" else None
    _, u_rays, u_mu = fine_bwd(rays, table, *sel, *cots[:3], g_w, 0.9, attrs, g_img, True,
                               return_mu=True)
    assert torch.equal(g_rays, u_rays) and torch.equal(g_mu, u_mu)
    want, want_mu = fine_bwd_rays_plain(*halves, **kw, return_mu=True)
    grad_err(g_rays, want)
    grad_err(g_mu, want_mu)


@pytest.mark.parametrize("group", [4, 8, 16, 32])
def test_per_gaussian_half_at_each_group_width(stage, group):
    """The per-Gaussian kernel with ``group`` lanes a Gaussian: runs longer
    than a warp, empty runs (seven table rows no slot names) and slot ids
    past the table, against the plain version, two runs equal to the bit
    (and to ``fine_bwd_gauss`` at the lanes ``group_width`` picks); with
    attribute columns, as K3's compacted entry composes its stages, too."""
    from voge_tpu_torch.ops import cuda_fine_bwd

    rays, table, args = _global_select(stage, 25, "none")
    sel = fine_select_global(*args)
    table = torch.cat([table, table[:7]])
    idx = torch.where(sel[0] % 11 == 5, sel[0] + table.shape[0], sel[0])
    held = torch.bincount(idx[(idx >= 0) & (idx < table.shape[0])].long(),
                          minlength=table.shape[0])
    assert held.max() > 32 and (held == 0).sum() >= 7
    cots = _cotangents(sel[1].shape, rays.device, 4, 50)
    n_tab = table.shape[0]
    order, starts = cuda_attr.slot_runs(idx, n_tab)

    def k3_at(length, act, dsd, w, grads, agg_ow, attrs, g_img):
        """K3's stages composed as its wrappers compose them, at ``group``
        lanes a Gaussian."""
        coef = cuda_fine_bwd._slots_stage(rays, table, idx, length, act, dsd, w, grads,
                                          agg_ow, attrs, g_img, True, False)[0]
        return cuda_fine_bwd._runs_stage(rays, table, coef, w, g_img, order, starts, group)

    halves = (rays, table, idx, sel[1], sel[3], *cots[:3])
    gauss = (sel[1], None, sel[3], None, (*cots[:3], None), 1.0, None, None)
    rows = k3_at(*gauss)
    assert torch.equal(rows, k3_at(*gauss))
    grad_err(rows, fine_bwd_gauss_plain(*halves))
    assert not rows[held == 0].any() and rows[held > 32].abs().sum(-1).min() > 0
    if group == cuda_fine_bwd.group_width(idx.numel(), n_tab):
        assert torch.equal(rows, fine_bwd_gauss(*halves))
    attrs = torch.rand(n_tab, 5, device=rays.device,
                       generator=torch.Generator(rays.device).manual_seed(51))
    g_img = _cotangents(rays.shape[:3] + (5,), rays.device, 1, 52)[0]
    full = (*sel[1:], tuple(cots), 0.9, attrs, g_img)
    got = k3_at(*full)
    assert torch.equal(got, k3_at(*full))
    grad_err(got, fine_bwd_plain(rays, table, idx, *sel[1:], *cots, 0.9, attrs, g_img,
                               False)[0])


def test_halves_refuse_k_above_max_on_the_card(dev):
    """Above ``MAX_K`` the per-slot kernel does not launch: both halves raise
    on CUDA tensors; the plain version takes the same tensors."""
    from voge_tpu_torch.ops.cuda_fine import MAX_K

    B, H, W, K = 1, 4, 5, MAX_K + 1
    gen = torch.Generator(dev).manual_seed(60)
    table = torch.randn(6, 16, device=dev, generator=gen)
    rays = torch.nn.functional.normalize(torch.randn(B, H, W, 3, device=dev, generator=gen),
                                         dim=-1)
    idx = torch.randint(-1, 6, (B, H, W, K), device=dev, generator=gen, dtype=torch.int32)
    length, dsd, g = (torch.rand(B, H, W, K, device=dev, generator=gen) + 0.5
                      for _ in range(3))
    halves = (rays, table, idx, length, dsd, g, None, None)
    for fn in (fine_bwd_rays, fine_bwd_gauss):
        with pytest.raises(NotImplementedError, match="MAX_K = 128; larger K takes the dense route"):
            fn(*halves)
    assert torch.isfinite(fine_bwd_rays_plain(*halves)).all()


def test_point_cloud_render_takes_the_split_path(dev, monkeypatch):
    """A 20,000-point cloud at 96x96 through ``render_pipeline`` with no
    coarse stage: forward + backward on K3's unified entry (the rule at
    every size), gradients (cameras included) against the same step on the
    fold's entry and the two halves, and the selections against the coarse
    path's."""
    pts = np.random.RandomState(0).uniform(-1, 1, (20000, 3)).astype(np.float32)
    verts, isig, _ = vt.converter.fixed_pointcloud_converter(pts, radius=0.03)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    R0, T0 = vt.look_at_view_transform(dist=4, elev=20, azim=30, device=dev)
    colors = t((verts + 1) / 2)

    def step():
        leaves = [t(verts).requires_grad_(True), t(isig).requires_grad_(True),
                  R0.clone().requires_grad_(True), T0.clone().requires_grad_(True)]
        frag = vt.render_pipeline(leaves[0], leaves[1], leaves[2], leaves[3],
                                  t([[120.0, 120.0]]), t([[48.0, 48.0]]), image_size=(96, 96),
                                  max_assign=20, max_point_per_bin=-1)
        img = vt.interpolate_attr(frag, colors)
        loss = ((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
        return frag, torch.autograd.grad(loss, leaves)

    fns = (fold_weights, fine_bwd_gauss, fine_bwd_rays, fine_bwd_global)
    before = [launches(fn) for fn in fns]
    frag, got = step()
    torch.cuda.synchronize()
    assert [launches(fn) - b for fn, b in zip(fns, before)] == [0, 0, 0, 1]
    monkeypatch.setattr(fine, "fine_bwd_global", fold_then_pair)
    _, want = step()
    torch.cuda.synchronize()
    assert [launches(fn) - b for fn, b in zip(fns, before)] == [1, 1, 1, 1]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and (a - b).norm() <= 1e-5 * b.norm()
    coarse_frag = vt.render_pipeline(t(verts), t(isig), R0, T0, t([[120.0, 120.0]]),
                                     t([[48.0, 48.0]]), image_size=(96, 96), max_assign=20)
    assert vt.get_overflow_points(coarse_frag) == 0
    agree = (coarse_frag.vert_index == frag.vert_index).all(-1)
    assert 1.0 - agree.float().mean().item() < 1e-3


def test_knn_converter_on_the_card_at_100k_points(dev):
    """``naive_point_cloud_converter`` at the published point count: the
    k-NN runs on the card in chunks of rows (a 100,000 x 100,000 float32
    matrix would be 40 GB); the first 2,000 points against a direct
    evaluation on the CPU (rtol 1e-5: float32 rounding of the distances)."""
    pts = np.random.RandomState(0).uniform(-1, 1, (100_000, 3)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    v, isig, _ = vt.naive_point_cloud_converter(pts, percentage=0.5, n_nearest=4, device=dev)
    assert torch.cuda.max_memory_allocated() < 8 * 2 ** 30
    assert v.shape == (100_000, 3) and isig.shape == (100_000,) and isig.dtype == np.float32
    assert np.isfinite(isig).all() and (isig > 0).all()
    t = torch.as_tensor(pts)
    part = torch.cdist(t[:2000], t, compute_mode="donot_use_mm_for_euclid_dist").topk(
        4, dim=1, largest=False).values.double()
    length = torch.minimum(part, part.mean(1, keepdim=True) * 2).mean(1).numpy()
    want = 1.0 / (length ** 2 / (4 * np.log(2.0)) + 1e-8)
    np.testing.assert_allclose(isig[:2000], want, rtol=1e-5)


def test_pose_kernel_path_matches_plain_path(dev):
    """Scores of six hypotheses (chunks of 4, the last padded) and three
    refinement steps on the 1K cuboid at 96x96 through the kernels and
    through the plain versions: scores within 1e-5, parameters within 1e-4
    (``tests/test_torch_cuda_paths.py`` holds the same at the full batched
    shape)."""
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000,
                                         percentage=0.6, as_obj=True, device=dev)
    feats = ((g.verts.detach() + 1) / 3).contiguous()
    scorer = vt.PoseHypothesisScorer(g.verts.detach(), g.sigmas.detach(), feats, focal=110.0,
                                     principal=(48.0, 48.0), image_size=(96, 96), chunk=4)
    assert scorer.verts.device.type == "cuda"
    poses = (torch.full((6,), 6.0, device=dev), torch.full((6,), 0.2, device=dev),
             torch.linspace(0.8, 1.4, 6, device=dev), torch.zeros(6, device=dev))
    R, T = vt.models.pose_matrices(*poses)
    with torch.no_grad():
        target = scorer.render_features(R[2:3], T[2:3])[0][0]

    def run():
        scores = scorer.score(R, T, target)
        params, sim = vt.refine_pose(scorer, target, (6.0, 0.25, 0.95, 0.0), steps=3, lr=0.01)
        return scores, torch.stack([params[k] for k in ("dist", "elev", "azim", "theta")]), sim

    fns = (emit_rows, fine_select, fine_bwd, attr_merge, fine_bwd_rays, fine_bwd_gauss)
    before = [launches(fn) for fn in fns]
    sk, pk, simk = run()
    torch.cuda.synchronize()
    ran = [launches(fn) - b for fn, b in zip(fns, before)]
    # 2 chunks + 3 steps; the scene is frozen, so the backward is the per-ray
    # half alone: no K3, no grouping of its slots
    assert ran[0] >= 5 and ran[1:] == [5, 0, 5, 3, 0]
    with plain_path():
        sp, pp, simp = run()
    assert sk.shape == (6,) and int(sk.argmax()) == 2
    assert (sk - sp).abs().max().item() <= 1e-5 and abs(simk - simp) <= 1e-5
    assert (pk - pp).abs().max().item() <= 1e-4


def test_slice_entry_points_default_to_the_card(dev, tmp_path):
    """The loaders, the checkpoint and the pose entry points called without a
    ``device`` put what they make on the card, and a scene loaded that way
    renders through the kernels."""
    from voge_tpu_torch import checkpoint
    from voge_tpu_torch.converter import converters, io as tio

    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    isig = np.full((500,), 300.0, np.float32)
    off, goff, npz = (str(tmp_path / n) for n in ("m.off", "s.goff", "s.npz"))
    tio.save_off(off, pts, np.zeros((1, 3), np.int64))
    tio.save_goff(goff, pts, isig)
    loaded = tio.load_goff(goff, to_torch=True)
    made = [tio.load_off(off, to_torch=True)[0], tio.load_off(off, to_torch=True)[1],
            loaded[0], loaded[1], tio.to_torch(pts)[0],
            vt.models.pose_matrices(3.0, 0.1, 0.2, 0.3)[0],
            converters.to_gaussian_mesh(vt.fixed_pointcloud_converter, radius=0.05)(pts).verts]
    g = vt.GaussianMeshes(*loaded)
    checkpoint.save_scene(npz, g)
    made += [g.verts, checkpoint.load_scene(npz)[0].verts,
             checkpoint.load_scene(npz, naive=True)[0].verts]
    assert all(t.device.type == "cuda" for t in made)
    assert tio.load_off(off, to_torch=True, device="cpu")[0].device.type == "cpu"
    R, T = vt.look_at_view_transform(dist=4.0, elev=20.0, azim=30.0)
    before = launches(fine_select)
    frag = vt.render_pipeline(g.verts, g.sigmas, R, T, torch.tensor([[100.0, 100.0]], device="cuda"),
                              torch.tensor([[32.0, 32.0]], device="cuda"), image_size=(64, 64),
                              max_assign=8)
    assert launches(fine_select) == before + 1 and frag.vert_index.device.type == "cuda"
    assert (frag.vert_index >= 0).any().item()


# ---- K2 on the shared-memory top-K: every entry, every K ---------------------

ALL_K = [5, 8, 16, 20, 25, 32, 64, 80, 128]


@pytest.mark.parametrize("K", ALL_K)
@pytest.mark.parametrize("entry", ["compacted", "compacted_attrs", "global", "global_bits", "bins"])
def test_select_entries_equal_plain_at_every_k(every_k_stage, entry, K):
    """Each entry of K2 at every K on the two small scenes and on the 1K
    cuboid at 128x128: equal to its plain version (``equal_select``), two
    runs equal to the bit."""
    from voge_tpu_torch.ops.cuda_fine import fine_select_bins, fine_select_bins_plain

    stage = every_k_stage
    cams, hw, rays, points, isig, colors = stage
    thr_act = -math.log(0.01 + 1e-10)
    if entry.startswith("compacted"):
        c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
        table = fine.feature_table(points, isig)
        args = (rays, table, c.bits_c, c.ids_c, c.counts_c, c.thr_act, K, c.bin_size, 0.9,
                colors if entry.endswith("attrs") else None)
        kfn, pfn = fine_select, fine_select_plain
    elif entry.startswith("global"):
        _, _, args = _global_select(stage, K, "random" if entry.endswith("bits") else "none")
        kfn, pfn = fine_select_global, fine_select_global_plain
    else:
        bp = coarse.rasterize_coarse(*cams, points, isig, hw, 0.01, 10, 150)
        args = (rays, fine.feature_table(points, isig), bp, thr_act, K, 10)
        kfn, pfn = fine_select_bins, fine_select_bins_plain
    got, want = kfn(*args), pfn(*args)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], kfn(*args)[:4]))
    torch.cuda.synchronize()
    assert (got[0] >= 0).any()
    equal_select(got, want)


def _edge_scene(dev, B, P, seed, behind=0, dup=1, needles=False):
    """Rays of B small cameras and a (B * P * dup, 16) table: anisotropic
    Gaussians in front of the camera, ``behind`` of them mirrored behind it,
    the whole set repeated ``dup`` times (exact ties).  ``needles``: axis
    ratio 1:100 (Lambda's condition 1e4) in every orientation, spread past
    the image so that many lie at the edge of a block's cone cull."""
    rng = np.random.RandomState(seed)
    H, W = 37, 45
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d = np.stack([(xx - W / 2 + 0.5) / 40.0, (yy - H / 2 + 0.5) / 40.0,
                  np.ones_like(xx, dtype=np.float64)], -1)
    rays = np.stack([d / np.linalg.norm(d, axis=-1, keepdims=True)] * B).astype(np.float32)
    mus = np.concatenate([rng.uniform(-0.5, 0.5, (B, P, 2)), rng.uniform(2, 4, (B, P, 1))], -1)
    mus[:, :behind] *= -1.0
    a = rng.uniform(-1, 1, size=(B, P, 3, 3))
    lam = (np.einsum("bmij,bmkj->bmik", a, a) + 0.5 * np.eye(3)) * 40.0
    if needles:
        mus[..., :2] *= 4.0
        sig = 0.3 * np.stack([np.ones((B, P)), 10.0 ** (-2.0 * rng.rand(B, P)),
                              np.full((B, P), 0.01)], -1)
        q = np.linalg.qr(rng.normal(size=(B, P, 3, 3)))[0]
        lam = np.einsum("bmij,bmj,bmkj->bmik", q, 1.0 / sig ** 2, q)
    mus, lam = np.tile(mus, (1, dup, 1)), np.tile(lam, (1, dup, 1, 1))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return t(rays), t(mus), t(lam)


@pytest.mark.parametrize("case", ["ties", "behind", "one_image", "few", "short_rows", "needles"])
def test_select_edge_cases_equal_plain(dev, case):
    """Exact ties (an earlier candidate wins), Gaussians behind the camera
    (selected like any other), B = 1, fewer Gaussians than K, compacted
    rows with an empty supertile and one whose count is 0, and needles of
    axis ratio 1:100 at the edge of the blocks' cone cull (some behind the
    camera): the culled kernel against the plain version in float32."""
    from voge_tpu_torch.ops import cuda_fine

    thr_act = -math.log(0.01 + 1e-10)
    B, P, K = (1, 333, 20) if case == "one_image" else (2, 150, 20)
    if case == "few":
        P, K = 7, 25
    if case == "needles":
        P = 900
    rays, mus, lam = _edge_scene(dev, B, P, 21,
                                 behind={"behind": 40, "needles": 90}.get(case, 0),
                                 dup=3 if case == "ties" else 1, needles=case == "needles")
    table = fine.feature_table(mus, lam)
    if case != "short_rows":
        args = (rays, table, None, thr_act, K, 6, 1.0)
        got, want = fine_select_global(*args), fine_select_global_plain(*args)
        equal_select(got, want)
        valid = got[0] >= 0
        assert valid.any()
        if case == "needles":
            for a, b in zip(got, fine_select_global(*args, _cull=False)):
                assert torch.equal(a, b)
            th, tw = cuda_fine.global_tile(False, 6)
            cones, rows = cuda_fine.block_cones(rays[:1], th, tw), cuda_fine.cull_rows(
                table[:P], thr_act)
            mask = cuda_fine.cull_mask_plain(cones, rows)
            assert 0.1 < mask.float().mean() < 0.95
            near = rows * torch.tensor([1.0, 1.0, 1.0, 0.95], device=dev)
            assert (mask ^ cuda_fine.cull_mask_plain(cones, near)).any()   # pairs at the bound
        if case == "ties":     # the three copies of a Gaussian tie: ascending ids win
            same = (got[1][..., 1:] == got[1][..., :-1]) & valid[..., 1:]
            assert same.any() and (got[0][..., 1:] > got[0][..., :-1])[same].all()
        if case == "behind":
            assert (got[1][valid] < 0).any()
        return
    nb = B * math.prod(coarse.supertile_grid(37, 45, 6))
    M = 256
    gen = torch.Generator(dev).manual_seed(8)
    pos = torch.stack([torch.randperm(P, device=dev, generator=gen).sort().values
                       for _ in range(nb)])[:, :M].to(torch.int32)
    pos = torch.nn.functional.pad(pos, (0, M - pos.shape[1]))
    counts = torch.randint(0, P + 1, (nb,), device=dev, generator=gen).to(torch.int32)
    counts[0], counts[nb // 2] = 0, 0
    bits = torch.randint(1, 16, (nb, M), device=dev, generator=gen).to(torch.int32)
    img = torch.arange(nb, device=dev)[:, None] // (nb // B)
    occupied = torch.arange(M, device=dev)[None] < counts[:, None]
    ids = torch.where(occupied, img * P + pos, -1).to(torch.int32)
    args = (rays, table, bits, ids, counts, thr_act, K, 6, 0.8, None)
    got, want = fine_select(*args), fine_select_plain(*args)
    equal_select(got, want)
    assert (got[0] >= 0).any()


@pytest.mark.parametrize("K", [20, 80])
def test_global_select_is_the_same_with_and_without_the_cull(stage, K):
    """The cone cull drops only pairs the hit test would reject: every output
    bit equals the kernel's without it; two runs equal to the bit.  The glue
    kernels count their launches, one each a culled call and none otherwise."""
    from voge_tpu_torch.ops import cuda_fine

    _, _, args = _global_select(stage, K, "none")
    glue = (cuda_fine.cull_rows, cuda_fine.block_cones)
    before = [launches(fn) for fn in glue]
    culled = fine_select_global(*args)
    again = fine_select_global(*args)
    assert [launches(fn) for fn in glue] == [n + 2 for n in before]
    plain_walk = fine_select_global(*args, _cull=False)
    assert [launches(fn) for fn in glue] == [n + 2 for n in before]
    torch.cuda.synchronize()
    for a, b, c in zip(culled, again, plain_walk):
        assert torch.equal(a, b) and torch.equal(a, c)
    th, tw = cuda_fine.global_tile(False, 10)
    mask = cuda_fine.cull_mask_plain(
        cuda_fine.block_cones(args[0][:1], th, tw),
        cuda_fine.cull_rows(args[1][:args[1].shape[0] // args[0].shape[0]], args[3]))
    assert 0 < mask.float().mean() < 1


def _route(monkeypatch, two: bool, S=None):
    """Force the global entry's route: two levels (super-tiles of ``S``
    blocks a side) or one, whatever the rule would pick."""
    from voge_tpu_torch.ops import cuda_fine

    monkeypatch.setattr(cuda_fine, "_TWO_LEVEL_MIN_PAIRS", 0 if two else 1 << 62)
    if S is not None:
        monkeypatch.setattr(cuda_fine, "_SUPER", S)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("K", [5, 20, 40])
def test_two_level_route_equals_one_level_and_the_cull_off(stage, monkeypatch, K, S):
    """The two-level cull (super-tiles of S x S blocks; at S = 2 and 4 the
    52 x 60 images' 7 x 4 blocks leave super-tiles cut by the edge; a warp
    of a block walks the rows its own 4 x 8 pixels' cone keeps) gives every
    output bit of the single-level route and of the kernel with the cull
    off; its level 1 is launched once a call, with its super-tiles' cones,
    and the glue kernels hold to their plain versions."""
    from voge_tpu_torch.ops import cuda_fine

    _, _, args = _global_select(stage, K, "none")
    rays, table = args[0], args[1]
    _route(monkeypatch, True, S)
    before = [launches(fn) for fn in (cuda_fine.cull_lists, cuda_fine.super_cones)]
    two = fine_select_global(*args)
    assert [launches(fn) for fn in (cuda_fine.cull_lists, cuda_fine.super_cones)] == [
        n + 1 for n in before]
    _route(monkeypatch, False)
    one = fine_select_global(*args)
    off = fine_select_global(*args, _cull=False)
    assert [launches(fn) for fn in (cuda_fine.cull_lists, cuda_fine.super_cones)] == [
        n + 1 for n in before]
    torch.cuda.synchronize()
    for a, b, c in zip(two, one, off):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert (two[0] >= 0).any()
    B = rays.shape[0]
    P = table.shape[0] // B
    cones, sup, (TH4, TW4) = cuda_fine.two_level_cones(rays, S)
    sup_p = cuda_fine.super_cones_plain(cones, B, TH4, TW4, 2 * S)
    torch.testing.assert_close(sup, sup_p, rtol=0, atol=1e-6)
    rows = cuda_fine.cull_rows(table, args[3])
    mask, mask_p = cuda_fine.cull_lists(rows, sup, B, P), cuda_fine.cull_lists_plain(rows, sup, B, P)
    assert torch.equal(mask, mask_p)


@pytest.mark.parametrize("K", [5, 20, 40])
@pytest.mark.parametrize("side", ["below", "above"])
def test_two_level_rule_by_shape(dev, K, side):
    """The rule picks the route from P and the blocks of an image alone: one
    level launch of ``cull_lists`` a call at or above the threshold, none
    below it; either way every output bit is the cull-off kernel's."""
    from voge_tpu_torch.ops import cuda_fine

    H, W = 37, 45
    blocks = ((H - 1) // 8 + 1) * ((W - 1) // 16 + 1)
    edge = -(-cuda_fine._TWO_LEVEL_MIN_PAIRS // blocks)
    P = edge if side == "above" else edge - 1
    assert cuda_fine.two_level(P, blocks) == (side == "above")
    rng = np.random.RandomState(31)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d = np.stack([(xx - W / 2 + 0.5) / 40.0, (yy - H / 2 + 0.5) / 40.0, np.ones((H, W))], -1)
    rays = torch.as_tensor((d / np.linalg.norm(d, axis=-1, keepdims=True))[None],
                           dtype=torch.float32, device=dev)
    mus = np.concatenate([rng.uniform(-0.6, 0.6, (P, 2)), rng.uniform(2, 4, (P, 1))], -1)
    lam = np.broadcast_to(np.eye(3) * 2.0 / (2 * 0.01 ** 2), (P, 3, 3))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    table = fine.feature_table(t(mus)[None], t(lam)[None])
    args = (rays, table, None, -math.log(0.01 + 1e-10), K, 8, 1.0)
    before = launches(cuda_fine.cull_lists)
    got = fine_select_global(*args)
    assert launches(cuda_fine.cull_lists) == before + (side == "above")
    torch.cuda.synchronize()
    for a, b in zip(got, fine_select_global(*args, _cull=False)):
        assert torch.equal(a, b)
    assert (got[0] >= 0).any()


def test_global_entry_kernels_are_the_select_layers(stage, monkeypatch):
    """Every kernel the global entry launches on either route is one of the
    select layer's (``portbench``'s ``select.device_ms`` patterns, matched
    as whole identifiers), so none of its time counts as glue."""
    import importlib.util
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from portbench.layers import matches

    path = Path(__file__).resolve().parent.parent / "portbench" / "metrics" / "select.device_ms.py"
    spec = importlib.util.spec_from_file_location("select_device_ms", path)
    layer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(layer)
    _, _, args = _global_select(stage, 20, "none")
    names = set()
    trace.disable()            # the counters' own sums are tracing's, not the entry's
    try:
        for two in (True, False):
            _route(monkeypatch, two)
            fine_select_global(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fine_select_global(*args)
                torch.cuda.synchronize()
            names |= {ev.key for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and not ev.is_user_annotation}
    finally:
        trace.enable()
    assert len(names) >= 5, names          # cull rows, block and super-tile cones, two selects
    assert [n for n in names if not matches(n, layer.PATTERNS)] == []


def test_renderer_takes_numpy_camera_kwargs_on_the_card(dev):
    """``renderer(gmesh, R=R, T=T)`` with numpy arrays beside cameras on the
    card renders, equal to the call with card tensors to the bit."""
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6,
                                         as_obj=True, device=dev)
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70, device=dev)
    cam = vt.PerspectiveCameras(focal_length=150.0, principal_point=((64.0, 64.0),),
                                image_size=((128, 128),), device=dev)
    rend = vt.GaussianRenderer(cam, vt.GaussianRenderSettings(image_size=(128, 128)))
    want = rend(g, R=R, T=T)
    got = rend(g, R=R.cpu().numpy().astype(np.float64), T=T.cpu().numpy())
    assert got.vert_index.device.type == "cuda" and (got.vert_index >= 0).any()
    for name in ("vert_index", "vert_weight", "vert_hit_length"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("tile", [(8, 16), (20, 20), (13, 7)])
def test_cull_glue_kernels_match_plain(stage, tile):
    """The cull rows and block cones computed on the card against their plain
    versions (float64 inside both): to 1e-6, q to a relative 1e-5, the same
    rows never culled; a ray that is not finite gives a cone that culls
    nothing."""
    from voge_tpu_torch.ops import cuda_fine

    _, _, rays, points, isig, _ = stage
    table = fine.feature_table(points, isig).clone()
    table[3, 4] = -1.0          # not positive definite
    table[5, 13:16] = 0.0       # at the camera
    table[9, 8] = float("nan")
    thr_act = -math.log(0.01 + 1e-10)
    rows, want = cuda_fine.cull_rows(table, thr_act), cuda_fine.cull_rows_plain(table, thr_act)
    assert torch.equal(rows[:, 3] > 0, want[:, 3] > 0) and (rows[:, 3] > 0).any()
    assert not rows[[3, 5, 9]].any()
    torch.testing.assert_close(rows[:, :3], want[:, :3], rtol=0, atol=1e-6)
    torch.testing.assert_close(rows[:, 3], want[:, 3], rtol=1e-5, atol=0)
    rays = rays.clone()
    rays[1, 30, 40, 2] = float("inf")
    cones, want = cuda_fine.block_cones(rays, *tile), cuda_fine.block_cones_plain(rays, *tile)
    assert cones.shape == want.shape
    assert torch.equal(torch.isnan(cones[:, 3]), torch.isnan(want[:, 3]))
    assert torch.isnan(cones[:, 3]).any() and not torch.isnan(cones[:, 3]).all()
    ok = ~torch.isnan(want[:, 3])
    torch.testing.assert_close(cones[ok], want[ok], rtol=0, atol=1e-6)


def _hold_runs(idx, n_rows):
    """``hold_runs`` (against torch.sort + searchsorted), one launch a call."""
    from voge_tpu_torch.ops.cuda_attr import slot_runs

    before = launches(slot_runs)
    v = hold_runs(idx, n_rows)
    torch.cuda.synchronize()
    assert launches(slot_runs) == before + 2
    return v


@pytest.mark.parametrize("slots", [300_000, 1 << 20])
@pytest.mark.parametrize("K", [1, 20, 80, 128])
@pytest.mark.parametrize("n_rows", [1, 255, 256, 257, 65535, 65536, 65537, 300000])
def test_slot_runs_kernel_equals_plain(dev, n_rows, K, slots):
    """Random ids (a third empty, some at or above ``n_rows``) at one, two
    and three radix passes, more than one tile of 2,048 slots, on about
    300,000 slots and on a million."""
    gen = torch.Generator(dev).manual_seed(n_rows + K)
    idx = torch.randint(-(n_rows // 2) - 1, n_rows + 4, (max(1, slots // K), K),
                        dtype=torch.int32, device=dev, generator=gen).clamp(min=-1)
    assert _hold_runs(idx, n_rows) == int(((idx >= 0) & (idx < n_rows)).sum())


@pytest.mark.parametrize("kind", ["all_empty", "one_id", "all_empty_2^20", "one_id_2^20",
                                  "all_beyond", "one_slot", "texture"])
def test_slot_runs_kernel_edge_cases(dev, kind):
    """Every slot empty and one id in every slot (on 81,980 slots and on
    2^20), every id out of range, one slot, and the texture shapes' 13.76 M
    slots on 10,242 ids."""
    gen = torch.Generator(dev).manual_seed(8)
    full = lambda v, shape=(4099, 20): torch.full(shape, v, dtype=torch.int32, device=dev)
    idx, n_rows = {
        "all_empty": lambda: (full(-1), 1000), "one_id": lambda: (full(5), 10),
        "all_empty_2^20": lambda: (full(-1, (1 << 20,)), 1000),
        "one_id_2^20": lambda: (full(5, (1 << 20,)), 10),
        "all_beyond": lambda: (full(300), 300),
        "one_slot": lambda: (torch.full((1, 1), 7, dtype=torch.int32, device=dev), 8),
        "texture": lambda: (torch.randint(-4000, 10242, (1, 256, 672, 80), dtype=torch.int32,
                                          device=dev, generator=gen).clamp(min=-1), 10242),
    }[kind]()
    v = _hold_runs(idx, n_rows)
    assert v == {"all_empty": 0, "one_id": idx.numel(), "all_empty_2^20": 0,
                 "one_id_2^20": idx.numel(), "all_beyond": 0, "one_slot": 1}.get(kind, v)


def test_run_kernels_keep_their_bits_with_the_plain_grouping(stage, monkeypatch):
    """``attr_scatter``, K4b and K3's two entries (and the per-Gaussian half)
    give the same bits with the grouping kernel as with the plain grouping
    handed to the same run kernels."""
    from voge_tpu_torch.ops import cuda_fine_bwd
    from voge_tpu_torch.ops.cuda_attr import attr_scatter, slot_runs_plain

    rays, table, args = _global_select(stage, 25, "none")
    sel = fine_select_global(*args)
    cots = _cotangents(sel[1].shape, rays.device, 4, 21)
    attrs = torch.rand(table.shape[0], 5, device=rays.device,
                       generator=torch.Generator(rays.device).manual_seed(22))
    g_img = _cotangents(rays.shape[:3] + (5,), rays.device, 1, 23)[0]

    def run_all():
        return (attr_scatter(sel[0], sel[4], g_img, table.shape[0]),
                *attr_merge_bwd(sel[0], sel[4], attrs, g_img),
                *fine_bwd(rays, table, *sel, *cots, 0.9, attrs, g_img, True),
                *fine_bwd_global(rays, table, *sel, *cots, 0.9, True),
                fine_bwd_gauss(rays, table, sel[0], sel[1], sel[3], *cots[:3]))

    kernel = run_all()
    monkeypatch.setattr(cuda_attr, "slot_runs", slot_runs_plain)
    monkeypatch.setattr(cuda_fine_bwd, "slot_runs", slot_runs_plain)
    plain = run_all()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kernel, plain))


def test_attr_scatter_warp_and_block_runs(dev):
    """Runs a warp sums (empty, 1, 33, 127, 128 slots) beside runs a whole
    block sums (129, 512, 5,000 slots) in one call: against the plain
    version, and every row equal to the bit to the same row scattered
    alone."""
    from voge_tpu_torch.ops.cuda_attr import attr_scatter, attr_scatter_plain

    lens = [0, 1, 33, 127, 128, 129, 5000, 0, 512, 2]
    n_rows, K, d = len(lens), 8, 11
    gen = torch.Generator(dev).manual_seed(30)
    ids = torch.cat([torch.full((n,), j, dtype=torch.int32) for j, n in enumerate(lens)])
    ids = ids[torch.randperm(ids.numel(), generator=torch.Generator().manual_seed(31))]
    n_pix = -(-ids.numel() // K) + 3
    idx = torch.full((n_pix * K,), -1, dtype=torch.int32)
    pos = torch.randperm(n_pix * K, generator=torch.Generator().manual_seed(32))[:ids.numel()]
    idx[pos.sort().values] = ids
    idx = idx.reshape(n_pix, K).to(dev)
    w = torch.rand((n_pix, K), device=dev, generator=gen)
    g = torch.randn((n_pix, d), device=dev, generator=gen)
    out = attr_scatter(idx, w, g, n_rows)
    grad_err(out, attr_scatter_plain(idx, w, g, n_rows))
    assert torch.equal(out, attr_scatter(idx, w, g, n_rows))
    assert not out[0].any() and not out[7].any()
    for j in range(n_rows):   # row j alone: the other ids moved out of range
        alone = attr_scatter(torch.where(idx == j, idx, n_rows + 1), w, g, n_rows)
        assert torch.equal(alone[j], out[j]), j


def test_slot_runs_checks_its_inputs(dev):
    """On the card the grouping takes int32 ids and a positive row count, or
    raises; it never falls back to its plain version."""
    from voge_tpu_torch.ops.cuda_attr import slot_runs

    idx = torch.zeros((4, 5), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        slot_runs(idx.long(), 10)
    for n_rows in (0, -3):
        with pytest.raises(ValueError):
            slot_runs(idx, n_rows)
    with pytest.raises(ValueError):
        slot_runs(idx[:0], 10)


# ---- the dense route, the B = 8 and occlusion steps, timing ----------------

def _k200_step(verts, sigmas, colors, cams, mode, f64=False):
    """The K = 200 render in ``mode`` (thr 0.01 with the coarse stage, or
    thr 1e-8 without one), bench's loss and its gradients (``f64``: the
    float64 oracle)."""
    thr, mppb = {"coarse": (0.01, None), "no_coarse": (1e-8, -1)}[mode]
    dt = torch.float64 if f64 else torch.float32
    v, s, c = (x.detach().to(dt).requires_grad_(True) for x in (verts, sigmas, colors))
    render = vt.oracle.render if f64 else vt.render_pipeline
    frag = render(v, s, *cams, image_size=(48, 48), max_assign=200, thr_activation=thr,
                  max_point_per_bin=mppb, attrs=c)
    loss = ((frag.attr_img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
    return frag, loss, torch.autograd.grad(loss, (v, s, c))


@pytest.mark.parametrize("mode", ["coarse", "no_coarse"])
def test_dense_route_on_the_card_matches_its_cpu_result(dev, mode):
    """K = 200 on the 10K cuboid at 48x48: the dense route on the card (its
    select in torch ops, K3f / K4b and the grouped scatter in the backward)
    against the same route on the CPU: selections equal but for knife-edge
    pixels, weights and image within 1e-4, gradients within 1e-4 of their
    largest entry; two backward runs equal to the bit; pixels past 128
    hits; the float64 oracle on the card agrees with the float32 route."""
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 10000, percentage=0.6,
                                         as_obj=True, device="cpu")
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70, device="cpu")
    cams = (R, T, torch.tensor([[56.25, 56.25]]), torch.tensor([[24.0, 24.0]]))
    colors = (g.verts.detach() + 1) / 3
    cpu = _k200_step(g.verts, g.sigmas, colors, cams, mode)
    on = lambda xs: tuple(x.to(dev) for x in xs)
    gpu = _k200_step(*on((g.verts, g.sigmas, colors)), on(cams), mode)
    again = _k200_step(*on((g.verts, g.sigmas, colors)), on(cams), mode)
    assert all(torch.equal(a, b) for a, b in zip(gpu[2], again[2]))
    assert (gpu[0].valid_num > 128).any()
    agree = (gpu[0].vert_index.cpu() == cpu[0].vert_index).all(-1)
    assert 1.0 - agree.float().mean().item() < 1e-3
    for a, b in ((gpu[0].vert_weight, cpu[0].vert_weight), (gpu[0].attr_img, cpu[0].attr_img)):
        assert (a.detach().cpu()[agree] - b.detach()[agree]).abs().max().item() <= 1e-4
    for a, b in zip(gpu[2], cpu[2]):
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    o64 = _k200_step(*on((g.verts, g.sigmas, colors)), on(cams), mode, f64=True)
    assert (o64[0].vert_index == gpu[0].vert_index).all(-1).float().mean().item() > 0.999
    for a, b in zip(gpu[2], o64[2]):
        assert ((a.double() - b).norm() / b.norm()).item() < 1e-3


def test_k_above_128_stays_off_the_kernels_and_k128_off_the_dense_route(dev, monkeypatch):
    """On the card a render at K = 200 runs the dense route (no K2), one at
    K = 128 the select kernel (no dense route)."""
    from voge_tpu_torch.ops import dense_select

    calls = []
    orig = dense_select.fine_forward
    monkeypatch.setattr(dense_select, "fine_forward",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6,
                                         as_obj=True, device=dev)
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70, device=dev)
    cams = (R, T, torch.tensor([[60.0, 60.0]], device=dev), torch.tensor([[20.0, 20.0]], device=dev))
    for K, want in ((128, []), (200, [1])):
        calls.clear()
        trace.reset()
        vt.render_pipeline(g.verts, g.sigmas, *cams, image_size=(40, 40), max_assign=K)
        assert calls == want and (launches(fine_select) > 0) == (K <= 128)


def _batch8_step(dev, verts, sigmas, colors):
    R, T = vt.look_at_view_transform(dist=[6.0] * 8, elev=list(np.linspace(5, 25, 8)),
                                     azim=list(np.linspace(50, 90, 8)), device=dev)
    f = torch.full((8, 2), 56.25, device=dev)
    pp = torch.full((8, 2), 24.0, device=dev)
    ctx = vt.precompute_camera_ctx(R, T, f, pp, (48, 48), verts.shape[0])
    v, s, c = (x.detach().requires_grad_(True) for x in (verts, sigmas, colors))
    frag = vt.render_pipeline(v, s, R, T, f, pp, image_size=(48, 48), max_assign=20,
                              cam_ctx=ctx, attrs=c)
    loss = ((frag.attr_img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
    return loss, torch.autograd.grad(loss, (v, s, c))


def test_batch8_step_repeats_to_the_bit_and_matches_the_plain_path(dev):
    """The headline step at B = 8 (1K cuboid, the bench's eight cameras,
    48x48): two runs equal to the bit, the gradients within 1e-4 of the
    plain path's largest entry (the same step on CPU tensors)."""
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6,
                                         as_obj=True, device=dev)
    colors = (g.verts.detach() + 1) / 3
    a = _batch8_step(dev, g.verts, g.sigmas, colors)
    b = _batch8_step(dev, g.verts, g.sigmas, colors)
    assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    p = _batch8_step(torch.device("cpu"), *(x.detach().cpu() for x in (g.verts, g.sigmas, colors)))
    assert abs(a[0].item() - p[0].item()) <= 1e-5 * abs(p[0].item())
    for x, y in zip(a[1], p[1]):
        assert (x.cpu() - y).abs().max().item() <= 1e-4 * y.abs().max().item()


def test_occlusion_step_repeats_to_the_bit(dev):
    """The occlusion step (two cuboids, 400 + 300 requested, 160x160, focal
    120, K = 60, ``max_point_per_bin=200``: the ``m_min`` branch) on the
    card: two backward runs equal to the bit, overflow 0, the gradients
    within 1e-4 of the plain path's largest entry."""
    C0 = [[0, 0.2, 1], [0, 0.2, 1], [0, 1, 0.2], [0, 1, 0.2], [0, 1, 1], [0, 1, 1]]
    C1 = [[1, 0.2, 0], [1, 0.2, 0], [1, 1, 0], [1, 1, 0], [0.2, 1, 0], [0.2, 1, 0]]
    cg = vt.converter.Cuboid.cuboid_gauss
    v0, s0, c0 = cg((-0.8, 0.8), (-0.4, 0.4), (-0.6, 0.6), 400, colors=np.array(C0), percentage=0.7)
    v1, s1, c1 = cg((-1, 1), (-1, 1), (-0.3, 0.3), 300, colors=np.array(C1), percentage=0.7)
    arrs = (np.concatenate([v0 + np.array([[0.5, 0, 1]]), v1]), np.concatenate([s0, s1]),
            np.concatenate([c0, c1]))

    def step(d):
        v, s, c = (torch.tensor(x, dtype=torch.float32, device=d, requires_grad=True)
                   for x in arrs)
        R, T = vt.look_at_view_transform(dist=5, elev=10, azim=20, device=d)
        cams = (R, T, torch.tensor([[120.0, 120.0]], device=d), torch.tensor([[80.0, 80.0]], device=d))
        frag = vt.render_pipeline(v, s, *cams, image_size=(160, 160), max_assign=60,
                                  max_point_per_bin=200)
        assert vt.get_overflow_points(frag) == 0
        img = vt.interpolate_attr(frag, c)
        loss = ((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
        return torch.autograd.grad(loss, (v, s, c))

    a, b, p = step(dev), step(dev), step(torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for x, y in zip(a, p):
        assert (x.cpu() - y).abs().max().item() <= 1e-4 * y.abs().max().item()


def test_timing_uses_cuda_events_on_card_tensors(dev):
    from voge_tpu_torch import timing

    x = torch.randn(1 << 20, device=dev)
    seen = []
    out = timing.measure_stats(lambda a: (a * 2).sum(), n=5,
                               args_fn=lambda i: (seen.append(i), (x + i,))[1])
    assert set(out) == {"median", "estimates", "spread", "iqr_spread"}
    assert seen == list(range(6)) and len(out["estimates"]) == 5
    assert all(0 < e < 1 for e in out["estimates"])


@pytest.mark.parametrize("shape,axis,ring", [((2, 1), None, False), ((2, 2), "model", False),
                                             ((2, 2), "model", True)])
def test_sharded_render_on_the_card_follows_the_plain_path(dev, shape, axis, ring):
    """``parallel.render_pipeline_sharded`` with every shard on the card
    against the same mesh of logical CPU shards (the plain versions):
    selections, weights and the gradients of a seeded loss; two runs on the
    card equal to the bit.  ``make_mesh()`` takes the cards."""
    from voge_tpu_torch.parallel import interpolate_attr_sharded, make_mesh, render_pipeline_sharded

    assert all(d.type == "cuda" for d in make_mesh().devices.flat)
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6)
    verts = np.pad(g[0], ((0, 2), (0, 0)), constant_values=100.0).astype(np.float32)
    sig = np.pad(g[1], (0, 2), constant_values=1.0).astype(np.float32)
    cols = np.random.RandomState(0).uniform(0, 1, (verts.shape[0], 3)).astype(np.float32)
    assert verts.shape[0] % 2 == 0

    def step(d):
        mesh = make_mesh(("data", "model"), shape, devices=[d] * (shape[0] * shape[1]))
        v, s, c = (torch.tensor(x, device=d, requires_grad=True) for x in (verts, sig, cols))
        R, T = vt.look_at_view_transform(dist=[6.0] * 4, elev=[5.0, 10.0, 15.0, 20.0],
                                         azim=[50.0, 60.0, 70.0, 80.0], device=d)
        cams = (R, T, torch.full((4, 2), 150.0, device=d), torch.full((4, 2), 64.0, device=d))
        frag = render_pipeline_sharded(v, s, *cams, mesh=mesh, model_axis=axis, ring=ring,
                                       image_size=(128, 128), max_assign=20)
        assert vt.get_overflow_points(frag) == 0 and frag.vert_index.device.type == d.type
        img = interpolate_attr_sharded(frag, c, mesh)
        loss = ((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
        return frag, torch.autograd.grad(loss, (v, s, c))

    (fa, a), (_, b), (fp, p) = step(dev), step(dev), step(torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    agree = (fa.vert_index.cpu() == fp.vert_index).all(-1)
    assert 1.0 - agree.float().mean().item() < 1e-3
    assert (fa.vert_weight.cpu() - fp.vert_weight)[agree].abs().max().item() <= 1e-4
    for x, y in zip(a, p):
        assert (x.cpu() - y).abs().max().item() <= 1e-4 * y.abs().max().item()
