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
selections equal to the plain version's, the rest as above.
"""
import math

import numpy as np
import pytest
import torch

import voge_tpu_torch as vt
from voge_tpu_torch.aggregation import expend_sigma
from voge_tpu_torch.ops import coarse, cuda_attr, fine
from voge_tpu_torch.ops.cuda_attr import (
    attr_merge, attr_merge_bwd, attr_merge_bwd_plain, attr_merge_plain,
)
from voge_tpu_torch.ops.cuda_coarse import emit_keys, emit_keys_plain
from voge_tpu_torch.ops.cuda_fine import (
    fine_select, fine_select_global, fine_select_global_plain, fine_select_plain,
)
from voge_tpu_torch.ops.cuda_fine_bwd import (
    fine_bwd, fine_bwd_global, fine_bwd_global_plain, fine_bwd_plain, fold_weights,
    fold_weights_plain,
)
from voge_tpu_torch.rays import camera_rays

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["random", "cuboid"])
def stage(request, dev):
    """Two cameras over a random anisotropic scene (with one oversize
    global member) or the 1K cuboid: rays, camera-centred points and
    precisions, colours."""
    B, hw = 2, (52, 60)
    if request.param == "random":
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


def test_emit_kernel_equals_plain(stage):
    cams, hw, _, points, isig, _ = stage
    bs = 10
    args = (*cams, points, isig, 0.01, bs, hw,
            *coarse.emission_geometry(points.shape[1], hw, bs))
    before = emit_keys.launches
    got = emit_keys(*args)
    want = emit_keys_plain(*args)
    torch.cuda.synchronize()
    assert emit_keys.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("K", [5, 20, 40])
@pytest.mark.parametrize("with_attrs", [False, True])
def test_select_kernel_matches_plain(stage, K, with_attrs):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
    table = fine.candidate_table(points, isig, c.pos_c)
    args = (rays, table, c.bits_c, c.ids_c, c.counts_c, c.thr_act, K,
            c.bin_size, 0.9, colors if with_attrs else None)
    before = fine_select.launches
    got = fine_select(*args)
    want = fine_select_plain(*args)
    torch.cuda.synchronize()
    assert fine_select.launches == before + 1
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
    table = fine.candidate_table(points, isig, c.pos_c)
    idx, _, _, _, w, _ = fine_select_plain(rays, table, c.bits_c, c.ids_c,
                                           c.counts_c, c.thr_act, 20, c.bin_size, 1.0)
    before = attr_merge.launches
    got = attr_merge(idx, w, colors)
    assert attr_merge.launches == before + 1
    torch.testing.assert_close(got, attr_merge_plain(idx, w, colors), rtol=0, atol=1e-5)


def test_wrappers_check_their_inputs(stage):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, 20)
    table = fine.candidate_table(points, isig, c.pos_c)
    with pytest.raises(TypeError):
        fine_select(rays, table, c.bits_c.long(), c.ids_c, c.counts_c,
                    c.thr_act, 20, c.bin_size, 1.0)
    with pytest.raises(ValueError):
        fine_select(rays.cpu(), table, c.bits_c, c.ids_c, c.counts_c,
                    c.thr_act, 20, c.bin_size, 1.0)
    with pytest.raises(ValueError):
        attr_merge(c.ids_c[:, ::2], torch.ones_like(table[:, ::2, 0]), colors)
    sel = fine_select(rays, table, c.bits_c, c.ids_c, c.counts_c, c.thr_act, 20,
                      c.bin_size, 1.0)
    with pytest.raises(ValueError):
        fine_bwd(rays, table, c.ids_c, c.counts_c, *sel[:5], None, None, None,
                 sel[4][..., :3].contiguous(), c.bin_size, 1.0)
    with pytest.raises(ValueError):
        attr_merge_bwd(sel[0], sel[4], colors, torch.ones_like(rays).cpu())


def _close(got, want):
    """max |kernel - plain| <= 1e-4 max |plain|."""
    assert want.abs().max() > 0
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


def _cotangents(shape, dev, n, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(shape, device=dev, generator=gen) for _ in range(n)]


@pytest.mark.parametrize("K", [5, 20, 40])
def test_fold_kernel_matches_plain(stage, K):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
    table = fine.candidate_table(points, isig, c.pos_c)
    _, l, a, d, w, _ = fine_select(rays, table, c.bits_c, c.ids_c, c.counts_c,
                                   c.thr_act, K, c.bin_size, 0.9)
    (gw,) = _cotangents(w.shape, rays.device, 1, K)
    before = fold_weights.launches
    got = fold_weights(l, a, d, w, gw, 0.9)
    want = fold_weights_plain(l, a, d, w, gw, 0.9)
    torch.cuda.synchronize()
    assert fold_weights.launches == before + 1
    for g, x in zip(got, want):
        _close(g, x)


@pytest.mark.parametrize("want_rays", [False, True])
@pytest.mark.parametrize("with_attrs", [False, True])
def test_fine_bwd_kernel_matches_plain(stage, with_attrs, want_rays):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, 20)
    table = fine.candidate_table(points, isig, c.pos_c)
    attrs = colors if with_attrs else None
    sel = fine_select(rays, table, c.bits_c, c.ids_c, c.counts_c, c.thr_act, 20,
                      c.bin_size, 0.9, attrs)
    cots = _cotangents(sel[1].shape, rays.device, 4, 3)
    g_img = _cotangents(rays.shape, rays.device, 1, 4)[0] if with_attrs else None
    args = (rays, table, c.ids_c, c.counts_c, *sel[:5], *cots, c.bin_size, 0.9,
            attrs, g_img, want_rays)
    before = fine_bwd.launches
    got = fine_bwd(*args)
    again = fine_bwd(*args)
    want = fine_bwd_plain(*args)
    torch.cuda.synchronize()
    assert fine_bwd.launches == before + 2
    assert got[0].shape == (table.shape[0], table.shape[1], 15 if with_attrs else 12)
    _close(got[0], want[0])
    assert torch.equal(got[0], again[0])
    if want_rays:
        _close(got[1], want[1])
        assert torch.equal(got[1], again[1])
    else:
        assert got[1] is None and want[1] is None


def test_attr_merge_bwd_kernel_matches_plain(stage):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, 20)
    table = fine.candidate_table(points, isig, c.pos_c)
    idx, _, _, _, w, _ = fine_select(rays, table, c.bits_c, c.ids_c, c.counts_c,
                                     c.thr_act, 20, c.bin_size, 1.0)
    (g,) = _cotangents(rays.shape, rays.device, 1, 5)
    before = attr_merge_bwd.launches
    got = attr_merge_bwd(idx, w, colors, g)
    again = attr_merge_bwd(idx, w, colors, g)
    want = attr_merge_bwd_plain(idx, w, colors, g)
    torch.cuda.synchronize()
    assert attr_merge_bwd.launches == before + 2
    for x, y, z in zip(got, want, again):
        _close(x, y)
        assert torch.equal(x, z)


class _PlainPath:
    """Route a render and its backward through the plain versions."""

    def __enter__(self):
        from voge_tpu_torch.ops import cuda_coarse

        self.saved = [(coarse, "emit_keys", cuda_coarse.emit_keys_plain),
                      (fine, "fine_select", fine_select_plain),
                      (fine, "fine_bwd", fine_bwd_plain),
                      (fine, "fine_select_global", fine_select_global_plain),
                      (fine, "fine_bwd_global", fine_bwd_global_plain),
                      (cuda_attr, "attr_merge", attr_merge_plain),
                      (cuda_attr, "attr_merge_bwd", attr_merge_bwd_plain)]
        self.saved = [(m, n, getattr(m, n), f) for m, n, f in self.saved]
        for m, n, _, f in self.saved:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, f, _ in self.saved:
            setattr(m, n, f)


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

    before = (fine_bwd.launches, attr_merge_bwd.launches)
    k1, k2 = step(), step()
    assert fine_bwd.launches == before[0] + 2 and attr_merge_bwd.launches == before[1] + 2
    with _PlainPath():
        p = step()
    torch.cuda.synchronize()
    for a, b, c in zip(k1, k2, p):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()
        _close(a, c)


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
    before = fine_select_global.launches
    got = fine_select_global(*args)
    want = fine_select_global_plain(*args)
    torch.cuda.synchronize()
    assert fine_select_global.launches == before + 1
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
    before = fine_bwd_global.launches
    got = fine_bwd_global(*b_args)
    again = fine_bwd_global(*b_args)
    want = fine_bwd_global_plain(*b_args)
    torch.cuda.synchronize()
    assert fine_bwd_global.launches == before + 2
    assert got[0].shape == (table.shape[0], 12)
    _close(got[0], want[0])
    assert torch.equal(got[0], again[0])
    if want_rays:
        _close(got[1], want[1])
        assert torch.equal(got[1], again[1])
    else:
        assert got[1] is None and want[1] is None


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

    before = {fn: fn.launches for fn in (fine_select_global, fine_bwd_global, attr_merge,
                                         attr_merge_bwd, emit_keys)}
    lk, pk = run()
    torch.cuda.synchronize()
    for fn, n in before.items():
        assert (fn.launches > n) == (fn is not emit_keys), fn.__name__
    with _PlainPath():
        lp, pp = run()
    for a, b in zip(lk, lp):
        assert abs(a - b) <= 1e-5 * abs(b)
    for k in pk:
        x0 = torch.as_tensor(verts if k == "verts" else np.full_like(verts, 0.5), device=dev)
        moved_k, moved_p = pk[k] - x0, pp[k] - x0
        assert (moved_k - moved_p).norm() <= 1e-4 * moved_p.norm(), k
