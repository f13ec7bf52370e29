"""The backward of a frozen scene on the emission-compacted path, and the
rule that picks the per-Gaussian kernel's lanes (``ops/cuda_fine_bwd.py``),
on the CPU (the wrappers run their plain versions):

- ``FineSelect``'s rule, read with spies on the wrappers ``ops.fine`` calls:
  a scene that needs no gradient (pose refinement: the camera centres are
  handed to ``ray_tracing`` apart) takes the per-ray half alone; attributes
  or means that need a gradient take K3 whole; nothing wanted calls nothing;
- the frozen route's gradients of the rays and the camera centres equal the
  full backward's to the bit (one arithmetic, one summation order), and the
  camera gradient equals ``jax.grad`` of ``voge_tpu``'s render, normwise
  1e-3 (as every gradient of a render in ``tests/test_torch_pose.py``);
  three refinement steps on either route give the same bits;
- the per-ray half with the fold fused in equals the fold followed by the
  unfused half, to the bit, and its per-ray mean gradients sum to the
  per-Gaussian rows' (relative 1e-5: the same terms in another order);
- ``group_width`` as a pure function of the shapes: 4 at the 300,000-point
  cloud, 32 at every shape that has a golden file;
- the per-ray and per-Gaussian halves refuse K above ``MAX_K`` on CUDA
  tensors (the per-slot kernel's limit); the plain version takes any K.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import voge_tpu.renderer as jr
from voge_tpu.converter import Cuboid
import voge_tpu_torch as vt
from voge_tpu_torch.aggregation import expend_sigma
from voge_tpu_torch.models import pose as tpose
from voge_tpu_torch.ops import cuda_fine_bwd, fine
from voge_tpu_torch.ops.cuda_fine import MAX_K, fine_select_global_plain
from voge_tpu_torch.ops.cuda_fine_bwd import (
    fine_bwd, fine_bwd_gauss, fine_bwd_rays, fine_bwd_rays_plain, fold_weights,
    group_width,
)
from voge_tpu_torch.rays import camera_rays

torch.set_num_threads(2)

B, HW, K = 2, (48, 48), 10
_KW = dict(image_size=HW, max_assign=K, max_point_per_bin=1000)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(want) > 0
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def scene():
    g = Cuboid.cuboid_gauss((-1, 1), (-0.5, 0.5), (-0.8, 0.8), 300, percentage=0.6,
                            as_obj=True)
    verts, sigmas = np.asarray(g.verts, np.float32), np.asarray(g.sigmas, np.float32)
    colors = ((verts + 1) / 2.5).astype(np.float32)
    R, T = tpose.pose_matrices(np.full(B, 4.0, np.float32), np.array([0.3, 0.1], np.float32),
                               np.array([0.9, 0.4], np.float32), np.array([0.1, 0.0], np.float32),
                               device="cpu")
    focal = np.full((B, 2), 60.0, np.float32)
    principal = np.full((B, 2), 24.0, np.float32)
    return verts, sigmas, colors, R.numpy(), T.numpy(), focal, principal


@pytest.fixture
def spy(monkeypatch):
    """Calls of the wrappers ``ops.fine`` dispatches to, and of the grouping
    K3's per-Gaussian pass takes."""
    calls = {}
    for mod, name in ((fine, "fine_bwd"), (fine, "fine_bwd_rays"), (fine, "fine_bwd_global"),
                      (cuda_fine_bwd, "slot_runs")):
        real = getattr(mod, name)
        calls[name] = 0

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


def _loss_t(frag):
    return ((frag.attr_img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()


def _camera_grads(scene, verts_grad, attrs_grad=False):
    verts, sigmas, colors, R, T, focal, principal = scene
    v = torch.tensor(verts, requires_grad=verts_grad)
    c = torch.tensor(colors, requires_grad=attrs_grad)
    Rl, Tl = torch.tensor(R, requires_grad=True), torch.tensor(T, requires_grad=True)
    frag = vt.render_pipeline(v, torch.tensor(sigmas), Rl, Tl, torch.tensor(focal),
                              torch.tensor(principal), attrs=c, **_KW)
    assert int(frag.overflow_points) == 0
    leaves = [Rl, Tl] + ([v] if verts_grad else []) + ([c] if attrs_grad else [])
    return torch.autograd.grad(_loss_t(frag), leaves)


def test_frozen_scene_takes_the_ray_half_alone(scene, spy):
    """Constant verts, sigmas and colours, cameras that need a gradient: the
    per-ray half (the fold and the colours' d_w fused in), no K3, no
    grouping; the camera gradients equal the full backward's to the bit."""
    frozen = _camera_grads(scene, verts_grad=False)
    assert spy == dict(fine_bwd=0, fine_bwd_rays=1, fine_bwd_global=0, slot_runs=0)
    full = _camera_grads(scene, verts_grad=True)
    assert spy["fine_bwd"] == 1 and spy["fine_bwd_rays"] == 1
    for a, b in zip(frozen, full[:2]):
        assert torch.isfinite(a).all() and a.abs().sum() > 0
        assert torch.equal(a, b)


def test_frozen_camera_gradient_matches_jax_grad(scene):
    verts, sigmas, colors, R, T, focal, principal = scene

    def loss_j(R, T):
        f = jr.render_pipeline(jnp.asarray(verts), jnp.asarray(sigmas), R, T,
                               jnp.asarray(focal), jnp.asarray(principal),
                               attrs=jnp.asarray(colors), **_KW)
        return jnp.mean((f.attr_img - 0.5) ** 2) + jnp.mean(jr.get_silhouette(f) ** 2)

    want = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(R), jnp.asarray(T))
    got = _camera_grads(scene, verts_grad=False)
    for name, a, b in zip(("R", "T"), got, want):
        assert _rel(a.numpy(), b) <= 1e-3, (name, _rel(a.numpy(), b))


def test_attrs_that_need_a_gradient_take_the_per_gaussian_pass(scene, spy):
    """Constant verts, colours that need a gradient: K3 whole (its rows hold
    the colours' gradient), and the cameras' gradients as on the frozen
    route, to the bit."""
    grads = _camera_grads(scene, verts_grad=False, attrs_grad=True)
    assert spy["fine_bwd"] == 1 and spy["fine_bwd_rays"] == 0
    assert grads[2].abs().sum() > 0
    frozen = _camera_grads(scene, verts_grad=False)
    assert all(torch.equal(a, b) for a, b in zip(grads[:2], frozen))


def test_nothing_wanted_calls_nothing(scene, spy):
    """Constant points, rays that need a gradient but ``camera_grad=False``
    and no camera centres: the backward asks for nothing and calls no
    wrapper."""
    verts, sigmas, _, R, T, focal, principal = scene
    cams = tuple(torch.tensor(x) for x in (R, T, focal, principal))
    rays, origins = camera_rays(*cams, HW)
    points = (torch.tensor(verts)[None] - origins[:, None, :]).contiguous()
    isg = (2.0 * expend_sigma(torch.tensor(sigmas)))[None].expand(B, -1, 3, 3)
    r = rays.clone().requires_grad_(True)
    sel, _ = fine.ray_tracing(cams, points, isg.contiguous(), r, HW, 0.01, K,
                              max_points_per_bin=1000, camera_grad=False)
    sel[4].sum().backward()
    assert r.grad is None
    assert spy == dict(fine_bwd=0, fine_bwd_rays=0, fine_bwd_global=0, slot_runs=0)


def test_pose_refinement_routes_give_the_same_bits(scene, spy):
    """Three ``refine_pose`` steps with the scene frozen (the per-ray half
    alone) and with its verts made to need a gradient (K3 whole, the verts'
    gradient unused): the same parameters and similarity, to the bit."""
    verts, sigmas, colors, R, T, focal, principal = scene
    target = torch.rand((1,) + HW + (3,), generator=torch.Generator().manual_seed(0))
    kw = dict(image_size=HW, max_assign=K, chunk=2, device="cpu")
    frozen = vt.PoseHypothesisScorer(verts, sigmas, colors, 60.0, (24.0, 24.0), **kw)
    init = (4.0, 0.25, 0.8, 0.05)
    p1, s1 = vt.refine_pose(frozen, target, init, steps=3, lr=0.01)
    assert spy["fine_bwd"] == 0 and spy["fine_bwd_rays"] == 3
    full = vt.PoseHypothesisScorer(verts, sigmas, colors, 60.0, (24.0, 24.0), **kw)
    full.verts.requires_grad_(True)
    p2, s2 = vt.refine_pose(full, target, init, steps=3, lr=0.01)
    assert spy["fine_bwd"] == 3 and spy["fine_bwd_rays"] == 3
    assert s1 == s2 and all(torch.equal(p1[k], p2[k]) for k in p1)
    assert max(abs(p1[k].item() - v) for k, v in zip(("dist", "elev", "azim", "theta"),
                                                     init)) > 0.01


def _global_scene(K, seed=11):
    """Two images of 16x24 rays over 150 Gaussians each, selected by the
    plain global select, with seeded cotangents."""
    rng = np.random.RandomState(seed)
    H, W, P = 16, 24, 150
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.zeros((B, H, W, 3), np.float32)
    for b in range(B):
        d = np.stack([(xx - W / 2 + 0.5) / 20.0, (yy - H / 2 + 0.5) / 20.0,
                      np.ones_like(xx, dtype=np.float64)], -1) + 0.02 * b
        rays[b] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    mus = np.concatenate([rng.uniform(-0.6, 0.6, (B, P, 2)),
                          rng.uniform(2.0, 4.0, (B, P, 1))], -1).astype(np.float32)
    a = rng.uniform(-1, 1, size=(B, P, 3, 3)).astype(np.float32)
    lam = (np.einsum("bmij,bmkj->bmik", a, a) + 2 * np.eye(3, dtype=np.float32)) * 30.0
    table = fine.feature_table(torch.tensor(mus), torch.tensor(lam.astype(np.float32)))
    sel = fine_select_global_plain(torch.tensor(rays), table, None,
                                   -math.log(0.01 + 1e-10), K, 4, 0.9)
    cots = [torch.tensor(rng.normal(size=(B, H, W, K)).astype(np.float32)) for _ in range(4)]
    return torch.tensor(rays), table, sel, cots


@pytest.mark.parametrize("which", ["all", "only_g_w"])
def test_fused_fold_equals_fold_then_ray_half(which):
    """``global_backward`` for a frozen scene (one per-ray pass, the fold
    fused in) against the fold's own entry, the adds and the unfused per-ray
    half: equal to the bit."""
    rays, table, sel, cots = _global_scene(K=8)
    idx, length, act, dsd, w = sel
    if which == "only_g_w":
        cots[:3] = [None] * 3
    none, got = fine.global_backward(rays, table, *sel, *cots, 0.9, want_scene=False,
                                     want_rays=True)
    folded = fold_weights(length, act, dsd, w, cots[3], 0.9)
    g3 = [d if g is None else g + d for g, d in zip(cots[:3], folded)]
    want = fine_bwd_rays(rays, table, idx, length, dsd, *g3)
    assert none is None and torch.equal(got, want)


def test_ray_half_mean_sums_match_the_rows():
    """The per-ray half's mean gradients (``return_mu``) equal K3's to the
    bit, and summed over each image they are the per-Gaussian rows' mean
    gradients summed (relative 1e-5)."""
    rays, table, sel, cots = _global_scene(K=8)
    idx, length, act, dsd, w = sel
    attrs = torch.rand(table.shape[0], 3, generator=torch.Generator().manual_seed(1))
    g_img = torch.randn(rays.shape, generator=torch.Generator().manual_seed(2))
    rows, g_rays, g_mu = fine_bwd(rays, table, *sel, *cots, 0.9, attrs, g_img, True,
                                  return_mu=True)
    r2, m2 = fine_bwd_rays(rays, table, idx, length, dsd, *cots[:3], act=act, w=w,
                           g_w=cots[3], agg_ow=0.9, attrs=attrs, g_img=g_img, return_mu=True)
    assert torch.equal(g_rays, r2) and torch.equal(g_mu, m2)
    per_image = rows[:, 0:3].reshape(B, -1, 3).sum(1)
    assert _rel(g_mu.reshape(B, -1, 3).sum(1).numpy(), per_image.numpy()) <= 1e-5


_SHAPES = {  # name: (rays x K, rows of the feature table, lanes)
    "cloud_300k": (320 * 320 * 20, 300_000, 4),
    "headline": (256 * 256 * 20, 9602, 32),
    "golden_1k_128": (128 * 128 * 20, 866, 32),
    "quickstart": (256 * 256 * 20, 866, 32),
    "shapefitting": (5 * 128 * 128 * 25, 5 * 2562, 32),
    "pose_b8": (8 * 256 * 256 * 20, 8 * 9602, 32),
    "two_stage": (256 * 256 * 20, 9602, 32),
}


@pytest.mark.parametrize("name", sorted(_SHAPES))
def test_group_width_rule(name):
    n_slots, n_tab, want = _SHAPES[name]
    assert group_width(n_slots, n_tab) == want


def test_group_width_is_a_power_of_two_in_range():
    seen = set()
    for n_slots in (1, 7, 100, 4096, 10 ** 6):
        for n_tab in (1, 9, 300, 40_000, 10 ** 5):
            g = group_width(n_slots, n_tab)
            assert g in (4, 8, 16, 32) and 2 * g >= min(64, n_slots / n_tab)
            seen.add(g)
    assert seen == {4, 8, 16, 32}


def test_halves_refuse_k_above_max_on_the_card(monkeypatch):
    """On CUDA tensors (the device test stood in for) the per-ray and the
    per-Gaussian halves raise above ``MAX_K`` before any launch; the plain
    version takes any K."""
    rays, table, sel, _ = _global_scene(K=8)
    pad = lambda x, fill: torch.cat(
        [x, torch.full(x.shape[:3] + (MAX_K + 1 - 8,), fill, dtype=x.dtype)], -1)
    idx, length, dsd = pad(sel[0], -1), pad(sel[1], 1e10), pad(sel[3], 0.0)
    cots = [torch.randn(idx.shape, generator=torch.Generator().manual_seed(q))
            for q in range(3)]
    args = (rays, table, idx, length, dsd, *cots)
    want = fine_bwd_rays_plain(*args)
    assert want.shape == rays.shape and torch.isfinite(want).all()
    monkeypatch.setattr(cuda_fine_bwd, "on_cuda", lambda *t: True)
    for fn in (fine_bwd_rays, fine_bwd_gauss):
        with pytest.raises(NotImplementedError, match="MAX_K = 128; larger K takes the dense route"):
            fn(*args)
