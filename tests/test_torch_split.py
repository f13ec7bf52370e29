"""The global backward split in two (``cuda_fine_bwd.fine_bwd_gauss`` /
``fine_bwd_rays``, on the CPU their plain versions) against ``voge_tpu``,
and the rule in ``ops.fine.global_backward`` that says when a backward takes
the pair:

- the plain halves against ``pallas_bwd.fine_bwd_gauss_pallas`` /
  ``fine_bwd_rays_pallas`` in interpret mode, driven as
  ``tests/test_pallas.py`` drives them (B = 2, 20x20, P = 60, K = 5 and 40,
  ``cand_chunk=128``, ``ray_chunk=8``).  Both sides get the same selection
  (``voge_tpu``'s), so no knife-edge tie can flip a slot.  rtol 1e-4 as in
  that test, atol 1e-6 of each tensor's largest entry, and normwise 1e-5:
  the TPU kernels recompute each slot's forms and combine float32 sums with
  mu afterwards, the port reads the saved len / dsd and works around the
  residual, so an entry near zero of a tensor whose entries reach 4e2
  (rounded to 3e-5 each) differs by up to 3e-4 in absolute terms;
- the fold's own entry followed by the pair against the unified entry's
  plain version on the same inputs: normwise 1e-5 (the same arithmetic but
  for where the folded cotangents are rounded);
- the rule (the unified entry whenever the scene needs a gradient, at any
  size, with or without the ray gradient; the fold and the per-ray half for
  a frozen scene): which wrappers ran, and the gradients against
  ``jax.grad`` of ``voge_tpu``'s render (for the frozen scene, of
  ``voge_tpu``'s ``ray_tracing`` in the rays alone), normwise 1e-3 (f32 sums
  in another order, ``torch.erf`` against XLA's erf);
- the global backward without weights: ``w=None`` gives the same result as
  an explicit zero ``w``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import voge_tpu.ops.fine as F
import voge_tpu.renderer as jr
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.converter.converters import naive_vertices_converter
from voge_tpu.converter.shapes import ico_sphere
from voge_tpu.ops.coarse import overlap_mask
from voge_tpu.ops.pallas_bwd import fine_bwd_gauss_pallas, fine_bwd_rays_pallas
from voge_tpu.rays import camera_rays
import voge_tpu_torch as vt
from voge_tpu_torch.ops import cuda_fine_bwd, fine
from voge_tpu_torch.ops.cuda_fine import fine_select_global_plain
from voge_tpu_torch.ops.cuda_fine_bwd import (
    fine_bwd_gauss, fine_bwd_gauss_plain, fine_bwd_global_plain, fine_bwd_rays,
    fine_bwd_rays_plain, fold_weights,
)

torch.set_num_threads(2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(want) > 0
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("K", [5, 40])
def test_plain_halves_match_pallas_pair(K):
    rng = np.random.RandomState(5)
    B, H, W, P, bs, P_pad = 2, 20, 20, 60, 10, 128
    mus_w = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32) * 0.8
    a = rng.uniform(-1, 1, size=(P, 3, 3)).astype(np.float32)
    isig = np.einsum("pij,pkj->pik", a, a) + 2 * np.eye(3, dtype=np.float32)
    R_, T_ = look_at_view_transform(dist=[4.0, 4.5], elev=[5.0, 20.0], azim=[10.0, 40.0])
    focal = jnp.broadcast_to(jnp.asarray([[30.0, 30.0]]), (B, 2))
    principal = jnp.broadcast_to(jnp.asarray([[10.0, 10.0]]), (B, 2))
    rays, origins = camera_rays(R_, T_, focal, principal, (H, W))
    mus = jnp.asarray(mus_w)[None] - origins[:, None, :]
    isig_b = jnp.broadcast_to(jnp.asarray(isig)[None], (B, P, 3, 3))
    mask = overlap_mask(R_, T_, focal, principal, mus, isig_b, (H, W), 0.01, bs)
    thr_act = -math.log(0.01 + 1e-10)
    base_ids = (jnp.arange(P, dtype=jnp.int32)[None, :]
                + (jnp.arange(B, dtype=jnp.int32) * P)[:, None])
    sel = F._fine_forward_mask(mus, isig_b, rays, mask, base_ids, thr_act, (bs, bs), K)
    cot = [rng.rand(B, H, W, K).astype(np.float32) for _ in range(3)]

    _, BH, BW, _ = mask.shape
    gf = jnp.pad(F._gauss_feature_planes_batched(mus, isig_b),
                 ((0, 0), (0, 0), (0, P_pad - P)))
    mf = jnp.pad(mask.reshape(B * BH * BW, P).astype(jnp.int8),
                 ((0, 0), (0, P_pad - P)))[:, None, :]
    rays_feat, _, R_pad = F._rays_features(rays, BH, BW, bs, bs)
    binned = lambda x, fill: F._bin_hwk(jnp.asarray(x), BH, BW, bs, bs, H, W, R_pad, fill)
    args = (binned(sel[0], -1),) + tuple(binned(c, 0.0) for c in cot)
    ids_p = np.full((B, 1, P_pad), -1, np.int32)
    ids_p[:, 0, :P] = np.asarray(base_ids)
    kw = dict(thr_act=thr_act, K=K, bh_bw=BH * BW, n_gauss=P, ray_chunk=8,
              cand_chunk=128, interpret=True)
    gg = np.asarray(fine_bwd_gauss_pallas(rays_feat, gf, mf, jnp.asarray(ids_p), *args, **kw))
    rb = fine_bwd_rays_pallas(rays_feat, gf, mf, jnp.asarray(ids_p), *args, **kw)
    gr_want = np.asarray(F._unbin(rb[:, :bs * bs, 0:3], B, BH, BW, H, W, bs, bs))
    rows_want = np.swapaxes(gg, 1, 2)[:, :P, :12].reshape(B * P, 12)

    t = lambda x: torch.tensor(np.array(x))
    table = fine.feature_table(t(mus), t(isig_b))
    idx, length, _, dsd = (t(x) for x in sel)
    assert (idx >= 0).any() and (K == 5 or (idx < 0).any())   # K = 40: empty slots too
    halves = (t(rays), table, idx, length, dsd, *(t(c) for c in cot))
    rows = fine_bwd_gauss_plain(*halves)
    g_rays = fine_bwd_rays_plain(*halves)
    assert rows.shape == (B * P, 12) and g_rays.shape == (B, H, W, 3)
    for got, want in ((rows.numpy()[:, 0:3], rows_want[:, 0:3]),
                      (rows.numpy()[:, 3:12], rows_want[:, 3:12]), (g_rays.numpy(), gr_want)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())
        assert _rel(got, want) <= 1e-5
    # on CPU tensors the wrappers are their plain versions, and count nothing
    before = (fine_bwd_gauss.launches, fine_bwd_rays.launches)
    assert torch.equal(fine_bwd_gauss(*halves), rows)
    assert torch.equal(fine_bwd_rays(*halves), g_rays)
    assert (fine_bwd_gauss.launches, fine_bwd_rays.launches) == before


def _global_scene(K, seed=11):
    """Two images of 16x24 rays over 150 Gaussians each, selected by the
    plain global select (``tests/test_torch_global.py``'s scene)."""
    rng = np.random.RandomState(seed)
    B, H, W, P = 2, 16, 24, 150
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.zeros((B, H, W, 3), np.float32)
    for b in range(B):
        d = np.stack([(xx - W / 2 + 0.5) / 20.0, (yy - H / 2 + 0.5) / 20.0,
                      np.ones_like(xx, dtype=np.float64)], -1) + 0.02 * b
        rays[b] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    mus = np.concatenate([rng.uniform(-0.6, 0.6, (B, P, 2)),
                          rng.uniform(2.0, 4.0, (B, P, 1))], -1).astype(np.float32)
    a = rng.uniform(-1, 1, size=(B, P, 3, 3)).astype(np.float32)
    lam = ((np.einsum("bmij,bmkj->bmik", a, a) + 2 * np.eye(3, dtype=np.float32)) * 30.0)
    table = fine.feature_table(torch.tensor(mus), torch.tensor(lam.astype(np.float32)))
    sel = fine_select_global_plain(torch.tensor(rays), table, None,
                                   -math.log(0.01 + 1e-10), K, 4, 0.9)
    cots = [torch.tensor(rng.normal(size=(B, H, W, K)).astype(np.float32)) for _ in range(4)]
    return torch.tensor(rays), table, sel, cots


@pytest.mark.parametrize("which", ["all", "only_g_w", "no_g_w"])
def test_fold_then_pair_matches_unified_plain(which):
    rays, table, sel, cots = _global_scene(K=8)
    idx, length, act, dsd, w = sel
    g_len, g_act, g_dsd, g_w = cots
    if which == "only_g_w":
        g_len = g_act = g_dsd = None
    if which == "no_g_w":
        g_w = None
    want_rows, want_rays = fine_bwd_global_plain(rays, table, *sel, g_len, g_act, g_dsd,
                                                 g_w, 0.9)
    got_rows, got_rays = fine.global_backward(rays, table, *sel, g_len, g_act, g_dsd, g_w,
                                              0.9, want_scene=True, want_rays=True)
    assert torch.equal(got_rows, want_rows) and torch.equal(got_rays, want_rays)  # unified
    gl, ga, gd = g_len, g_act, g_dsd
    if g_w is not None:
        folded = fold_weights(length, act, dsd, w, g_w, 0.9)
        gl, ga, gd = (d if g is None else g + d for g, d in zip((gl, ga, gd), folded))
    halves = (rays, table, idx, length, dsd, gl, ga, gd)
    rows, g_rays = fine_bwd_gauss(*halves), fine_bwd_rays(*halves)
    assert _rel(rows.numpy(), want_rows.numpy()) <= 1e-5
    assert _rel(g_rays.numpy(), want_rays.numpy()) <= 1e-5
    # slots that name no row of the table contribute nothing
    far = torch.where(idx >= 0, idx + table.shape[0], idx)
    assert not fine_bwd_gauss(rays, table, far, length, dsd, gl, ga, gd).any()
    assert not fine_bwd_rays(rays, table, far, length, dsd, gl, ga, gd).any()


def test_split_wrappers_check_their_arguments():
    rays, table, sel, cots = _global_scene(K=8)
    idx, length, _, dsd, _ = sel
    with pytest.raises(TypeError):
        fine_bwd_gauss(rays, table, idx.long(), length, dsd, *cots[:3])
    with pytest.raises(ValueError):
        fine_bwd_rays(rays, table, idx, length[..., :4], dsd, *cots[:3])
    with pytest.raises(ValueError):
        fine_bwd_gauss(rays, table[:, :12], idx, length, dsd, *cots[:3])


# ---- the rule, end to end ----------------------------------------------

B, HW, K_RENDER = 2, (32, 32), 8


def _render_scene():
    v, f = ico_sphere(2)
    verts, isig, _ = naive_vertices_converter(v, f, percentage=0.5)
    colors = np.random.RandomState(0).uniform(0, 1, (verts.shape[0], 3)).astype(np.float32)
    R, T = look_at_view_transform(dist=[2.7, 3.0], elev=[-10.0, 20.0], azim=[-40.0, 30.0])
    focal = np.full((B, 2), 31.5, np.float32)
    principal = np.full((B, 2), 16.0, np.float32)
    return (verts, isig, colors, np.array(R, np.float32), np.array(T, np.float32),
            focal, principal)


def _loss_j(verts, isig, colors, R, T, focal, principal):
    f = jr.render_pipeline(verts, isig, R, T, jnp.asarray(focal), jnp.asarray(principal),
                           image_size=HW, max_assign=K_RENDER, max_point_per_bin=-1)
    return (jnp.mean(jr.get_silhouette(f) ** 2)
            + jnp.mean((jr.interpolate_attr(f, colors) - 0.5) ** 2))


def _loss_t(verts, isig, colors, R, T, focal, principal):
    f = vt.render_pipeline(verts, isig, R, T, torch.tensor(focal), torch.tensor(principal),
                           image_size=HW, max_assign=K_RENDER, max_point_per_bin=-1)
    return ((vt.get_silhouette(f) ** 2).mean()
            + ((vt.interpolate_attr(f, colors) - 0.5) ** 2).mean())


@pytest.fixture(scope="module")
def jax_grads():
    verts, isig, colors, R, T, focal, principal = _render_scene()
    return jax.grad(_loss_j, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in (verts, isig, colors, R, T)), focal, principal)


class _Calls(dict):
    """Calls per wrapper; ``rays_asked``: each unified call's ``want_rays``."""


@pytest.fixture
def spy(monkeypatch):
    """Count the calls of the three backward wrappers ``ops.fine`` dispatches
    to (on the CPU they run their plain versions, which count no launch),
    and record whether each call of the unified entry asked for rays."""
    calls = _Calls()
    calls.rays_asked = []
    for name in ("fine_bwd", "fine_bwd_rays", "fine_bwd_global"):
        real = getattr(cuda_fine_bwd, name)
        calls[name] = 0

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            if _name == "fine_bwd_global":
                calls.rays_asked.append(a[-1])
            return _real(*a, **k)
        monkeypatch.setattr(fine, name, counted)
    return calls


@pytest.mark.parametrize("branch", ["scene_and_cameras", "scene_only"])
def test_global_backward_rule_matches_jax_grad(branch, jax_grads, spy):
    """The unified entry at any size, asked for the ray gradient only when
    the cameras need one; the gradients against ``jax.grad``."""
    verts, isig, colors, R, T, focal, principal = _render_scene()
    cams = branch == "scene_and_cameras"
    args = [torch.tensor(x, requires_grad=True) for x in (verts, isig, colors)]
    args += [torch.tensor(x, requires_grad=cams) for x in (R, T)]
    _loss_t(*args, focal, principal).backward()
    assert spy == dict(fine_bwd=0, fine_bwd_rays=0, fine_bwd_global=1)
    assert spy.rays_asked == [cams]
    for name, a, g in zip(("verts", "sigmas", "colors", "R", "T"), args, jax_grads):
        if not a.requires_grad:
            assert a.grad is None
            continue
        assert a.grad.shape == a.shape and torch.isfinite(a.grad).all(), name
        assert _rel(a.grad.numpy(), g) <= 1e-3, (branch, name, _rel(a.grad.numpy(), g))


def test_frozen_scene_takes_the_ray_half_alone(spy):
    """Only the rays need a gradient (``ray_tracing`` on constant points):
    the per-ray half alone, the fold fused in, no per-Gaussian pass; the ray
    gradient against ``jax.grad`` of ``voge_tpu``'s ``ray_tracing`` on the
    same arrays."""
    from voge_tpu_torch.aggregation import expend_sigma
    from voge_tpu_torch.rays import camera_rays as t_camera_rays

    verts, isig, _, R, T, focal, principal = _render_scene()
    cams = tuple(torch.tensor(x) for x in (R, T, focal, principal))
    rays, origins = t_camera_rays(*cams, HW)
    points = torch.tensor(verts)[None] - origins[:, None, :]
    isg = (2.0 * expend_sigma(torch.tensor(isig)))[None].expand(B, -1, 3, 3).contiguous()
    cw = np.random.RandomState(2).normal(size=(B,) + HW + (K_RENDER,)).astype(np.float32)

    def loss_j(r):
        sel = F.ray_tracing(tuple(jnp.asarray(x.numpy()) for x in cams),
                            jnp.asarray(points.numpy()), jnp.asarray(isg.numpy()), r, HW, 0.01,
                            K_RENDER, max_points_per_bin=-1, agg_ow=1.0)
        return jnp.sum(sel[4] * cw)

    want = jax.grad(loss_j)(jnp.asarray(rays.numpy()))
    r = rays.clone().requires_grad_(True)
    sel, _ = fine.ray_tracing(cams, points, isg, r, HW, 0.01, K_RENDER, max_points_per_bin=-1)
    (sel[4] * torch.tensor(cw)).sum().backward()
    assert spy == dict(fine_bwd=0, fine_bwd_rays=1, fine_bwd_global=0)
    assert _rel(r.grad.numpy(), want) <= 1e-3


def test_split_backward_repeats_to_the_bit_and_skips_unasked_rays(spy):
    """The global backward (the unified entry, which replaced the split pair
    on every scene) repeats to the bit, and with constant cameras never asks
    for the ray gradient."""
    verts, isig, colors, R, T, focal, principal = _render_scene()
    args = [torch.tensor(x, requires_grad=True) for x in (verts, isig, colors)]
    loss = _loss_t(*args, torch.tensor(R), torch.tensor(T), focal, principal)
    g1 = torch.autograd.grad(loss, args, retain_graph=True)
    g2 = torch.autograd.grad(loss, args)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert spy == dict(fine_bwd=0, fine_bwd_rays=0, fine_bwd_global=2)
    assert spy.rays_asked == [False, False]


def test_two_stage_tracer_takes_the_rule(spy):
    """``ray_tracing_fine``'s backward goes through the same rule: the
    unified entry (no weights there, so no fold) when the scene needs a
    gradient, equal to the fold-free pair of halves on the same cotangents,
    and the per-ray half alone when only the rays need one."""
    rays, table, sel, cots = _global_scene(K=8)
    P = table.shape[0]
    mus = table[:, 13:16].clone()
    lam = table[:, 4:13].reshape(P, 3, 3).clone()
    lists = torch.arange(P, dtype=torch.int32).reshape(2, 1, 1, P // 2).expand(2, 2, 3, P // 2)

    def grads(scene_grad):
        leaves = [mus.clone().requires_grad_(scene_grad), lam.clone().requires_grad_(scene_grad),
                  rays.clone().requires_grad_(True)]
        out = vt.ops.ray_tracing_fine(*leaves, lists.contiguous(), 0.01, 8, 8)
        loss = sum((torch.where(out[0] >= 0, x, torch.zeros_like(x)) * c).sum()
                   for x, c in zip(out[1:], cots))
        return torch.autograd.grad(loss, [x for x in leaves if x.requires_grad])

    want = grads(True)
    assert spy == dict(fine_bwd=0, fine_bwd_rays=0, fine_bwd_global=1)
    # the pair of halves on the tracer's own cotangents gives the same rows
    idx, length, _, dsd, _ = sel
    pair = (fine_bwd_gauss(rays, table, idx, length, dsd, *cots[:3]),
            fine_bwd_rays(rays, table, idx, length, dsd, *cots[:3]))
    unified = fine_bwd_global_plain(rays, table, *sel[:4], None, *cots[:3], None, 1.0)
    for a, b in zip(pair, unified):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5
    only_rays, = grads(False)
    assert spy == dict(fine_bwd=0, fine_bwd_rays=1, fine_bwd_global=1)
    assert _rel(only_rays.numpy(), want[2].numpy()) <= 1e-5


@pytest.mark.parametrize("want_rays", [False, True])
def test_global_backward_without_weights_needs_no_zero_w(want_rays):
    """The two-stage tracer's backward has no weights: ``w=None`` (no fold)
    gives the same result as an explicit zero ``w`` (a fold of G = 0)."""
    rays, table, sel, cots = _global_scene(K=8)
    idx, length, act, dsd, _ = sel
    args = (rays, table, idx, length, act, dsd)
    none = fine.global_backward(*args, None, *cots[:3], None, 1.0, True, want_rays)
    zero = fine.global_backward(*args, torch.zeros_like(length), *cots[:3],
                                torch.zeros_like(length), 1.0, True, want_rays)
    assert (none[1] is None) == (not want_rays)
    for a, b in zip(none, zero):
        assert (a is None and b is None) or torch.equal(a, b)
