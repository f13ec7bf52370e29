"""The sampler of the port (``voge_tpu_torch.sampler``) against
``voge_tpu.sampler`` on the CPU, where the port's kernels run their plain
versions.

- ``sample_features`` values against ``voge_tpu``'s segment-sum form (1e-5)
  and against its fused sampler (``_sample_features_fused``, whose forward is
  the Pallas ``_bwd_attr_kernel`` / ``_bwd_unified_kernel`` and whose backward
  the ``_bwd_w_kernel``) in interpret mode, in both of its modes, built as
  ``tests/test_sampler.py`` builds them;
- gradients in (weights, image) against ``jax.grad`` with random cotangents
  for both outputs (1e-4), ``torch.autograd.gradcheck`` in float64, and two
  backward runs equal to the bit;
- ``n_vert`` given, derived, and larger than the scene; an empty pixel; a
  Gaussian no pixel holds; the dtype promotion; ``scatter_max_weight``;
- the texture chain (render at K = 12 -> sample -> normalise -> re-render)
  at a small size against ``voge_tpu``: selections equal but for knife-edge
  pixels (< 0.1%), texture and image to 1e-4, ``overflow_points == 0``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import voge_tpu.renderer as jrend
import voge_tpu.sampler as jsamp
import voge_tpu_torch as vt
from voge_tpu_torch.sampler import SampleFeatures

torch.set_num_threads(2)

t = torch.as_tensor


def _frag_arrays(seed=0, B=2, H=5, W=6, K=4, N=20):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, N, size=(B, H, W, K)).astype(np.int32)
    w = rng.uniform(0, 1, size=(B, H, W, K)).astype(np.float32)
    idx[0, 0, 0] = -1                       # an empty pixel
    idx[idx == 7] = 3                       # Gaussian 7 is held by no pixel
    return idx, w, rng


def _frags(idx, w):
    valid = (idx >= 0).sum(-1)
    fj = jrend.Fragments(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(w))
    ft = vt.Fragments(t(w), t(idx), t(valid), t(w))
    return fj, ft


@pytest.mark.parametrize("n_vert", [20, None, 50])
def test_sample_features_matches_voge_tpu(n_vert):
    idx, w, rng = _frag_arrays()
    image = rng.uniform(0, 1, size=idx.shape[:3] + (3,)).astype(np.float32)
    fj, ft = _frags(idx, w)
    feat_j, sw_j = jsamp.sample_features(fj, jnp.asarray(image), n_vert=n_vert)
    feat, sw = vt.sample_features(ft, t(image), n_vert=n_vert)
    n = int(idx.max()) + 1 if n_vert is None else n_vert
    assert feat.shape == (n, 3) and sw.shape == (n,)
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sw.numpy(), np.asarray(sw_j), rtol=1e-5, atol=1e-5)
    assert sw[7] == 0 and not feat[7].any()         # held by no pixel
    if n_vert == 50:
        assert not feat[20:].any() and not sw[20:].any()
    # fewer rows than ids: the ids beyond are dropped, as segment_sum drops them
    feat_s, sw_s = vt.sample_features(ft, t(image), n_vert=12)
    np.testing.assert_allclose(feat_s.numpy(), np.asarray(feat_j)[:12], rtol=1e-5, atol=1e-5)


def test_sample_features_gradients_match_jax_grad():
    idx, w, rng = _frag_arrays(seed=1, B=1, H=4, W=5, K=3, N=8)
    N = 8
    image = rng.uniform(0, 1, size=idx.shape[:3] + (3,)).astype(np.float32)
    cf = rng.uniform(-1, 1, size=(N, 3)).astype(np.float32)
    cw = rng.uniform(-1, 1, size=(N,)).astype(np.float32)
    fj, ft = _frags(idx, w)

    def jloss(img, wj):
        f2 = jrend.Fragments(wj, fj.vert_index, fj.valid_num, fj.vert_hit_length)
        feat, sw = jsamp.sample_features(f2, img, n_vert=N)
        return jnp.sum(feat * cf) + jnp.sum(sw * cw)

    g_img_j, g_w_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(image), jnp.asarray(w))
    img_t = t(image).clone().requires_grad_(True)
    ft.vert_weight = t(w).clone().requires_grad_(True)
    feat, sw = vt.sample_features(ft, img_t, n_vert=N)
    loss = (feat * t(cf)).sum() + (sw * t(cw)).sum()
    g1 = torch.autograd.grad(loss, (img_t, ft.vert_weight), retain_graph=True)
    g2 = torch.autograd.grad(loss, (img_t, ft.vert_weight))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    np.testing.assert_allclose(g1[0].numpy(), np.asarray(g_img_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g1[1].numpy(), np.asarray(g_w_j), rtol=1e-4, atol=1e-4)
    assert not g1[1][t(idx) < 0].any()              # empty slots get no gradient


def test_sample_features_gradcheck_float64():
    idx, w, rng = _frag_arrays(seed=2, B=1, H=2, W=3, K=3, N=5)
    image = rng.uniform(0, 1, size=idx.shape[:3] + (2,))
    w64 = t(w.astype(np.float64)).requires_grad_(True)
    img64 = t(image).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: SampleFeatures.apply(a, b, t(idx), 5), (w64, img64), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode,sort", [("g", True), ("c", True), ("c", False), ("g", False)])
def test_sample_features_matches_the_fused_pallas_sampler(mode, sort):
    """Values and gradients against ``_sample_features_fused(...,
    interpret=True)`` on selections of a rendered scene, in the global and
    the compacted mode, with and without the candidate sort."""
    from test_sampler import _ctx_scene, _mk_frag_c, _mk_frag_g

    rng = np.random.RandomState(31)
    sel_k, w_k, mask_k, ids_p, pts, isg, gc = _ctx_scene(rng, sort=sort)
    if mode == "g":
        frag, sel_img, w_img = _mk_frag_g(sel_k, w_k, mask_k, ids_p, gc)
    else:
        frag, sel_img, w_img = _mk_frag_c(sel_k, w_k, mask_k, ids_p, pts, isg, gc)
    B, H, W = gc["B"], gc["H"], gc["W"]
    n_vert, C = B * gc["P"], 3
    image = rng.uniform(0, 1, size=(B, H, W, C)).astype(np.float32)
    cf = rng.uniform(-1, 1, size=(n_vert, C)).astype(np.float32)
    cw = rng.uniform(-1, 1, size=(n_vert,)).astype(np.float32)

    def loss_fused(wk, img):
        fr = jrend.Fragments(vert_weight=frag.vert_weight, vert_index=frag.vert_index,
                             valid_num=frag.valid_num, vert_hit_length=frag.vert_hit_length,
                             attr_ctx=(frag.attr_ctx[0], wk) + frag.attr_ctx[2:],
                             attr_geom=frag.attr_geom)
        f, s = jsamp._sample_features_fused(fr, img, n_vert, interpret=True)
        return jnp.sum(f * cf) + jnp.sum(s * cw), (f, s)

    (_, (feat_j, sw_j)), (g_wk, g_img_j) = jax.value_and_grad(
        loss_fused, argnums=(0, 1), has_aux=True)(w_k, jnp.asarray(image))
    import voge_tpu.ops.fine as F

    g_w_j = np.asarray(F.unbin_kern(g_wk, B, gc["BH"], gc["BW"], H, W, gc["bin_size"],
                                    gc["bin_size"], False))
    sel_np, w_np = np.asarray(sel_img), np.asarray(w_img)
    ft = vt.Fragments(t(w_np).clone().requires_grad_(True), t(sel_np),
                      t((sel_np >= 0).sum(-1)), t(w_np))
    img_t = t(image).clone().requires_grad_(True)
    feat, sw = vt.sample_features(ft, img_t, n_vert=n_vert)
    assert float(np.abs(np.asarray(sw_j)).max()) > 0
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(feat_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sw.detach().numpy(), np.asarray(sw_j), rtol=1e-5, atol=1e-5)
    loss = (feat * t(cf)).sum() + (sw * t(cw)).sum()
    g_w, g_img = torch.autograd.grad(loss, (ft.vert_weight, img_t))
    np.testing.assert_allclose(g_w.numpy(), g_w_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_img.numpy(), np.asarray(g_img_j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32, torch.float64])
def test_sample_features_dtype_follows_promotion(dt):
    """The kernels compute in float32; the results take the promoted dtype
    of (image, weights), as ``voge_tpu``'s do (``tests/test_bf16.py``)."""
    idx, w, _ = _frag_arrays()
    _, ft = _frags(idx, w)
    image = torch.full(idx.shape[:3] + (3,), 0.5, dtype=dt)
    feat, sw = vt.sample_features(ft, image, n_vert=20)
    want = torch.promote_types(dt, torch.float32)
    assert feat.dtype == want and sw.dtype == want
    ref, _ = vt.sample_features(ft, image.float(), n_vert=20)
    assert (feat.float() - ref).abs().max() < 2e-2


def test_scatter_max_weight_matches_voge_tpu():
    idx, w, _ = _frag_arrays(N=10)
    fj, ft = _frags(idx, w)
    for n_vert in (10, None, 14):
        want = np.asarray(jsamp.scatter_max_weight(fj, n_vert=n_vert))
        ft.vert_weight = t(w).clone().requires_grad_(True)
        got = vt.scatter_max_weight(ft, n_vert=n_vert)
        assert not got.requires_grad
        np.testing.assert_array_equal(got.numpy(), want)
    assert got[7] == 0                              # never hit: the initial 0


def test_texture_chain_matches_voge_tpu():
    """render (K = 12) -> sample_features -> texture -> re-render, the
    chain of ``bench.py``'s texture workload at a small size: ``ico_sphere(2)``
    (162 Gaussians), 32x84, focal 225 (pixel radii near a supertile's 20
    pixels)."""
    from voge_tpu.cameras import look_at_view_transform
    from voge_tpu.converter.converters import naive_vertices_converter
    from voge_tpu.converter.shapes import ico_sphere

    v, f = ico_sphere(2)
    verts, isig, _ = naive_vertices_converter(v, f, percentage=0.5, max_sig_rate=2)
    verts, isig = np.asarray(verts, np.float32), np.asarray(isig, np.float32)
    n_vert = verts.shape[0]
    R, T = look_at_view_transform(dist=3, elev=0.1, azim=0.6, degrees=False)
    R, T = np.array(R, np.float32), np.array(T, np.float32)
    focal = np.array([[225.0, 225.0]], np.float32)
    principal = np.array([[42.0, 16.0]], np.float32)
    hw, K = (32, 84), 12
    image = np.random.RandomState(0).uniform(size=(1,) + hw + (3,)).astype(np.float32)

    fj = jrend.render_pipeline(jnp.asarray(verts), jnp.asarray(isig), jnp.asarray(R),
                               jnp.asarray(T), jnp.asarray(focal), jnp.asarray(principal),
                               image_size=hw, max_assign=K)
    feat_j, sw_j = jsamp.sample_features(fj, jnp.asarray(image), n_vert=n_vert)
    tex_j = feat_j / (1e-8 + sw_j[:, None])
    img_j = np.asarray(jrend.to_white_background(fj, tex_j))

    ft = vt.render_pipeline(t(verts), t(isig), t(R), t(T), t(focal), t(principal),
                            image_size=hw, max_assign=K)
    feat, sw = vt.sample_features(ft, t(image), n_vert=n_vert)
    tex = feat / (1e-8 + sw[:, None])
    img = vt.to_white_background(ft, tex).numpy()

    assert vt.get_overflow_points(ft) == 0 and jrend.get_overflow_points(fj) == 0
    idx_j = np.asarray(fj.vert_index)
    agree = (ft.vert_index.numpy() == idx_j).all(-1)
    assert (idx_j >= 0).sum() > 5000 and agree.mean() > 0.999
    if agree.all():
        np.testing.assert_allclose(sw.numpy(), np.asarray(sw_j), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tex.numpy(), np.asarray(tex_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(img[agree], img_j[agree], rtol=0, atol=1e-4)


def test_golden_texture_file_is_voge_tpu_output():
    """The golden file of the full-width texture chain that
    ``tests/test_torch_cuda_paths.py`` holds the card's run against is what ``voge_tpu`` computes now (same
    machine class: atol 1e-6 of each tensor's largest entry), drops nothing,
    and its scene is the one the port's converters build."""
    import importlib.util
    from pathlib import Path

    data = Path(__file__).resolve().parent / "data"
    spec = importlib.util.spec_from_file_location(
        "make_voge_tpu_golden_texture", data / "make_voge_tpu_golden_texture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.golden()
    saved = np.load(mod.PATH)
    assert sorted(saved.files) == sorted(fresh)
    assert saved["texture"].shape == (10242, 3) and saved["valid_num"].shape == (256, 672)
    assert int(saved["overflow"]) == 0 and int((saved["wsum"] > 0).sum()) > 1000
    assert mod.PATH.stat().st_size < 1 << 20
    for k in fresh:
        np.testing.assert_allclose(saved[k], fresh[k], rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(fresh[k], np.float64)).max())
    v, f = vt.ico_sphere(5)
    verts, isig, _ = vt.naive_vertices_converter(v, f, percentage=0.5, max_sig_rate=2)
    np.testing.assert_allclose(np.asarray(verts, np.float32), mod.scene()[0], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(isig, np.float32), mod.scene()[1], rtol=1e-6)
