"""The dense route of the port against ``voge_tpu`` on the CPU:

- ``ops/dense.py``'s five functions against ``voge_tpu.ops.dense`` in
  float32 and in float64 (``jax.enable_x64``), values and gradients;
- the float64 oracle (``voge_tpu_torch.oracle.render``: the dense select,
  its closed-form backward, the erf weights, the merge) against
  ``voge_tpu``'s chain in float64 at the quickstart shape (the 1K cuboid,
  128x128, K = 20, default coarse stage) and the ShapeFitting shape
  (``ico_sphere(4)``, 128x128, K = 25, no coarse stage; one of
  ``bench.py``'s five views: ``voge_tpu``'s float64 chain takes ~4.8 GB a
  view on the CPU).  ``voge_tpu.renderer.render_pipeline`` rounds verts and
  sigmas (and so their gradients) to float32 even under x64, so the
  reference is its chain below that cast: ``camera_rays`` ->
  ``ops.fine.ray_tracing`` (its XLA route on the CPU) -> ``Fragments`` ->
  ``to_white_background`` / ``get_silhouette``.  Indices equal; weights,
  images, the loss and the gradients within 1e-9; the same at K = 200 below;
- the float32 plain versions of K2 (compacted and global) and K3, the
  port's CPU render path, against that oracle at the same shapes, within the
  float32 envelope of ``tests/test_parity_full.py:22-49``;
- K above 128: ``render_pipeline(max_assign=200)`` on the 10K cuboid at
  64x64, focal 75, in both modes (thr 0.01 with the default coarse stage,
  thr 1e-8 without one) against ``voge_tpu`` (its XLA route) and its golden
  file, with pixels past 128 hits asserted, and its sigma gradient against
  ``voge_tpu``'s float64 chain; no render at K <= 128 takes the dense route,
  whatever the inputs' dtype.
"""
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import voge_tpu.ops.dense as jdense
import voge_tpu_torch as vt
from voge_tpu_torch import oracle
from voge_tpu_torch.ops import dense as tdense
from voge_tpu_torch.ops import dense_select, fine as tfine

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"
EXACT_TOL = 1e-9       # float64 port against float64 voge_tpu
PIXEL_TOL = 1.5e-3     # the float32 envelope (tests/test_parity_full.py:22-49)
FLIP_PIXEL_TOL = 3e-2
FLIP_FRAC_TOL = 1e-3
F32_GRAD_TOL = 1e-4    # max |dg| / max |g| of the float32 path against float64


def _maker(name):
    spec = importlib.util.spec_from_file_location(name, DATA / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---- ops/dense.py ----------------------------------------------------------

def _hit_inputs(seed, P=40, N=30):
    rs = np.random.RandomState(seed)
    mus = rs.normal(0, 1, (P, 3)) + np.array([0.0, 0.0, 5.0])
    A = rs.normal(0, 0.5, (P, 3, 3))
    isig = np.einsum("pij,pkj->pik", A, A) + 2.0 * np.eye(3)
    rays = rs.normal(0, 0.2, (N, 3)) + np.array([0.0, 0.0, 1.0])
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return mus, isig, rays


@pytest.mark.parametrize("sig", ["scalar", "vector", "matrix"])
def test_expand_isigmas_matches(sig):
    mus, isig, _ = _hit_inputs(0)
    val = {"scalar": 2.5, "vector": isig[:, 0, 0], "matrix": isig}[sig]
    want = np.asarray(jdense.expand_isigmas(val if sig == "scalar" else jnp.asarray(val), 40))
    got = tdense.expand_isigmas(val if sig == "scalar" else torch.tensor(val, dtype=torch.float32),
                                40, device="cpu")
    assert tuple(got.shape) == (40, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_hit_values_and_ray_trace_voge_ray_match(dt):
    mus, isig, rays = _hit_inputs(1)
    tol = dict(float32=1e-4, float64=1e-12)[dt]
    with jax.enable_x64(dt == "float64"):
        j = jdense.ray_trace_voge_ray(*(jnp.asarray(x, dt) for x in (mus, isig, rays)))
        jh = jdense.hit_values(*(jnp.asarray(x, dt)[None] for x in (mus, isig, rays)))
        j, jh = [np.asarray(x) for x in j], [np.asarray(x) for x in jh]
    tdt = getattr(torch, dt)
    t = tdense.ray_trace_voge_ray(*(torch.tensor(x, dtype=tdt) for x in (mus, isig, rays)))
    th = tdense.hit_values(*(torch.tensor(x, dtype=tdt)[None] for x in (mus, isig, rays)))
    for a, b in zip(t, j):
        assert a.dtype == tdt and tuple(a.shape) == (30, 40)
        assert _rel_max(a.numpy(), b) < tol
    for a, b in zip(th, jh):
        assert _rel_max(a.numpy(), b) < tol


@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("far", [False, True])
def test_find_nearest_and_farest_k_match(dt, far):
    """Selections equal; the three hit tensors' gradients of a seeded linear
    loss of the outputs equal ``jax.grad``'s (each goes to its own tensor)."""
    mus, isig, rays = _hit_inputs(2, P=60, N=25)
    K, thr = 12, 0.01
    cots = [np.random.RandomState(10 + q).normal(size=(25, K)) for q in range(3)]
    with jax.enable_x64(dt == "float64"):
        hits = jdense.ray_trace_voge_ray(*(jnp.asarray(x, dt) for x in (mus, isig, rays)))
        fn = jdense.find_farest_k if far else jdense.find_nearest_k

        def lin(l, a, d):
            out = fn(l, a, d, K, thr)
            keep = out[0] >= 0
            return sum(jnp.sum(jnp.where(keep, o, 0.0) * jnp.asarray(c, dt))
                       for o, c in zip(out[1:], cots)), out

        (_, jout), jg = jax.value_and_grad(lin, argnums=(0, 1, 2), has_aux=True)(*hits)
        jout, jg = [np.asarray(x) for x in jout], [np.asarray(x) for x in jg]
    tdt = getattr(torch, dt)
    thits = [torch.tensor(np.asarray(h), dtype=tdt, requires_grad=True) for h in hits]
    tfn = tdense.find_farest_k if far else tdense.find_nearest_k
    tout = tfn(*thits, K, thr)
    keep = tout[0] >= 0
    loss = sum((torch.where(keep, o, 0.0) * torch.tensor(c, dtype=tdt)).sum()
               for o, c in zip(tout[1:], cots))
    tg = torch.autograd.grad(loss, thits)
    assert keep.any() and (~keep).any()
    np.testing.assert_array_equal(tout[0].numpy(), jout[0])
    for a, b in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(a.detach().numpy(), b.astype(a.detach().numpy().dtype))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6 * max(np.abs(b).max(), 1))


# ---- the float64 oracle ----------------------------------------------------

def _quickstart():
    from voge_tpu.cameras import look_at_view_transform
    from voge_tpu.converter import Cuboid

    g = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6, as_obj=True)
    verts = np.asarray(g.verts, np.float64)
    R, T = look_at_view_transform(dist=6, elev=10, azim=70)
    cams = (np.asarray(R, np.float64), np.asarray(T, np.float64),
            np.array([[150.0, 150.0]]), np.array([[64.0, 64.0]]))
    return dict(verts=verts, sigmas=np.asarray(g.sigmas, np.float64), colors=(verts + 1) / 3,
                cams=cams, hw=(128, 128), K=20, mppb=None)


def _shapefit():
    m = _maker("make_voge_tpu_golden_shapefit")
    verts, isig, colors = m.scene()[:3]
    R, T = m.cameras()
    focal, principal = m.scene()[3:5]
    cams = tuple(np.asarray(x[:1], np.float64) for x in (R, T, focal, principal))
    return dict(verts=np.asarray(verts, np.float64), sigmas=np.asarray(isig, np.float64),
                colors=np.random.RandomState(0).uniform(0, 1, (verts.shape[0], 3)),
                cams=cams, hw=m.HW, K=m.K, mppb=-1)


def _loss_t(frag, colors):
    img = vt.to_white_background(frag, colors)
    sil = vt.get_silhouette(frag)
    return ((img - 0.4) ** 2).mean() + (sil ** 2).mean(), img, sil


def _voge_tpu_f64(c):
    """voge_tpu's chain in float64 below render_pipeline's float32 cast:
    (loss, grads (verts, sigmas, colours), vert_index, vert_weight, image,
    silhouette).  The image is ``to_white_background``'s, or with
    ``c["loss"] == "attr"`` the attribute image of bench's loss
    ``mean((attr_img - 0.5)^2) + mean(silhouette^2)``."""
    from voge_tpu.aggregation import expend_sigma
    from voge_tpu.ops.fine import ray_tracing
    from voge_tpu.rays import camera_rays
    from voge_tpu.renderer import (Fragments, get_silhouette, interpolate_attr,
                                   to_white_background)

    with jax.enable_x64(True):
        cams = tuple(jnp.asarray(x, jnp.float64) for x in c["cams"])
        B = cams[0].shape[0]

        def loss_fn(v, s, col):
            rays, org = camera_rays(*cams, c["hw"])
            pts = v[None] - org[:, None, :]
            e = expend_sigma(s)
            isg = jnp.broadcast_to(2.0 * e[None], (B,) + e.shape)
            sel = ray_tracing(cams, pts, isg, rays, c["hw"], c.get("thr", 0.01), c["K"],
                              max_points_per_bin=c["mppb"], agg_ow=1.0)
            fr = Fragments(vert_weight=sel[4], vert_index=sel[0],
                           valid_num=(sel[0] >= 0).sum(-1), vert_hit_length=sel[1])
            sil = get_silhouette(fr)
            if c.get("loss") == "attr":
                img = interpolate_attr(fr, col)
                return jnp.mean((img - 0.5) ** 2) + jnp.mean(sil ** 2), (fr, img, sil)
            img = to_white_background(fr, col)
            return jnp.mean((img - 0.4) ** 2) + jnp.mean(sil ** 2), (fr, img, sil)

        (loss, (fr, img, sil)), grads = jax.value_and_grad(loss_fn, (0, 1, 2), has_aux=True)(
            *(jnp.asarray(c[k], jnp.float64) for k in ("verts", "sigmas", "colors")))
        return (float(loss), [np.asarray(g) for g in grads], np.asarray(fr.vert_index),
                np.asarray(fr.vert_weight), np.asarray(img), np.asarray(sil))


def _white(frag, sil):
    """``to_white_background`` of the oracle's float64 attribute image."""
    out = frag.attr_img + (1 - sil[..., None])
    return torch.minimum(out, torch.ones_like(out))


def _port(c, dtype):
    """The port's render, loss and gradients at ``dtype`` (float64: the
    oracle; float32: the plain versions of the kernels)."""
    t = lambda x, grad=False: torch.tensor(np.asarray(x), dtype=dtype, requires_grad=grad)
    v, s, col = (t(c[k], True) for k in ("verts", "sigmas", "colors"))
    kw = dict(image_size=c["hw"], max_assign=c["K"], max_point_per_bin=c["mppb"])
    if dtype == torch.float64:
        frag = oracle.render(v, s, *(t(x) for x in c["cams"]), attrs=col, **kw)
        sil = vt.get_silhouette(frag)
        img = _white(frag, sil)
        loss = ((img - 0.4) ** 2).mean() + (sil ** 2).mean()
    else:
        frag = vt.render_pipeline(v, s, *(t(x) for x in c["cams"]), **kw)
        loss, img, sil = _loss_t(frag, col)
    grads = torch.autograd.grad(loss, (v, s, col))
    return (loss.item(), [g.numpy() for g in grads], frag.vert_index.numpy(),
            frag.vert_weight.detach().numpy(), img.detach().numpy(), sil.detach().numpy(),
            int(frag.overflow_points))


@pytest.fixture(scope="module", params=["quickstart", "shapefitting"])
def oracle_case(request):
    c = {"quickstart": _quickstart, "shapefitting": _shapefit}[request.param]()
    return request.param, c, _port(c, torch.float64)


def test_float64_oracle_matches_voge_tpu_float64(oracle_case):
    _, c, port = oracle_case
    loss, grads, idx, w, img, sil = _voge_tpu_f64(c)
    assert port[6] == 0 and (idx >= 0).any()
    np.testing.assert_array_equal(port[2], idx)
    for a, b in ((port[3], w), (port[4], img), (port[5], sil)):
        assert a.dtype == np.float64 and np.abs(a - b).max() < EXACT_TOL
    assert abs(port[0] - loss) < EXACT_TOL
    for a, b in zip(port[1], grads):
        assert a.dtype == np.float64 and _rel_max(a, b) < EXACT_TOL


def test_float32_plain_kernels_within_the_envelope_of_the_oracle(oracle_case, monkeypatch):
    """The float32 render on the CPU runs K2's and K3's plain versions
    (the compacted entries at the quickstart shape, the global ones at the
    ShapeFitting shape) and never the dense route; against the float64
    oracle: flipped pixels < 0.1%, weights and images within 1.5e-3 on the
    others (3e-2 on flipped ones), each gradient within 1e-4 of its largest
    entry."""
    from voge_tpu_torch.ops import cuda_fine, cuda_fine_bwd

    name, c, want = oracle_case
    calls = []
    for mod, fn in ((tfine, "fine_select"), (tfine, "fine_select_global"),
                    (tfine, "fine_bwd"), (tfine, "fine_bwd_global"),
                    (dense_select, "fine_forward")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _n=fn, **k: (calls.append(_n), _o(*a, **k))[1])
    got = _port(c, torch.float32)
    entries = {"quickstart": {"fine_select", "fine_bwd"},
               "shapefitting": {"fine_select_global", "fine_bwd_global"}}[name]
    assert set(calls) == entries
    flips = (got[2] != want[2]).any(-1)
    assert flips.mean() < FLIP_FRAC_TOL
    for a, b in ((got[3], want[3]), (got[4], want[4]), (got[5], want[5])):
        d = np.abs(a.astype(np.float64) - b).reshape(flips.shape + (-1,))
        assert d[~flips].max() < PIXEL_TOL
        if flips.any():
            assert d[flips].max() < FLIP_PIXEL_TOL
    assert abs(got[0] - want[0]) / abs(want[0]) < 1e-5
    for a, b in zip(got[1], want[1]):
        assert _rel_max(a, b) < F32_GRAD_TOL


# ---- K above 128 -----------------------------------------------------------

@pytest.fixture(scope="module")
def large_k():
    m = _maker("make_voge_tpu_golden_large_k")
    return m, m.scene(), m.run()


def _port_large_k(m, scene, mode, f64=False):
    """The port's K = 200 render in ``mode`` -> bench's loss -> gradients
    (``f64``: the float64 oracle)."""
    verts, sigmas, colors, cams = scene
    thr, mppb = m.MODES[mode]
    dt = torch.float64 if f64 else torch.float32
    t = lambda x, grad=False: torch.tensor(np.asarray(x), dtype=dt, requires_grad=grad)
    v, s, col = t(verts, True), t(sigmas, True), t(colors, True)
    render = oracle.render if f64 else vt.render_pipeline
    frag = render(v, s, *(t(x) for x in cams), image_size=m.HW, max_assign=m.K,
                  thr_activation=thr, max_point_per_bin=mppb, attrs=col)
    sil = vt.get_silhouette(frag)
    loss = ((frag.attr_img - 0.5) ** 2).mean() + (sil ** 2).mean()
    return frag, sil, loss, torch.autograd.grad(loss, (v, s, col))


@functools.lru_cache(maxsize=None)
def _large_k_f64(mode):
    """(voge_tpu's float64 chain, the port's float64 oracle) at K = 200."""
    m = _maker("make_voge_tpu_golden_large_k")
    verts, sigmas, colors, cams = scene = m.scene()
    thr, mppb = m.MODES[mode]
    c = dict(verts=verts, sigmas=sigmas, colors=colors, cams=cams, hw=m.HW, K=m.K,
             mppb=mppb, thr=thr, loss="attr")
    return _voge_tpu_f64(c), _port_large_k(m, scene, mode, f64=True)


@pytest.mark.parametrize("mode", ["coarse", "no_coarse"])
def test_k_above_128_renders_and_matches_voge_tpu(large_k, mode, monkeypatch):
    """No ``NotImplementedError``: the dense route serves K = 200 (one call
    of its select) and equals ``voge_tpu``'s XLA route: selections equal but
    for knife-edge pixels (< 0.1%), weights, image and silhouette within
    1e-4, the loss within 1e-5, the verts' and colours' gradients within 1e-3
    normwise.  The sigma gradient is held to ``voge_tpu``'s float64 chain
    within 1e-3: ``voge_tpu``'s own float32 one lies 1e-3 to 3e-3 from it
    (its sum-then-combine chain rule at |mu| ~ 6), measured here; the
    port's (residual form) is closer.  Every gradient is also within 1e-3 of
    the port's float64 oracle.  The scene has pixels past 128 hits on both
    sides (12 and 190)."""
    m, scene, runs = large_k
    j_loss, j_grads, j_frag, j_sil = runs[mode]
    calls = []
    orig = dense_select.fine_forward
    monkeypatch.setattr(dense_select, "fine_forward",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    frag, sil, loss, grads = _port_large_k(m, scene, mode)
    assert calls == [1]
    assert int(frag.overflow_points) == 0 == int(j_frag.overflow_points)
    idx_j = np.asarray(j_frag.vert_index)
    past = {"coarse": 12, "no_coarse": 190}[mode]
    assert ((idx_j >= 0).sum(-1) > 128).sum() == past
    assert (frag.valid_num.numpy() > 128).sum() == past
    agree = (frag.vert_index.numpy() == idx_j).all(-1)
    assert 1.0 - agree.mean() < FLIP_FRAC_TOL
    for a, b in ((frag.vert_weight, j_frag.vert_weight), (frag.attr_img, j_frag.attr_img),
                 (sil, j_sil)):
        np.testing.assert_allclose(a.detach().numpy()[agree], np.asarray(b)[agree],
                                   rtol=0, atol=1e-4)
    assert abs(loss.item() - j_loss) / abs(j_loss) < 1e-5
    for name, a, b in zip(("verts", "sigmas", "colors"), grads, j_grads):
        if name != "sigmas":
            assert _rel(a.numpy(), b) < 1e-3, name
    j64, port64 = _large_k_f64(mode)
    sig64 = j64[1][1]
    port_err, voge_err = _rel(grads[1].numpy(), sig64), _rel(j_grads[1], sig64)
    assert port_err < 1e-3 and port_err < voge_err
    assert 1e-3 < voge_err < 3e-3
    for a, b in zip(grads, port64[3]):
        assert _rel(a.numpy(), b.numpy()) < 1e-3


@pytest.mark.parametrize("mode", ["coarse", "no_coarse"])
def test_float64_oracle_matches_voge_tpu_float64_above_k128(mode):
    """At K = 200 (the dense route past the kernels' K) the oracle equals
    ``voge_tpu``'s float64 chain: indices equal; weights, image, silhouette,
    the loss and the gradients within 1e-9."""
    (loss, grads, idx, w, img, sil), (frag, o_sil, o_loss, o_grads) = _large_k_f64(mode)
    assert int(frag.overflow_points) == 0 and (frag.valid_num > 128).any()
    np.testing.assert_array_equal(frag.vert_index.numpy(), idx)
    for a, b in ((frag.vert_weight, w), (frag.attr_img, img), (o_sil, sil)):
        a = a.detach().numpy()
        assert a.dtype == np.float64 and np.abs(a - b).max() < EXACT_TOL
    assert abs(o_loss.item() - loss) < EXACT_TOL
    for a, b in zip(o_grads, grads):
        assert a.dtype == torch.float64 and _rel_max(a.numpy(), b) < EXACT_TOL


def test_large_k_golden_file_is_voge_tpu_output(large_k):
    """The file ``tests/test_torch_cuda_paths.py`` holds the card's K = 200
    route against is
    what ``voge_tpu`` computes now."""
    m, _, runs = large_k
    fresh = m.pack(runs)
    saved = np.load(m.PATH)
    assert sorted(saved.files) == sorted(fresh)
    for k, v in fresh.items():
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            np.testing.assert_array_equal(saved[k], v)
        else:
            np.testing.assert_allclose(saved[k], v, rtol=0,
                                       atol=1e-6 * max(np.abs(v).max(), 1e-30))


@pytest.mark.parametrize("K,mppb", [(20, None), (128, None), (20, -1), (128, -1), (129, None)])
def test_only_k_above_128_takes_the_dense_route(K, mppb, monkeypatch):
    """A spy on the dense select: K <= 128 never reaches it (the kernels'
    plain versions serve), in float32 and with float64 inputs alike (the
    route is chosen by K alone); K = 129 does, once a render."""
    calls = []
    orig = dense_select.fine_forward
    monkeypatch.setattr(dense_select, "fine_forward",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 100, percentage=0.6,
                                         as_obj=True, device="cpu")
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70, device="cpu")
    for dt in (torch.float32, torch.float64):
        calls.clear()
        frag = vt.render_pipeline(g.verts.to(dt), g.sigmas.to(dt), R.to(dt), T.to(dt),
                                  torch.tensor([[30.0, 30.0]], dtype=dt),
                                  torch.tensor([[16.0, 16.0]], dtype=dt), image_size=(32, 32),
                                  max_assign=K, max_point_per_bin=mppb)
        assert frag.vert_index.shape[-1] == K and (frag.valid_num > 0).any()
        assert frag.vert_weight.dtype == torch.float32
        assert calls == ([1] if K > 128 else [])
    assert tfine.takes_dense_route(K) == (K > 128)
