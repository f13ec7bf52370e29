"""The no-coarse ShapeFitting path (``max_point_per_bin=-1``) end to end
against ``voge_tpu`` on the CPU, fed the same numpy scene:

- ``render_pipeline(max_point_per_bin=-1)``: every Gaussian is a candidate
  of every pixel on both sides (``voge_tpu``'s CPU path streams an all-ones
  mask over one whole-image bin; the port tiles the rays in supertiles and
  culls nothing), so ``overflow_points`` is 0 on both;
- the ShapeFitting loss (silhouette + RGB MSE through ``interpolate_attr``
  and ``get_silhouette``) and its gradients, cameras included, against
  ``jax.grad``;
- ``models.ShapeFitter`` against ``voge_tpu.models.ShapeFitter`` from the
  same state, carried over by ``interop.fitter_from_numpy``;
- the golden file ``chip_smoke.py`` holds the card's run against.

Tolerances (``tests/test_parity_full.py:22-49``): selections equal but for
knife-edge pixels (< 0.1% flipped); weights, hit lengths and images atol 1e-4
on agreeing pixels; the loss to a relative 1e-5 and each gradient to a
normwise relative 1e-3 (f32 sums in another order, ``torch.erf`` against
XLA's erf).  ``ShapeFitter``: per-step losses to a relative 1e-5 and the
parameters' displacement from the start to a normwise relative 1e-3 (each
step's update is lr x the momentum trace of gradients held to 1e-3)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import voge_tpu.renderer as jr
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.converter.converters import naive_vertices_converter
from voge_tpu.converter.shapes import ico_sphere
from voge_tpu.models import ShapeFitter as JShapeFitter
import voge_tpu_torch as vt

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"
B, HW = 2, (32, 32)


def _scene():
    """``ico_sphere(2)`` (162 Gaussians) through ``naive_vertices_converter``,
    random colours, two cameras at 32x32; targets as ``bench.py``'s
    shapefit row (silhouette 0, RGB 0.3)."""
    v, f = ico_sphere(2)
    verts, isig, _ = naive_vertices_converter(v, f, percentage=0.5)
    colors = np.random.RandomState(0).uniform(0, 1, (verts.shape[0], 3)).astype(np.float32)
    R, T = look_at_view_transform(dist=[2.7, 3.0], elev=[-10.0, 20.0], azim=[-40.0, 30.0])
    focal = np.full((B, 2), 31.5, np.float32)
    principal = np.full((B, 2), 16.0, np.float32)
    t_rgb = np.full((B,) + HW + (3,), 0.3, np.float32)
    t_sil = np.zeros((B,) + HW, np.float32)
    return (verts, isig, colors, np.array(R, np.float32), np.array(T, np.float32),
            focal, principal, t_rgb, t_sil)


def _t(x, grad=False):
    return torch.tensor(np.array(x), requires_grad=grad)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(want) > 0
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("K", [8, 25])
def test_no_coarse_render_matches_voge_tpu(K):
    verts, isig, colors, R, T, focal, principal = _scene()[:7]
    kw = dict(image_size=HW, max_assign=K, max_point_per_bin=-1)
    fj = jr.render_pipeline(jnp.asarray(verts), jnp.asarray(isig), R, T, focal, principal,
                            attrs=jnp.asarray(colors), **kw)
    ft = vt.render_pipeline(_t(verts), _t(isig), _t(R), _t(T), _t(focal), _t(principal),
                            attrs=_t(colors), **kw)
    assert int(ft.overflow_points) == 0 == int(fj.overflow_points)
    it, ij = ft.vert_index.numpy(), np.asarray(fj.vert_index)
    assert it.shape == (B,) + HW + (K,)
    agree = (it == ij).all(-1)
    assert 1.0 - agree.mean() < 1e-3
    if K == 8:
        assert ((it >= 0).sum(-1) == K).any()          # some pixels fill every slot
    assert (it[1][it[1] >= 0] >= verts.shape[0]).all()  # ids b * N + n
    for got, want in ((ft.vert_weight, fj.vert_weight), (ft.vert_hit_length, fj.vert_hit_length),
                      (ft.attr_img, fj.attr_img),
                      (vt.get_silhouette(ft), jr.get_silhouette(fj))):
        np.testing.assert_allclose(got.numpy()[agree], np.asarray(want)[agree], rtol=0, atol=1e-4)
    # attrs= gives what interpolate_attr gives on the same fragments
    torch.testing.assert_close(ft.attr_img, vt.interpolate_attr(ft, _t(colors)), rtol=0, atol=0)


def test_gaussian_renderer_passes_no_coarse_through():
    """``GaussianRenderSettings(max_point_per_bin=-1)`` through
    ``GaussianRenderer`` renders what ``render_pipeline`` renders."""
    verts, isig, colors, R, T, focal, principal = _scene()[:7]
    g, _ = vt.scene_from_numpy(verts, isig, colors, device="cpu")
    cam = vt.cameras_from_numpy(R, T, focal, principal, (HW,) * B, device="cpu")
    rs = vt.GaussianRenderSettings(image_size=HW, max_assign=25, max_point_per_bin=-1)
    frag = vt.GaussianRenderer(cam, rs)(g)
    want = vt.render_pipeline(_t(verts), _t(isig), _t(R), _t(T), _t(focal), _t(principal),
                              image_size=HW, max_assign=25, max_point_per_bin=-1)
    assert vt.get_overflow_points(frag) == 0
    assert torch.equal(frag.vert_index, want.vert_index)
    torch.testing.assert_close(frag.vert_weight, want.vert_weight, rtol=0, atol=1e-6)


def _loss_j(verts, isig, colors, R, T, focal, principal, t_rgb, t_sil, K):
    f = jr.render_pipeline(verts, isig, R, T, jnp.asarray(focal), jnp.asarray(principal),
                           image_size=HW, max_assign=K, max_point_per_bin=-1)
    return (jnp.mean((jr.get_silhouette(f) - t_sil) ** 2)
            + jnp.mean((jr.interpolate_attr(f, colors) - t_rgb) ** 2))


def _loss_t(verts, isig, colors, R, T, focal, principal, t_rgb, t_sil, K):
    f = vt.render_pipeline(verts, isig, R, T, _t(focal), _t(principal), image_size=HW,
                           max_assign=K, max_point_per_bin=-1)
    assert int(f.overflow_points) == 0
    return (((vt.get_silhouette(f) - _t(t_sil)) ** 2).mean()
            + ((vt.interpolate_attr(f, colors) - _t(t_rgb)) ** 2).mean())


@pytest.mark.parametrize("K", [8, 25])
def test_no_coarse_loss_and_gradients_match_jax_grad(K):
    """The ShapeFitting loss and its gradients for verts, sigmas, colours
    and both camera tensors (``camera_grad=True``: the global backward's ray
    gradient) against ``jax.grad`` of the same ``voge_tpu`` loss."""
    verts, isig, colors, R, T, focal, principal, t_rgb, t_sil = _scene()
    loss_ref, grads_ref = jax.value_and_grad(_loss_j, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in (verts, isig, colors, R, T)), focal, principal,
        t_rgb, t_sil, K)
    args = [_t(x, grad=True) for x in (verts, isig, colors, R, T)]
    loss = _loss_t(*args, focal, principal, t_rgb, t_sil, K)
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    for name, a, g in zip(("verts", "sigmas", "colors", "R", "T"), args, grads_ref):
        assert a.grad.shape == a.shape and torch.isfinite(a.grad).all(), name
        assert _rel(a.grad.numpy(), g) <= 1e-3, (name, _rel(a.grad.numpy(), g))


def test_no_coarse_backward_repeats_to_the_bit():
    verts, isig, colors, R, T, focal, principal, t_rgb, t_sil = _scene()
    args = [_t(x, grad=True) for x in (verts, isig, colors, R, T)]
    loss = _loss_t(*args, focal, principal, t_rgb, t_sil, 25)
    g1 = torch.autograd.grad(loss, args, retain_graph=True)
    g2 = torch.autograd.grad(loss, args)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def _fitters():
    """A ``voge_tpu`` ShapeFitter and the port's, verts and colours optimized,
    sigmas fixed (``demo/shape_fitting.py``), default optimizers."""
    verts, isig, colors, _, _, focal, principal = _scene()[:7]
    kw = dict(image_size=HW, focal=focal[0], principal=principal[0], max_assign=25)
    jf = JShapeFitter({"verts": jnp.asarray(verts), "colors": jnp.asarray(colors)},
                      {"sigmas": jnp.asarray(isig)}, **kw)
    return jf, dict(kw, device="cpu")


def _numpy_state(jf):
    params = {k: np.asarray(v) for k, v in jf.params.items()}
    fixed = {k: np.asarray(v) for k, v in jf.fixed.items()}
    trace = {k: np.asarray(v) for k, v in jf.opt_state[0].trace.items()}
    return params, fixed, trace


def _hold(tf, jf, start):
    for k, p in tf.params.items():
        moved = p.detach().numpy() - start[k]
        assert _rel(moved, np.asarray(jf.params[k]) - start[k]) <= 1e-3, k


def test_shape_fitter_steps_match_voge_tpu():
    """Three default-optimizer steps from the same numpy state: losses per
    step and parameters after each."""
    _, _, _, R, T, _, _, t_rgb, t_sil = _scene()
    jf, kw = _fitters()
    params, fixed, _ = _numpy_state(jf)
    tf = vt.fitter_from_numpy(params, fixed, **kw)
    assert isinstance(tf.opt, torch.optim.SGD) and tf.device == torch.device("cpu")
    assert set(tf.params) == {"verts", "colors"} and set(tf.fixed) == {"sigmas"}
    for _ in range(3):
        lj = jf.step(R, T, t_rgb, t_sil)
        lt = tf.step(R, T, t_rgb, t_sil)
        assert abs(lt - lj) <= 1e-5 * abs(lj)
        _hold(tf, jf, params)
    rgb, sil = tf.render(R, T)
    assert rgb.shape == (B,) + HW + (3,) and sil.shape == (B,) + HW


def test_fitter_from_numpy_resumes_the_momentum_trace():
    """One ``voge_tpu`` step, then its parameters and ``optax`` momentum
    trace carried into the port: the next two steps of both agree (without
    the trace the port's second step would not)."""
    _, _, _, R, T, _, _, t_rgb, t_sil = _scene()
    jf, kw = _fitters()
    start = _numpy_state(jf)[0]
    jf.step(R, T, t_rgb, t_sil)
    params, fixed, trace = _numpy_state(jf)
    assert all(np.abs(v).max() > 0 for v in trace.values())
    tf = vt.fitter_from_numpy(params, fixed, opt_trace=trace, **kw)
    for _ in range(2):
        lj = jf.step(R, T, t_rgb, t_sil)
        lt = tf.step(R, T, t_rgb, t_sil)
        assert abs(lt - lj) <= 1e-5 * abs(lj)
        _hold(tf, jf, start)
    with pytest.raises(ValueError):
        vt.fitter_from_numpy(params, fixed, opt_trace={"verts": trace["verts"]}, **kw)


def test_fit_samples_the_same_views_as_voge_tpu():
    """``fit(views_per_iter=1, seed=...)`` draws its views with
    ``np.random.RandomState(seed)`` on both sides: the same view each step,
    and the same losses."""
    _, _, _, R, T, _, _, t_rgb, t_sil = _scene()
    jf, kw = _fitters()
    tf = vt.fitter_from_numpy(*_numpy_state(jf)[:2], **kw)
    seen = {"j": [], "t": []}

    def spy(fitter, tag):
        real = fitter.step

        def step(R_, T_, rgb, sil):
            seen[tag].append(np.asarray(R_).copy())
            return real(R_, T_, rgb, sil)
        fitter.step = step

    spy(jf, "j")
    spy(tf, "t")
    lj = jf.fit(R, T, t_rgb, t_sil, iters=3, views_per_iter=1, seed=5)
    lt = tf.fit(_t(R), _t(T), _t(t_rgb), _t(t_sil), iters=3, views_per_iter=1, seed=5)
    assert len(seen["j"]) == 3 and all(r.shape == (1, 3, 3) for r in seen["t"])
    for a, b in zip(seen["j"], seen["t"]):
        np.testing.assert_array_equal(a, b)
    assert abs(lt - lj) <= 1e-5 * abs(lj)


@pytest.mark.parametrize("shape,model_axis", [((1, 2), "model"), ((2, 1), "model"),
                                              ((2, 1), None)])
def test_shape_fitter_on_a_mesh_follows_voge_tpu(shape, model_axis):
    """``ShapeFitter(mesh=)`` on a mesh of logical CPU shards against
    ``voge_tpu``'s ``ShapeFitter(mesh=)`` on as many of its virtual devices,
    from the same state: two steps, losses within 1e-5 relative, parameters
    within 1e-4; the parameters live on the mesh's first device.  With the
    scene replicated (``model_axis=None``) ``voge_tpu``'s trainer fails in
    ``interpolate_attr`` (its fused context keeps one shard's shape), so the
    port holds to its unsharded trainer there."""
    from voge_tpu.parallel import make_mesh as j_make_mesh

    verts, isig, colors, R, T, focal, principal, t_rgb, t_sil = _scene()
    assert verts.shape[0] % 2 == 0
    kw = dict(image_size=HW, focal=focal[0], principal=principal[0], max_assign=25,
              model_axis=model_axis)
    jf = JShapeFitter({"verts": jnp.asarray(verts), "colors": jnp.asarray(colors)},
                      {"sigmas": jnp.asarray(isig)},
                      mesh=(j_make_mesh(("data", "model"), shape, devices=jax.devices()[:2])
                            if model_axis else None), **kw)
    mesh = vt.parallel.make_mesh(("data", "model"), shape, devices=["cpu"] * 2)
    tf = vt.ShapeFitter({"verts": verts, "colors": colors}, {"sigmas": isig}, mesh=mesh, **kw)
    assert tf.device == torch.device("cpu") and tf.params["verts"].device == tf.device
    for _ in range(2):
        lj = jf.step(R, T, t_rgb, t_sil)
        lt = tf.step(R, T, t_rgb, t_sil)
        assert abs(lt - lj) <= 1e-5 * abs(lj)
    for k, p in tf.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jf.params[k]), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="first device"):
        vt.ShapeFitter({"verts": verts}, {"sigmas": isig, "colors": colors}, mesh=mesh,
                       device="cuda:1", **kw)


def test_golden_shapefit_file_is_voge_tpu_output():
    """The golden file of the full-width ShapeFitting step that
    ``chip_smoke.py`` holds the card's run against is what ``voge_tpu``
    computes now (same machine class: atol 1e-6 of each tensor's largest
    entry)."""
    spec = importlib.util.spec_from_file_location(
        "make_voge_tpu_golden_shapefit", DATA / "make_voge_tpu_golden_shapefit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.golden()
    saved = np.load(mod.PATH)
    assert sorted(saved.files) == sorted(fresh)
    assert saved["grad_verts"].shape == (2562, 3) and saved["fit_loss"].shape == (3,)
    for k in fresh:
        np.testing.assert_allclose(saved[k], fresh[k], rtol=1e-5,
                                   atol=1e-6 * np.abs(fresh[k]).max())
