"""The port's render and its gradients end to end against ``voge_tpu`` on
the CPU (where ``voge_tpu`` takes its XLA fallback, which computes the same
function when no bin overflows), fed the same scenes and cameras through
``voge_tpu_torch.interop``.

Tolerances (``tests/test_parity_full.py:22-49``): selections equal but for
knife-edge pixels, flipped pixels < 0.1%; weights, silhouettes and
composited images atol 1e-4 on agreeing pixels; ``overflow_points`` equal
(0 on both sides).  Gradients: normwise relative error <= 1e-3 per tensor and
the loss to a relative 1e-5 (f32 sums in another order, ``torch.erf`` against
XLA's erf, knife-edge pixels)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

import voge_tpu.renderer as jr
from voge_tpu.cameras import PerspectiveCameras as JCameras
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.converter import Cuboid
import voge_tpu_torch as vt

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"


def _agree(frag_t, frag_j):
    idx_t = frag_t.vert_index.numpy()
    idx_j = np.asarray(frag_j.vert_index)
    agree = (idx_t == idx_j).all(-1)
    assert 1.0 - agree.mean() < 1e-3, 1.0 - agree.mean()
    return agree


def _close(t, j, agree):
    np.testing.assert_allclose(t.detach().numpy()[agree], np.asarray(j)[agree],
                               rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def quickstart():
    """README quickstart: the 1K cuboid at 256x256, K=20, focal 300."""
    gj = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6, as_obj=True)
    R, T = look_at_view_transform(dist=6, elev=10, azim=70)
    focal, principal = np.array([[300.0, 300.0]]), np.array([[128.0, 128.0]])
    rs = dict(image_size=(256, 256), principal=(128, 128))
    cam_j = JCameras(focal_length=300, image_size=((256, 256),), principal_point=((128, 128),))
    frag_j = jr.GaussianRenderer(cam_j, jr.GaussianRenderSettings(**rs))(gj, R=R, T=T)
    colors = (np.asarray(gj.verts) + 1) / 3
    g, colors_t = vt.scene_from_numpy(np.asarray(gj.verts), np.asarray(gj.sigmas), colors,
                                       device="cpu")
    cam_t = vt.cameras_from_numpy(np.array(R), np.array(T), focal, principal, ((256, 256),),
                                 device="cpu")
    frag_t = vt.GaussianRenderer(cam_t, vt.GaussianRenderSettings(**rs))(g)
    return frag_t, frag_j, colors_t, jnp.asarray(colors)


def test_quickstart_matches_voge_tpu(quickstart):
    frag_t, frag_j, colors_t, colors_j = quickstart
    assert frag_t.vert_index.shape == (1, 256, 256, 20)
    assert frag_t.vert_index.dtype == torch.int32
    assert vt.get_overflow_points(frag_t) == 0 == jr.get_overflow_points(frag_j)
    agree = _agree(frag_t, frag_j)
    _close(frag_t.vert_weight, frag_j.vert_weight, agree)
    _close(frag_t.vert_hit_length, frag_j.vert_hit_length, agree)
    _close(vt.get_silhouette(frag_t), jr.get_silhouette(frag_j), agree)
    _close(vt.to_white_background(frag_t, colors_t),
           jr.to_white_background(frag_j, colors_j), agree)
    np.testing.assert_array_equal(frag_t.valid_num.numpy(), np.asarray(frag_j.valid_num))


def test_quickstart_golden_bounds(quickstart):
    """``tests/test_renderer.py``'s golden bounds hold for the port."""
    frag_t, _, colors_t, _ = quickstart
    sil = vt.get_silhouette(frag_t).mean().item()
    wsum = frag_t.vert_weight.sum().item()
    assert 0.25 < sil < 0.45 and 25000 < wsum < 31000
    img = vt.to_white_background(frag_t, colors_t)
    assert img[0, 0, 0].min() > 0.999 and img[0, -1, -1].min() > 0.999
    assert img[0, 128, 128].mean() < 0.99


def test_two_camera_batch_with_fused_attrs_matches():
    """64x64, two cameras, colours fused through ``attrs=``: selections,
    weights and the attribute image against ``voge_tpu``."""
    gj = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6, as_obj=True)
    R, T = look_at_view_transform(dist=[6.0, 5.0], elev=[10.0, 25.0], azim=[70.0, -30.0])
    focal = np.array([[75.0, 75.0], [80.0, 70.0]], np.float32)
    principal = np.array([[32.0, 32.0], [30.0, 34.0]], np.float32)
    colors = (np.asarray(gj.verts) + 1) / 3
    # voge_tpu's CPU fallback truncates bins at max_point_per_bin (default
    # 200, exceeded at this zoom); a cap above P keeps both sides exact
    kw = dict(image_size=(64, 64), max_assign=20, max_point_per_bin=1000)
    frag_j = jr.render_pipeline(gj.verts, gj.sigmas, R, T, jnp.asarray(focal),
                                jnp.asarray(principal), attrs=jnp.asarray(colors), **kw)
    t = lambda x: torch.as_tensor(np.array(x))
    frag_t = vt.render_pipeline(t(gj.verts), t(gj.sigmas), t(R), t(T), t(focal),
                                t(principal), attrs=t(colors), **kw)
    assert frag_t.attr_img.shape == (2, 64, 64, 3)
    assert int(frag_t.overflow_points) == 0 == int(frag_j.overflow_points)
    agree = _agree(frag_t, frag_j)
    assert (frag_t.vert_index[1][frag_t.vert_index[1] >= 0] >= 866).all()
    _close(frag_t.vert_weight, frag_j.vert_weight, agree)
    _close(frag_t.attr_img, frag_j.attr_img, agree)
    # the fused image equals the attribute merge of the same fragments
    torch.testing.assert_close(frag_t.attr_img, vt.interpolate_attr(frag_t, t(colors)),
                               rtol=0, atol=1e-6)
    # a precomputed camera context renders the same fragments
    ctx = vt.precompute_camera_ctx(t(R), t(T), t(focal), t(principal), (64, 64))
    frag_c = vt.render_pipeline(t(gj.verts), t(gj.sigmas), t(R), t(T), t(focal),
                                t(principal), cam_ctx=ctx, **kw)
    assert torch.equal(frag_c.vert_index, frag_t.vert_index)
    assert torch.equal(frag_c.vert_weight, frag_t.vert_weight)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _fitting_scene(B):
    """~300 cuboid Gaussians, one or two cameras at 64x64, colours."""
    gj = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 300, percentage=0.6, as_obj=True)
    R, T = look_at_view_transform(dist=[6.0, 5.0][:B], elev=[10.0, 25.0][:B],
                                  azim=[70.0, -30.0][:B])
    focal = np.array([[75.0, 75.0], [80.0, 70.0]][:B], np.float32)
    principal = np.array([[32.0, 32.0], [30.0, 34.0]][:B], np.float32)
    verts, sigmas = np.array(gj.verts), np.array(gj.sigmas)
    return verts, sigmas, ((verts + 1) / 3).astype(np.float32), np.array(R), np.array(T), focal, principal


# voge_tpu's CPU fallback truncates bins at max_point_per_bin (default 200,
# exceeded at this zoom); a cap above P keeps both sides exact
_KW = dict(image_size=(64, 64), max_assign=20, max_point_per_bin=1000)


@pytest.mark.parametrize("B", [1, 2])
def test_fitting_step_gradients_match_voge_tpu(B):
    """The headline fitting step (``bench.py:88-98``'s loss) through
    ``render_pipeline(attrs=)``: loss and gradients of verts, sigmas,
    colours and both camera tensors (``camera_grad=True``) against
    ``jax.grad`` of the same ``voge_tpu`` loss.  Two cameras share the
    (N, 3) verts, so the batch gradient is reduced by autograd."""
    verts, sigmas, colors, R, T, focal, principal = _fitting_scene(B)

    def loss_j(v, s, c, R, T):
        f = jr.render_pipeline(v, s, R, T, jnp.asarray(focal), jnp.asarray(principal),
                               attrs=c, **_KW)
        return jnp.mean((f.attr_img - 0.5) ** 2) + jnp.mean(jr.get_silhouette(f) ** 2)

    args_j = [jnp.asarray(x) for x in (verts, sigmas, colors, R, T)]
    loss_ref, grads_ref = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3, 4))(*args_j)
    args = [torch.tensor(x, requires_grad=True) for x in (verts, sigmas, colors, R, T)]
    frag = vt.render_pipeline(args[0], args[1], args[3], args[4], torch.tensor(focal),
                              torch.tensor(principal), attrs=args[2], **_KW)
    assert int(frag.overflow_points) == 0
    loss = ((frag.attr_img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    for name, a, g in zip(("verts", "sigmas", "colors", "R", "T"), args, grads_ref):
        assert a.grad.shape == a.shape and torch.isfinite(a.grad).all(), name
        assert _rel(a.grad.numpy(), g) <= 1e-3, (name, _rel(a.grad.numpy(), g))


def test_white_background_gradients_through_gaussian_renderer():
    """``GaussianRenderer`` + ``to_white_background`` (the attribute merge
    K3f and its backward K4b) + a mean-squared loss: gradients of the
    scene's verts and sigmas and of the colours against ``jax.grad`` of
    ``voge_tpu``'s ``render_pipeline`` + ``to_white_background``."""
    verts, sigmas, colors, R, T, focal, principal = _fitting_scene(1)
    target = np.random.RandomState(2).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)

    def loss_j(v, s, c):
        f = jr.render_pipeline(v, s, jnp.asarray(R), jnp.asarray(T), jnp.asarray(focal),
                               jnp.asarray(principal), **_KW)
        return jnp.mean((jr.to_white_background(f, c) - target) ** 2)

    grads_ref = jax.grad(loss_j, argnums=(0, 1, 2))(
        *[jnp.asarray(x) for x in (verts, sigmas, colors)])
    g, colors_t = vt.scene_from_numpy(verts, sigmas, colors, device="cpu")
    colors_t.requires_grad_(True)
    cam = vt.cameras_from_numpy(R, T, focal, principal, ((64, 64),), device="cpu")
    renderer = vt.GaussianRenderer(cam, dict(image_size=64, max_point_per_bin=1000,
                                             batch_size=-1))
    for step in range(2):  # the second call reuses the cached camera context
        for x in (g.verts, g.sigmas, colors_t):
            x.grad = None
        img = vt.to_white_background(renderer(g), colors_t)
        ((img - torch.as_tensor(target)) ** 2).mean().backward()
        for name, a, ref in zip(("verts", "sigmas", "colors"),
                                (g.verts, g.sigmas, colors_t), grads_ref):
            assert _rel(a.grad.numpy(), ref) <= 1e-3, (name, step, _rel(a.grad.numpy(), ref))
    assert renderer._cam_ctx_key is not None


def test_precompute_camera_ctx_takes_voge_tpu_signature():
    """``precompute_camera_ctx(R, T, focal, principal, image_size, n_gauss,
    max_assign=...)`` as ``bench.py:83-86`` calls it: the render with the
    context equals the render without, its rays carry no graph, and the
    verts gradient is the same."""
    verts, sigmas, colors, R, T, focal, principal = _fitting_scene(2)
    t = torch.as_tensor
    ctx = vt.precompute_camera_ctx(t(R), t(T), t(focal), t(principal), (64, 64),
                                   verts.shape[0], max_assign=20, bin_size=None,
                                   max_point_per_bin=1000, device="cpu")
    assert not ctx.rays.requires_grad
    grads = []
    for c in (None, ctx):
        v = torch.tensor(verts, requires_grad=True)
        f = vt.render_pipeline(v, t(sigmas), t(R), t(T), t(focal), t(principal),
                               cam_ctx=c, attrs=t(colors), **_KW)
        f.attr_img.square().mean().backward()
        grads.append((f.vert_index, f.attr_img.detach(), v.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    assert torch.equal(grads[0][2], grads[1][2])


def test_camera_grad_false_skips_the_ray_gradient(monkeypatch):
    """``camera_grad=False``: the fine backward is asked for no ray gradient,
    so R receives only its camera-centre part, while T (which moves only the
    camera centre), verts and colours get the same gradients as with
    ``camera_grad=True``."""
    import voge_tpu_torch.ops.fine as tfine

    verts, sigmas, colors, R, T, focal, principal = _fitting_scene(1)
    seen = []
    real = tfine.fine_bwd
    monkeypatch.setattr(tfine, "fine_bwd", lambda *a, **k: seen.append(a[-1]) or real(*a, **k))
    out = {}
    for cg in (True, False):
        args = [torch.tensor(x, requires_grad=True) for x in (verts, colors, R, T)]
        f = vt.render_pipeline(args[0], torch.tensor(sigmas), args[2], args[3],
                               torch.tensor(focal), torch.tensor(principal),
                               attrs=args[1], camera_grad=cg, **_KW)
        ((f.attr_img - 0.5) ** 2).mean().backward()
        out[cg] = [a.grad for a in args]
    assert seen == [True, False]
    for i in (0, 1, 3):
        torch.testing.assert_close(out[False][i], out[True][i], rtol=1e-6, atol=1e-9)
    assert not torch.allclose(out[False][2], out[True][2])


def test_backward_repeats_to_the_bit():
    """Two backward runs of one render give the same bits."""
    verts, sigmas, colors, R, T, focal, principal = _fitting_scene(2)
    v = torch.tensor(verts, requires_grad=True)
    c = torch.tensor(colors, requires_grad=True)
    f = vt.render_pipeline(v, torch.tensor(sigmas), torch.tensor(R), torch.tensor(T),
                           torch.tensor(focal), torch.tensor(principal), attrs=c, **_KW)
    loss = f.attr_img.square().mean() + vt.get_silhouette(f).square().mean()
    g1 = torch.autograd.grad(loss, (v, c), retain_graph=True)
    g2 = torch.autograd.grad(loss, (v, c))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_paths_not_ported_raise():
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 100,
                                         percentage=0.6, as_obj=True, device="cpu")
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70, device="cpu")
    args = (g.verts, g.sigmas, R, T, torch.tensor([[30.0, 30.0]]), torch.tensor([[16.0, 16.0]]))
    for mppb in (None, -1):
        with pytest.raises(NotImplementedError, match="item 6"):
            vt.render_pipeline(*args, image_size=(32, 32), max_assign=129,
                               max_point_per_bin=mppb)
    # no coarse stage renders now, and culls nothing
    frag = vt.render_pipeline(*args, image_size=(32, 32), max_point_per_bin=-1)
    assert vt.get_overflow_points(frag) == 0 and (frag.valid_num > 0).any()


def test_golden_file_is_voge_tpu_output():
    """The golden file that ``chip_smoke.py`` holds the GPU render against
    is exactly what ``voge_tpu`` renders now."""
    spec = importlib.util.spec_from_file_location(
        "make_voge_tpu_golden", DATA / "make_voge_tpu_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.golden()
    saved = np.load(mod.PATH)
    assert sorted(saved.files) == sorted(fresh)
    np.testing.assert_array_equal(saved["vert_index"], fresh["vert_index"])
    for name in ("vert_weight", "attr_img"):
        np.testing.assert_allclose(saved[name], fresh[name], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["voge_tpu_golden_grad_1k_128.npz",
                                  "voge_tpu_golden_grad_10k_256.npz"])
def test_golden_grad_files_are_voge_tpu_output(name):
    """The golden gradient files that ``chip_smoke.py`` holds the GPU
    fitting step against are what ``voge_tpu`` computes now (same machine
    class: atol 1e-6 of each tensor's largest entry), and the port's CPU
    path meets them within the stated tolerances."""
    spec = importlib.util.spec_from_file_location(
        "make_voge_tpu_golden_grad", DATA / "make_voge_tpu_golden_grad.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n, hw, focal = mod.CASES[name]
    fresh = mod.golden(n, hw, focal)
    saved = np.load(DATA / name)
    assert sorted(saved.files) == sorted(fresh)
    for k in fresh:
        np.testing.assert_allclose(saved[k], fresh[k], rtol=1e-5,
                                   atol=1e-6 * np.abs(fresh[k]).max())
    if n > 1000:
        return  # the headline: the chip run holds the port to it
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), n, percentage=0.6,
                                         as_obj=True, device="cpu")
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70, device="cpu")
    f, pp = torch.tensor([[focal, focal]]), torch.tensor([[hw[1] / 2, hw[0] / 2]])
    colors = ((g.verts.detach() + 1) / 3).requires_grad_(True)
    ctx = vt.precompute_camera_ctx(R, T, f, pp, hw, g.verts.shape[0], max_assign=20)
    frag = vt.render_pipeline(g.verts, g.sigmas, R, T, f, pp, image_size=hw,
                              max_assign=20, cam_ctx=ctx, attrs=colors)
    loss = ((frag.attr_img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
    loss.backward()
    assert abs(loss.item() - float(saved["loss"])) <= 1e-5 * float(saved["loss"])
    for k, x in (("verts", g.verts.grad), ("sigmas", g.sigmas.grad), ("colors", colors.grad)):
        assert _rel(x.numpy(), saved["grad_" + k]) <= 1e-3, k


def test_settings_and_fragments_api():
    rs = vt.GaussianRenderSettings(batch_size=-1, image_size=128, principal=(64, 64))
    assert rs.image_size == (128, 128) and rs["max_assign"] == 20
    w = torch.ones(2, 4, 4, 3)
    f = vt.Fragments(w, torch.zeros(2, 4, 4, 3, dtype=torch.int32),
                     torch.ones(2, 4, 4, dtype=torch.int64), w)
    assert len(f) == 2 and f[0].vert_weight.shape == (4, 4, 3)
    assert f[0].unsqueeze().vert_weight.shape == (1, 4, 4, 3)
    assert set(f.to_dict()) == {"vert_weight", "vert_index", "valid_num", "vert_hit_length"}
    assert vt.get_overflow_points(f) == 0
