"""The port's forward render end to end against ``voge_tpu`` on the CPU
(where ``voge_tpu`` takes its XLA fallback, which computes the same function
when no bin overflows), fed the same scenes and cameras through
``voge_tpu_torch.interop``.

Tolerances (``tests/test_parity_full.py:22-49``): selections equal but for
knife-edge pixels, flipped pixels < 0.1%; weights, silhouettes and
composited images atol 1e-4 on agreeing pixels; ``overflow_points`` equal
(0 on both sides)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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
    g, colors_t = vt.scene_from_numpy(np.asarray(gj.verts), np.asarray(gj.sigmas), colors)
    cam_t = vt.cameras_from_numpy(np.array(R), np.array(T), focal, principal, ((256, 256),))
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


def test_render_with_grad_inputs_then_backward_raises():
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 300,
                                         percentage=0.6, as_obj=True)
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70)
    colors = torch.rand(g.verts.shape[0], 3, requires_grad=True)
    cam = vt.PerspectiveCameras(focal_length=75.0, principal_point=((32.0, 32.0),),
                                image_size=((64, 64),))
    frag = vt.GaussianRenderer(cam, dict(image_size=64, batch_size=-1))(g, R=R, T=T)
    assert g.verts.requires_grad and frag.vert_weight.requires_grad
    assert (frag.valid_num > 0).any()
    img = vt.to_white_background(frag, colors)
    with pytest.raises(NotImplementedError, match="_bwd_t_kernel"):
        vt.get_silhouette(frag).sum().backward()
    with pytest.raises(NotImplementedError):
        img.sum().backward()


def test_paths_not_ported_raise():
    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 100,
                                         percentage=0.6, as_obj=True)
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70)
    args = (g.verts, g.sigmas, R, T, torch.tensor([[30.0, 30.0]]), torch.tensor([[16.0, 16.0]]))
    with pytest.raises(NotImplementedError, match="item 8"):
        vt.render_pipeline(*args, image_size=(32, 32), max_point_per_bin=-1)
    with pytest.raises(NotImplementedError, match="item 8"):
        vt.render_pipeline(*args, image_size=(32, 32), max_assign=129)


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
