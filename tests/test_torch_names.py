"""The port's public names that mirror ``voge_tpu``'s, against ``voge_tpu`` on
the same numpy inputs (atol 1e-6 but where said): ``CameraOP``'s
``get_projection_transform``, ``cameras.world_to_view`` /
``view_to_screen`` / ``screen_to_ndc_scale`` (the twins of
``tests/test_cameras.py:45-64``, ``:112-115`` and ``tests/test_ops.py:
122-127``), ``rays.get_ray_camera_space`` and its re-export from
``aggregation``, ``converter.cuboid_mesh`` (equal arrays) and
``GaussianRenderer.device``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import voge_tpu
import voge_tpu.aggregation as jagg
import voge_tpu.cameras as jcam
from voge_tpu.converter import cuboid_mesh as j_cuboid_mesh
from voge_tpu.rays import camera_rays as j_camera_rays
import voge_tpu_torch as vt
from voge_tpu_torch.rays import camera_rays

torch.set_num_threads(2)


@pytest.mark.parametrize("focal,pp", [(300.0, ((128.0, 120.0),)),
                                      ([[300.0, 280.0], [50.0, 60.0]], [[128.0, 120.0], [5.0, 7.5]]),
                                      ([150.0, 75.0], [[64.0, 64.0], [32.0, 16.0]])])
def test_get_projection_transform_matches(focal, pp):
    want = np.asarray(voge_tpu.CameraOP.get_projection_transform(focal, pp))
    got = vt.CameraOP.get_projection_transform(focal, pp, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the calibration maps (x, y, z, 1) to (fx x/z + px, fy y/z + py, 1/z)
    x = torch.tensor([[0.5, -0.2, 2.0, 1.0]])
    out = x @ got[0]
    proj = out / out[..., -1:]
    f0 = got[0, 0, 0].item()
    assert abs(proj[0, 0].item() - (f0 * 0.25 + got[0, 2, 0].item())) < 1e-4
    assert abs(proj[0, 2].item() - 0.5) < 1e-6


def test_world_to_view_and_view_to_screen_match():
    R, T = jcam.look_at_view_transform(dist=[4.0, 5.0], elev=[23.0, 15.0], azim=[77.0, 40.0])
    R, T = np.asarray(R), np.asarray(T)
    pts = np.random.RandomState(0).uniform(-1, 1, (2, 7, 3)).astype(np.float32)
    focal = np.array([[60.0, 60.0], [300.0, 280.0]], np.float32)
    pp = np.array([[24.0, 16.0], [128.0, 120.0]], np.float32)
    jv = np.asarray(jcam.world_to_view(jnp.asarray(pts), R, T))
    tv = vt.cameras.world_to_view(torch.tensor(pts), torch.tensor(R), torch.tensor(T))
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-6)
    js = np.asarray(jcam.view_to_screen(jnp.asarray(jv), focal, pp))
    ts = vt.cameras.view_to_screen(tv, torch.tensor(focal), torch.tensor(pp))
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=1e-5)
    # the look-at point projects onto the optical axis: view (0, 0, dist)
    at = vt.cameras.world_to_view(torch.zeros((2, 1, 3)), torch.tensor(R), torch.tensor(T))
    np.testing.assert_allclose(at[:, 0].numpy(), [[0, 0, 4.0], [0, 0, 5.0]], atol=1e-5)
    for hw in ((32, 48), (256, 672)):
        assert vt.cameras.screen_to_ndc_scale(hw) == jcam.screen_to_ndc_scale(hw) == min(hw)


def test_projection_lies_on_the_pixel_ray():
    """A world point projected to pixel (u, v) lies on the ray the port
    generates through (u, v) (``tests/test_cameras.py:53-64``)."""
    H, W = 32, 48
    R, T = vt.look_at_view_transform(dist=5.0, elev=15.0, azim=40.0, device="cpu")
    focal, pp = torch.tensor([[60.0, 60.0]]), torch.tensor([[W / 2, H / 2]])
    pts = torch.tensor([[[0.3, -0.2, 0.1], [0.0, 0.0, 0.0], [-0.4, 0.3, -0.2]]])
    scr = vt.cameras.view_to_screen(vt.cameras.world_to_view(pts, R, T), focal, pp)
    dirs, origins = camera_rays(R, T, focal, pp, (H, W))
    rd, ro = j_camera_rays(*(jnp.asarray(x.numpy()) for x in (R, T, focal, pp)), (H, W))
    np.testing.assert_allclose(dirs.numpy(), np.asarray(rd), atol=1e-6)
    for n in range(3):
        u, v = scr[0, n, 0].item(), scr[0, n, 1].item()
        j, i = int(u - 0.5), int(v - 0.5)
        to_pt = pts[0, n] - origins[0]
        cos = (to_pt / to_pt.norm()) @ dirs[0, i, j]
        assert cos.item() > 0.999


@pytest.mark.parametrize("size,pp,focal", [((4, 5), (2.0, 2.5), 10.0),
                                           ((16, 12), (7.5, 5.5), [30.0, 20.0])])
def test_get_ray_camera_space_matches(size, pp, focal):
    want = np.asarray(jagg.get_ray_camera_space(size, pp, focal))
    got = vt.aggregation.get_ray_camera_space(size, pp, focal, device="cpu")
    assert vt.aggregation.get_ray_camera_space is vt.rays.get_ray_camera_space
    assert tuple(got.shape) == size + (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,with_colors", [(50, False), (300, True)])
def test_cuboid_mesh_matches(n, with_colors):
    colors = np.arange(18, dtype=np.float64).reshape(6, 3) / 18 if with_colors else None
    want = j_cuboid_mesh((-1, 1), (-0.5, 0.5), (-0.3, 0.3), n, colors=colors)
    got = vt.converter.cuboid_mesh((-1, 1), (-0.5, 0.5), (-0.3, 0.3), n, colors=colors)
    assert len(got) == len(want) == (3 if with_colors else 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    verts, faces = got[:2]
    assert faces.min() == 0 and faces.max() == verts.shape[0] - 1


def test_renderer_device_is_the_cameras():
    cam = vt.PerspectiveCameras(focal_length=30.0, image_size=((8, 8),), device="cpu")
    renderer = vt.GaussianRenderer(cam, vt.GaussianRenderSettings(image_size=8))
    assert renderer.device == torch.device("cpu") == cam.device
    cam_m = vt.PerspectiveCameras(focal_length=30.0, device="meta")
    assert vt.GaussianRenderer(cam_m, {"image_size": 8}).device.type == "meta"


def test_parallel_exports_every_name_of_voge_tpu_parallel():
    """Every name ``voge_tpu.parallel`` exports (``voge_tpu/parallel/__init__.py:13-19``)
    has its counterpart in ``voge_tpu_torch.parallel``, a callable of the same
    kind with the keyword arguments ``voge_tpu``'s takes."""
    import inspect

    import voge_tpu.parallel as jpar

    names = [n for n in vars(jpar) if not n.startswith("_")
             and callable(getattr(jpar, n)) and getattr(jpar, n).__module__.startswith(
                 "voge_tpu.parallel")]
    assert {"DataParallelBatchifier", "interpolate_attr_sharded", "render_pipeline_sharded",
            "sample_features_sharded", "make_mesh", "Batchifier", "batchify"} <= set(names)
    for n in names:
        got, want = getattr(vt.parallel, n), getattr(jpar, n)
        assert inspect.isclass(got) == inspect.isclass(want), n
        params = set(inspect.signature(got).parameters)
        assert set(inspect.signature(want).parameters) <= params, n
