"""Geometry of the port against ``voge_tpu`` on the same numpy inputs:
cameras (atol 1e-6), rays (atol 1e-6), the cuboid scene (byte-identical),
expend_sigma and the erf compositing (atol 1e-6)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import voge_tpu.aggregation as jagg
import voge_tpu.cameras as jcam
import voge_tpu.rays as jrays
from voge_tpu.converter import Cuboid as JCuboid
import voge_tpu_torch as vt
import voge_tpu_torch.aggregation as tagg
from voge_tpu_torch.converter import Cuboid as TCuboid
from voge_tpu_torch.rays import camera_rays

torch.set_num_threads(2)

VIEWS = dict(dist=[4.0, 6.0, 2.5], elev=[10.0, -30.0, 80.0], azim=[70.0, 0.0, -135.0])


def _cameras():
    R, T = jcam.look_at_view_transform(**VIEWS)
    focal = np.array([[300.0, 280.0], [150.0, 150.0], [60.0, 75.0]], np.float32)
    principal = np.array([[128.0, 128.0], [64.0, 40.0], [20.5, 31.0]], np.float32)
    return np.array(R), np.array(T), focal, principal


def test_look_at_view_transform_matches():
    R, T = _cameras()[:2]
    Rt, Tt = vt.look_at_view_transform(**VIEWS)
    np.testing.assert_allclose(Rt.numpy(), R, rtol=0, atol=1e-6)
    np.testing.assert_allclose(Tt.numpy(), T, rtol=0, atol=1e-6)


def test_camera_centers_and_batched_params_match():
    R, T, focal, principal = _cameras()
    jc = jcam.PerspectiveCameras(focal_length=focal, principal_point=principal, R=R, T=T)
    tc = vt.cameras_from_numpy(R, T, focal, principal, ((256, 256),))
    for a, b in zip(jc.batched_params(3), tc.batched_params(3)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(tc.get_camera_center().numpy(),
                               np.asarray(jc.get_camera_center()), rtol=0, atol=1e-6)
    assert not tc.in_ndc() and len(tc) == 3


@pytest.mark.parametrize("hw", [(48, 64), (33, 21)])
def test_camera_rays_match(hw):
    R, T, focal, principal = _cameras()
    rays_j, org_j = jrays.camera_rays(*(jnp.asarray(x) for x in (R, T, focal, principal)), hw)
    rays_t, org_t = camera_rays(*(torch.as_tensor(x) for x in (R, T, focal, principal)), hw)
    assert rays_t.shape == (3,) + hw + (3,)
    np.testing.assert_allclose(rays_t.numpy(), np.asarray(rays_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(org_t.numpy(), np.asarray(org_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [300, 1000, 10000])
def test_cuboid_is_byte_identical(n):
    colors = np.arange(18, dtype=np.float64).reshape(6, 3) / 18
    vj, sj, cj = JCuboid.cuboid_gauss((-1, 1), (-0.5, 1), (-1, 0.7), n,
                                      percentage=0.6, colors=colors)
    vt_, st_, ct_ = TCuboid.cuboid_gauss((-1, 1), (-0.5, 1), (-1, 0.7), n,
                                         percentage=0.6, colors=colors)
    for a, b in ((vj, vt_), (sj, st_), (cj, ct_)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    gj = JCuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), n, percentage=0.6, as_obj=True)
    gt = TCuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), n, percentage=0.6, as_obj=True)
    assert np.asarray(gj.verts).tobytes() == gt.verts.detach().numpy().tobytes()
    assert np.asarray(gj.sigmas).tobytes() == gt.sigmas.detach().numpy().tobytes()
    assert isinstance(gt, vt.GaussianMeshes) and gt.verts.requires_grad


@pytest.mark.parametrize("shape", [(7,), (7, 3), (7, 3, 3)])
def test_expend_sigma_matches(shape):
    s = np.random.RandomState(1).uniform(0.5, 2.0, size=shape).astype(np.float32)
    np.testing.assert_array_equal(tagg.expend_sigma(torch.as_tensor(s)).numpy(),
                                  np.asarray(jagg.expend_sigma(jnp.asarray(s))))


def test_compositing_math_matches():
    rng = np.random.RandomState(2)
    l = rng.uniform(3, 6, size=(5, 9, 20)).astype(np.float32)
    a = rng.uniform(0, 4.6, size=l.shape).astype(np.float32)
    d = rng.uniform(0, 100, size=l.shape).astype(np.float32)
    a[..., 15:] = 1e10   # empty slots
    l[..., 15:] = 1e10
    d[..., 15:] = 0.0
    want = np.asarray(jagg.weights_from_sel(jnp.asarray(l), jnp.asarray(a), jnp.asarray(d), 0.9))
    got = tagg.weights_from_sel(torch.as_tensor(l), torch.as_tensor(a), torch.as_tensor(d), 0.9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    idx = rng.randint(-1, 30, size=l.shape).astype(np.int32)
    attr = rng.normal(size=(30, 3)).astype(np.float32)
    valid = (idx >= 0).sum(-1)
    want = np.asarray(jagg.merge_final(jnp.asarray(attr), jnp.asarray(got.numpy()),
                                       jnp.asarray(idx), jnp.asarray(valid)))
    got_m = tagg.merge_final(torch.as_tensor(attr), got, torch.as_tensor(idx),
                             torch.as_tensor(valid))
    np.testing.assert_allclose(got_m.numpy(), want, rtol=0, atol=1e-6)
