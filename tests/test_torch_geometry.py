"""Geometry of the port against ``voge_tpu`` on the same numpy inputs:
cameras (atol 1e-6), rays (atol 1e-6), the cuboid scene (byte-identical),
expend_sigma and the erf compositing (atol 1e-6), the index helpers of
``utils`` (exactly; ``rotation_theta`` atol 1e-6), and the rule that what
the port creates lies on the card unless the caller names the CPU."""
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
    Rt, Tt = vt.look_at_view_transform(**VIEWS, device="cpu")
    np.testing.assert_allclose(Rt.numpy(), R, rtol=0, atol=1e-6)
    np.testing.assert_allclose(Tt.numpy(), T, rtol=0, atol=1e-6)


def test_camera_centers_and_batched_params_match():
    R, T, focal, principal = _cameras()
    jc = jcam.PerspectiveCameras(focal_length=focal, principal_point=principal, R=R, T=T)
    tc = vt.cameras_from_numpy(R, T, focal, principal, ((256, 256),), device="cpu")
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
    gt = TCuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), n, percentage=0.6, as_obj=True,
                              device="cpu")
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


def test_index_helpers_match_voge_tpu():
    """``ind_sel`` / ``ind_fill`` / ``inverse_cumsum`` / ``rotation_theta``
    on the cases of ``tests/test_utils.py``."""
    import voge_tpu.utils as jutils
    import voge_tpu_torch.utils as tutils

    rng = np.random.RandomState(0)
    t, j = torch.as_tensor, jnp.asarray
    for shape in ((1, 9, 4), (5, 9, 4, 2)):
        target = rng.uniform(size=shape).astype(np.float32)
        ind = rng.randint(0, 9, size=(5, 3)).astype(np.int64)
        got = tutils.ind_sel(t(target), t(ind), dim=1).numpy()
        np.testing.assert_array_equal(got, np.asarray(jutils.ind_sel(j(target), j(ind), dim=1)))
    target = np.zeros((4, 9, 3), np.float32)
    # distinct indices per row: a scatter with duplicates keeps either value
    ind = np.stack([rng.permutation(9)[:5] for _ in range(4)]).astype(np.int64)
    src = rng.uniform(size=(4, 5, 3)).astype(np.float32)
    got = tutils.ind_fill(t(target), t(ind), t(src), dim=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jutils.ind_fill(j(target), j(ind), j(src), dim=1)))
    target = np.zeros((2, 7), np.float32)
    ind = rng.randint(0, 7, size=(2, 3)).astype(np.int64)
    got = tutils.ind_fill(t(target), t(ind), 1, dim=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jutils.ind_fill(j(target), j(ind), 1, dim=1)))
    assert (target == 0).all()                      # the input is left as it was
    x = rng.uniform(size=(3, 5, 4)).astype(np.float32)
    for dim in (0, 1, 2):
        np.testing.assert_allclose(tutils.inverse_cumsum(t(x), dim).numpy(),
                                   np.asarray(jutils.inverse_cumsum(j(x), dim)),
                                   rtol=0, atol=1e-6)
    theta = rng.uniform(-np.pi, np.pi, size=(6,)).astype(np.float32)
    want = np.asarray(jutils.rotation_theta(j(theta)))
    for arg in (theta, theta.reshape(6, 1, 1)):
        got = tutils.rotation_theta(arg, device="cpu")
        assert got.shape == (6, 3, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert tutils.rotation_theta(0.5, device="cpu").shape == (1, 3, 3)
    assert tutils.rotation_theta(torch.tensor([0.5])).device.type == "cpu"  # a tensor keeps its device


def test_default_device_is_the_card(tmp_path, monkeypatch):
    """Every entry point that turns numpy arrays or lists into tensors
    resolves ``device=None`` to ``cuda``: the rule's one helper says so, and
    each entry point called without a device either returns CUDA tensors (on
    a machine with a card) or fails with PyTorch's CUDA error (here).  A
    tensor argument keeps its device."""
    import voge_tpu_torch.utils as tutils
    from voge_tpu_torch import checkpoint
    from voge_tpu_torch._device import DEFAULT_DEVICE, resolve_device
    from voge_tpu_torch.converter import converters, io as tio
    from voge_tpu_torch.models.pose import PoseHypothesisScorer, pose_matrices

    assert DEFAULT_DEVICE == torch.device("cuda")
    assert resolve_device() == torch.device("cuda")
    assert resolve_device(None, np.zeros(3), [1.0]) == torch.device("cuda")
    assert resolve_device("cpu", np.zeros(3)) == torch.device("cpu")
    assert resolve_device(None, np.zeros(3), torch.zeros(3)) == torch.device("cpu")

    verts = np.zeros((4, 3), np.float32)
    sig = np.ones((4,), np.float32)
    feats = np.ones((4, 2), np.float32)
    R, T, focal, principal = _cameras()
    scene_file = str(tmp_path / "scene.npz")
    off_file, goff_file = str(tmp_path / "m.off"), str(tmp_path / "s.goff")
    checkpoint.save_scene(scene_file, vt.GaussianMeshes(verts, sig, device="cpu"))
    tio.save_off(off_file, verts, np.zeros((1, 3), np.int64))
    tio.save_goff(goff_file, verts, sig)
    knn_points, knn = [], converters.knn_mean_dist
    monkeypatch.setattr(converters, "knn_mean_dist",
                        lambda points, *a: (knn_points.append(points), knn(points, *a))[1])
    calls = {
        "PerspectiveCameras": lambda: vt.PerspectiveCameras(focal_length=30.0).R,
        "look_at_view_transform": lambda: vt.look_at_view_transform(dist=3.0)[0],
        "look_at_rotation": lambda: vt.cameras.look_at_rotation(((0.0, 0.0, 3.0),)),
        "camera_position_from_spherical_angles":
            lambda: vt.cameras.camera_position_from_spherical_angles(3.0, 10.0, 20.0),
        "GaussianMeshes": lambda: vt.GaussianMeshes(verts, sig).verts,
        "GaussianMeshesNaive": lambda: vt.GaussianMeshesNaive(verts, sig).verts,
        "cuboid_gauss": lambda: TCuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 50,
                                                     as_obj=True).verts,
        "scene_from_numpy": lambda: vt.scene_from_numpy(verts, sig)[0].verts,
        "cameras_from_numpy": lambda: vt.cameras_from_numpy(R, T, focal, principal,
                                                            ((8, 8),)).R,
        "ShapeFitter": lambda: vt.ShapeFitter({"verts": verts}, {"sigmas": sig},
                                              image_size=(8, 8), focal=focal[0],
                                              principal=principal[0]).params["verts"],
        "fitter_from_numpy": lambda: vt.fitter_from_numpy(
            {"verts": verts}, {"sigmas": sig}, image_size=(8, 8), focal=focal[0],
            principal=principal[0]).params["verts"],
        "precompute_camera_ctx": lambda: vt.precompute_camera_ctx(R, T, focal, principal,
                                                                  (8, 8)).rays,
        "rotation_theta": lambda: tutils.rotation_theta(0.5),
        "PoseHypothesisScorer": lambda: PoseHypothesisScorer(
            verts, sig, feats, focal[0], principal[0], image_size=(8, 8)).verts,
        "scorer_from_numpy": lambda: vt.scorer_from_numpy(
            verts, sig, feats, focal[0], principal[0], image_size=(8, 8)).features,
        "pose_matrices": lambda: pose_matrices(3.0, 0.1, 0.2, 0.3)[0],
        "load_scene": lambda: checkpoint.load_scene(scene_file)[0].verts,
        "load_scene(naive)": lambda: checkpoint.load_scene(scene_file, naive=True)[0].verts,
        "io.to_torch": lambda: tio.to_torch(verts, sig)[1],
        "load_off(to_torch)": lambda: tio.load_off(off_file, to_torch=True)[0],
        "load_goff(to_torch)": lambda: tio.load_goff(goff_file, to_torch=True)[1],
        # the k-NN runs on the resolved device; the arrays come back as numpy
        "naive_point_cloud_converter": lambda: (
            converters.naive_point_cloud_converter(verts), knn_points[-1])[1],
        "to_gaussian_mesh": lambda: converters.to_gaussian_mesh(
            converters.fixed_pointcloud_converter, radius=0.01)(verts).verts,
    }
    for name, call in calls.items():
        try:
            out = call()
        except (AssertionError, RuntimeError) as e:
            assert "CUDA" in str(e) or "cuda" in str(e), (name, e)
        else:
            assert out.device.type == "cuda", name
    # a tensor argument keeps its device
    assert vt.PerspectiveCameras(R=torch.as_tensor(R)).device.type == "cpu"
    assert vt.GaussianMeshes(torch.as_tensor(verts), torch.as_tensor(sig)).verts.device.type == "cpu"
    assert vt.look_at_view_transform(dist=torch.tensor([3.0]))[0].device.type == "cpu"
    f = vt.ShapeFitter({"verts": torch.as_tensor(verts)}, {"sigmas": sig}, image_size=(8, 8),
                       focal=focal[0], principal=principal[0])
    assert f.device.type == "cpu" and f.fixed["sigmas"].device.type == "cpu"
