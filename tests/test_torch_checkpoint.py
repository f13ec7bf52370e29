"""The port's checkpoint module: scene files round-trip exactly and cross
between the packages (the ``.npz`` keys are ``voge_tpu``'s); the train state
(``ShapeFitter``'s parameters and SGD momentum) round-trips so that a resumed
fit continues to the bit; a structure mismatch raises as
``tests/test_checkpoint.py`` expects of ``voge_tpu``."""
import numpy as np
import pytest
import torch

from voge_tpu import checkpoint as jckpt
from voge_tpu.meshes import GaussianMeshes as JGaussianMeshes
import voge_tpu_torch as vt
from voge_tpu_torch import checkpoint as tckpt

torch.set_num_threads(2)


def _scene(seed=0, sigma_shape=(3, 3)):
    rng = np.random.RandomState(seed)
    return (rng.rand(20, 3).astype(np.float32), rng.rand(20, *sigma_shape).astype(np.float32),
            rng.rand(20, 3).astype(np.float32))


@pytest.mark.parametrize("naive", [False, True])
def test_scene_roundtrip(tmp_path, naive):
    verts, sigmas, colors = _scene()
    if naive:
        g = vt.GaussianMeshesNaive(verts, sigmas, np.arange(20, dtype=np.float32), device="cpu")
    else:
        g = vt.GaussianMeshes(verts, sigmas, gradianted_args=[True, False, False], device="cpu")
    p = str(tmp_path / "scene.npz")
    tckpt.save_scene(p, g, colors=torch.as_tensor(colors))
    g2, extras = tckpt.load_scene(p, device="cpu")
    assert type(g2) is type(g) and g2.verts.device.type == "cpu"
    np.testing.assert_array_equal(g2.verts.detach().numpy(), verts)
    np.testing.assert_array_equal(g2.sigmas.detach().numpy(), sigmas)
    np.testing.assert_array_equal(extras["colors"], colors)
    if naive:
        np.testing.assert_array_equal(g2.radians.numpy(), np.arange(20, dtype=np.float32))
    else:
        assert g2.gradianted_args == [True, False, False] and g2.radians is None
        assert g2.verts.requires_grad and not g2.sigmas.requires_grad
        assert isinstance(tckpt.load_scene(p, naive=True, device="cpu")[0],
                          vt.GaussianMeshesNaive)


def test_scene_files_cross_between_the_packages(tmp_path):
    verts, sigmas, colors = _scene(1, ())
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_scene(pj, JGaussianMeshes(verts, sigmas, gradianted_args=[False, True, False]),
                     colors=colors)
    tckpt.save_scene(pt, vt.GaussianMeshes(verts, sigmas, gradianted_args=[False, True, False],
                                           device="cpu"), colors=colors)
    with np.load(pj) as zj, np.load(pt) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype
            np.testing.assert_array_equal(zj[k], zt[k])
    g, extras = tckpt.load_scene(pj, device="cpu")          # voge_tpu's file in the port
    np.testing.assert_array_equal(g.verts.numpy(), verts)
    assert g.gradianted_args == [False, True, False] and g.sigmas.requires_grad
    np.testing.assert_array_equal(extras["colors"], colors)
    gj, extras_j = jckpt.load_scene(pt)                     # the port's file in voge_tpu
    np.testing.assert_array_equal(np.asarray(gj.sigmas), sigmas)
    assert gj.gradianted_args == [False, True, False]
    np.testing.assert_array_equal(extras_j["colors"], colors)


def test_train_state_roundtrip_keeps_structure_and_types(tmp_path):
    rng = np.random.RandomState(2)
    state = ({"verts": torch.as_tensor(rng.rand(5, 3).astype(np.float32)),
              "colors": rng.rand(5, 3)}, [torch.arange(3), 0.5], 7)
    p = str(tmp_path / "state.npz")
    tckpt.save_train_state(p, state)
    back = tckpt.load_train_state(p, state)
    assert isinstance(back, tuple) and isinstance(back[1], list) and back[2] == 7
    assert isinstance(back[2], int) and back[1][1] == 0.5
    assert torch.equal(back[0]["verts"], state[0]["verts"]) and back[0]["verts"].dtype == torch.float32
    assert torch.equal(back[1][0], torch.arange(3))
    np.testing.assert_array_equal(back[0]["colors"], state[0]["colors"])


def test_train_state_structure_mismatch(tmp_path):
    p = str(tmp_path / "s.npz")
    tckpt.save_train_state(p, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.load_train_state(p, {"b": torch.ones(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.load_train_state(p, [torch.ones(3)])


def _fitter():
    v, f = vt.ico_sphere(1)
    verts, isig, _ = vt.naive_vertices_converter(v, f, percentage=0.5)
    colors = np.random.RandomState(3).uniform(0, 1, verts.shape).astype(np.float32)
    return vt.ShapeFitter({"verts": verts, "colors": colors}, {"sigmas": isig},
                          image_size=(24, 24), focal=23.0, principal=(12.0, 12.0),
                          max_assign=8, device="cpu")


@pytest.mark.parametrize("steps_before", [0, 2])
def test_shape_fitter_resumes_from_a_saved_train_state(tmp_path, steps_before):
    """Save after ``steps_before`` steps, load into a fresh fitter: the next
    two steps of both give equal losses and parameters, to the bit (before
    the first step the momentum is saved as zeros, which starts the trace at
    the first gradient as an absent buffer does)."""
    R, T = vt.look_at_view_transform(dist=[2.7, 3.0], elev=[0.0, 20.0], azim=[-30.0, 40.0],
                                     device="cpu")
    t_rgb, t_sil = torch.full((2, 24, 24, 3), 0.3), torch.zeros((2, 24, 24))
    a = _fitter()
    for _ in range(steps_before):
        a.step(R, T, t_rgb, t_sil)
    p = str(tmp_path / "fit.npz")
    tckpt.save_train_state(p, a.train_state())
    b = _fitter()
    b.load_train_state(tckpt.load_train_state(p, b.train_state()))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    for _ in range(2):
        assert a.step(R, T, t_rgb, t_sil) == b.step(R, T, t_rgb, t_sil)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    if steps_before:
        assert any(v.abs().max() > 0 for v in a.train_state()["momentum"].values())
    with pytest.raises(ValueError):
        b.load_train_state({"params": {"verts": a.params["verts"]}, "momentum": {}})
