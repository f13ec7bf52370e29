"""Render-and-compare pose estimation against ``voge_tpu``'s on the same
numpy scene (``tests/test_models.py:20-57``'s: a 300-Gaussian cuboid, colours
as features, 64x64, K = 10), carried over by ``interop.scorer_from_numpy``.

Tolerances: pose matrices 1e-6 (float32 trigonometry); rendered feature maps
atol 1e-4 on pixels whose selections agree (< 0.1% may flip,
``tests/test_parity_full.py``); scores 1e-5 (means over 4,096 pixels of
values held to 1e-4); the pose gradient normwise 1e-3 (as every gradient of
a render against ``jax.grad``); the parameters after three Adam steps 1e-4
(``torch.optim.Adam`` and ``optax.adam`` both divide by ``sqrt(v_hat) +
1e-8``; a step is lr = 0.01 times a ratio near 1, so a 1e-3 gradient error
moves a parameter by far less than 1e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voge_tpu.converter import Cuboid
from voge_tpu.models import PoseHypothesisScorer as JScorer
from voge_tpu.models import pose as jpose
import voge_tpu_torch as vt
from voge_tpu_torch.models import pose as tpose

torch.set_num_threads(2)

TRUE = (4.0, 0.3, 0.9, 0.1)
INIT = (4.0, 0.25, 0.7, 0.0)


@pytest.fixture(scope="module")
def scorers():
    g = Cuboid.cuboid_gauss((-1, 1), (-0.5, 0.5), (-0.8, 0.8), 300, percentage=0.6, as_obj=True)
    verts, sigmas = np.asarray(g.verts), np.asarray(g.sigmas)
    colors = ((verts + 1) / 2.5).astype(np.float32)
    kw = dict(focal=80.0, principal=(32, 32), image_size=(64, 64), max_assign=10, chunk=2)
    js = JScorer(jnp.asarray(verts), jnp.asarray(sigmas), jnp.asarray(colors), **kw)
    ts = vt.scorer_from_numpy(np.asarray(js.verts), np.asarray(js.sigmas),
                              np.asarray(js.features), np.asarray(js.focal),
                              np.asarray(js.principal), image_size=(64, 64), max_assign=10,
                              chunk=2, device="cpu")
    Rj, Tj = jpose.pose_matrices(*[jnp.asarray([v]) for v in TRUE])
    target = np.asarray(js._render_features(Rj, Tj)[0][0])
    return js, ts, target


def test_pose_matrices_match_voge_tpu():
    rng = np.random.RandomState(0)
    d, e, a, th = (rng.uniform(lo, hi, 6).astype(np.float32)
                   for lo, hi in ((3, 5), (-0.5, 0.5), (-2, 2), (-0.3, 0.3)))
    for theta in (None, th):
        Rj, Tj = jpose.pose_matrices(jnp.asarray(d), jnp.asarray(e), jnp.asarray(a),
                                     None if theta is None else jnp.asarray(theta))
        R, T = tpose.pose_matrices(d, e, a, theta, device="cpu")
        assert R.shape == (6, 3, 3) and T.shape == (6, 3) and R.device.type == "cpu"
        np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-6)
        np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-6)
    Rj, _ = jpose.pose_matrices(jnp.asarray(d), jnp.asarray(e * 50), jnp.asarray(a * 50),
                                degrees=True)
    R, _ = tpose.pose_matrices(torch.as_tensor(d), torch.as_tensor(e * 50),
                               torch.as_tensor(a * 50), degrees=True)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_feature_similarity_matches_voge_tpu(masked):
    rng = np.random.RandomState(1)
    pred, target = (rng.normal(size=(3, 8, 9, 5)).astype(np.float32) for _ in range(2))
    pred[0, 0, 0] = 0.0                                    # a zero feature vector
    mask = (rng.rand(3, 8, 9) < 0.5).astype(np.float32) if masked else None
    want = jpose.feature_similarity(jnp.asarray(pred), jnp.asarray(target),
                                    None if mask is None else jnp.asarray(mask))
    got = tpose.feature_similarity(torch.as_tensor(pred), torch.as_tensor(target),
                                   None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_rendered_features_and_scores_match_voge_tpu(scorers):
    js, ts, target = scorers
    assert isinstance(ts, torch.nn.Module) and set(dict(ts.named_buffers())) == {
        "verts", "sigmas", "features", "focal", "principal"}
    # 5 hypotheses, chunks of 2; views in which voge_tpu's capacity-limited
    # coarse stage drops nothing (at azim 1.5 it drops 12 memberships and is
    # no exact reference; the port's rows are sized from the counts)
    azims = np.linspace(-0.6, 1.2, 5).astype(np.float32)
    poses = (np.full(5, 4.0, np.float32), np.full(5, 0.3, np.float32), azims,
             np.full(5, 0.1, np.float32))
    Rj, Tj = jpose.pose_matrices(*(jnp.asarray(p) for p in poses))
    R, T = tpose.pose_matrices(*poses, device="cpu")
    import voge_tpu.renderer as jr
    exact = jr.render_pipeline(js.verts, js.sigmas, Rj, Tj, jnp.broadcast_to(js.focal, (5, 2)),
                               jnp.broadcast_to(js.principal, (5, 2)), image_size=(64, 64),
                               max_assign=10)
    assert int(exact.overflow_points) == 0
    pred_j, sil_j = js._render_features(Rj[:2], Tj[:2])
    pred, sil = ts.render_features(R[:2], T[:2])
    close = np.abs(sil.numpy() - np.asarray(sil_j)) <= 1e-4
    assert 1.0 - close.mean() < 1e-3
    np.testing.assert_allclose(pred.numpy()[close], np.asarray(pred_j)[close], rtol=0, atol=1e-4)
    want = np.asarray(js.score(Rj, Tj, jnp.asarray(target)))
    got = ts.score(R, T, torch.as_tensor(target))
    assert got.shape == (5,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert abs(azims[int(got.argmax())] - TRUE[2]) < 0.31
    assert torch.equal(ts(R, T, torch.as_tensor(target)[None]), got)    # forward = score


def test_pose_gradient_matches_jax_grad(scorers):
    """The gradient of the similarity in (dist, elev, azim, theta): through
    the rays and the camera-centred means, no camera context."""
    js, ts, target = scorers

    def loss_j(p):
        R, T = jpose.pose_matrices(p[0][None], p[1][None], p[2][None], p[3][None])
        return -jpose.feature_similarity(js._render_features(R, T)[0], jnp.asarray(target)[None])[0]

    want = np.asarray(jax.grad(loss_j)(jnp.asarray(INIT, jnp.float32)))
    p = torch.tensor(INIT, requires_grad=True)
    R, T = tpose.pose_matrices(p[0][None], p[1][None], p[2][None], p[3][None])
    loss = -tpose.feature_similarity(ts.render_features(R, T)[0], torch.as_tensor(target)[None])[0]
    loss.backward()
    assert abs(loss.item() - float(loss_j(jnp.asarray(INIT, jnp.float32)))) <= 1e-5
    assert np.linalg.norm(p.grad.numpy() - want) <= 1e-3 * np.linalg.norm(want)


def test_three_refinement_steps_match_voge_tpu(scorers):
    js, ts, target = scorers
    pj, sj = jpose.refine_pose(js, jnp.asarray(target), INIT, steps=3, lr=0.01)
    pt, st = tpose.refine_pose(ts, torch.as_tensor(target), INIT, steps=3, lr=0.01)
    assert set(pt) == {"dist", "elev", "azim", "theta"}
    for k in pt:
        assert pt[k].shape == () and not pt[k].requires_grad
        assert abs(pt[k].item() - float(pj[k])) <= 1e-4, (k, pt[k].item(), float(pj[k]))
    assert abs(st - sj) <= 1e-5
    moved = [abs(pt[k].item() - v) for k, v in zip(("dist", "elev", "azim", "theta"), INIT)]
    assert max(moved) > 0.02                                # three steps of lr 0.01


def test_refinement_improves_the_score(scorers):
    _, ts, target = scorers
    t = torch.as_tensor(target)
    s0 = ts.score(*tpose.pose_matrices(*[[v] for v in INIT], device="cpu"), t)[0].item()
    params, s1 = tpose.refine_pose(ts, t, INIT, steps=12, lr=0.01)
    assert s1 > s0
    assert abs(params["azim"].item() - TRUE[2]) < abs(INIT[2] - TRUE[2])
