"""The headline fitting step at a batch of eight cameras (``bench.py:
324-361``) against ``voge_tpu`` on the CPU, at a small shape: the 1K cuboid
(866 Gaussians) seen by the bench's eight cameras (dist 6, elevations
``linspace(5, 25, 8)``, azimuths ``linspace(50, 90, 8)``) at 48x48, focal
56.25 (the bench's field of view), K = 20, ``max_point_per_bin=1000`` (above
every bin's count: ``voge_tpu``'s CPU coarse stage truncates nothing),
colours through ``attrs=``, the camera context precomputed.

Checks: selections equal but for knife-edge pixels (< 0.1%), weights and
the image within 1e-4, the loss within 1e-5 and the gradients of verts,
sigmas and colours within 1e-3 normwise of ``jax.grad`` at B = 8, two
backward runs equal to the bit; ``voge_tpu``'s B = 8 step equals the mean of
its eight one-camera steps (how the full-width golden file is made), and
that file (``tests/data/voge_tpu_golden_batch8_256.npz``, which
``tests/test_torch_cuda_paths.py`` holds the card to) is what ``voge_tpu`` computes now.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

import jax.numpy as jnp

import voge_tpu_torch as vt
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.converter import Cuboid

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"
HW, FOCAL, MPPB = (48, 48), 56.25, 1000


def _maker():
    name = "make_voge_tpu_golden_batch8"
    spec = importlib.util.spec_from_file_location(name, DATA / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _scene():
    g = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6, as_obj=True)
    verts, sigmas = np.asarray(g.verts), np.asarray(g.sigmas)
    return verts, sigmas, ((verts + 1) / 3).astype(np.float32)


def _voge_tpu_step(m, verts, sigmas, colors, cams):
    """voge_tpu's B = 8 loss, gradients and fragments at the small shape."""
    import jax

    from voge_tpu.renderer import get_silhouette, precompute_camera_ctx, render_pipeline

    R, T, f, pp = cams
    ctx = precompute_camera_ctx(R, T, f, pp, HW, verts.shape[0], max_assign=m.K,
                                max_point_per_bin=MPPB)

    def loss_fn(v, s, c):
        frag = render_pipeline(v, s, R, T, f, pp, image_size=HW, max_assign=m.K,
                               max_point_per_bin=MPPB, cam_ctx=ctx, attrs=c)
        return (jnp.mean((frag.attr_img - 0.5) ** 2)
                + jnp.mean(get_silhouette(frag) ** 2)), frag

    (loss, frag), grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(verts), jnp.asarray(sigmas), jnp.asarray(colors))
    return float(loss), [np.asarray(g) for g in grads], frag


def test_batch8_step_matches_voge_tpu():
    m = _maker()
    verts, sigmas, colors = _scene()
    cams = m.cameras(look_at_view_transform, m.B, HW, FOCAL)
    j_loss, j_grads, j_frag = _voge_tpu_step(m, verts, sigmas, colors, cams)
    t = lambda x, grad=False: torch.tensor(np.asarray(x), requires_grad=grad)
    v, s, c = t(verts, True), t(sigmas, True), t(colors, True)
    tcams = tuple(t(x) for x in cams)
    ctx = vt.precompute_camera_ctx(*tcams, HW, v.shape[0], max_assign=m.K, device="cpu")
    frag = vt.render_pipeline(v, s, *tcams, image_size=HW, max_assign=m.K,
                              max_point_per_bin=MPPB, cam_ctx=ctx, attrs=c)
    loss = ((frag.attr_img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
    grads = torch.autograd.grad(loss, (v, s, c), retain_graph=True)
    again = torch.autograd.grad(loss, (v, s, c))
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert frag.vert_index.shape == (8,) + HW + (m.K,)
    assert int(frag.overflow_points) == 0 == int(j_frag.overflow_points)
    idx_j = np.asarray(j_frag.vert_index)
    assert [(idx_j[b] >= 0).any() for b in range(8)] == [True] * 8
    agree = (frag.vert_index.numpy() == idx_j).all(-1)
    assert 1.0 - agree.mean() < 1e-3
    for a, b in ((frag.vert_weight, j_frag.vert_weight), (frag.attr_img, j_frag.attr_img)):
        np.testing.assert_allclose(a.detach().numpy()[agree], np.asarray(b)[agree],
                                   rtol=0, atol=1e-4)
    assert abs(loss.item() - j_loss) / abs(j_loss) < 1e-5
    for name, a, b in zip(("verts", "sigmas", "colors"), grads, j_grads):
        assert _rel(a.numpy(), b) < 1e-3, name


def test_batch8_is_the_mean_of_its_cameras():
    """``voge_tpu``'s B = 8 loss and gradients equal the mean of its eight
    one-camera steps (rtol 1e-5): the way the full-width file is made."""
    m = _maker()
    verts, sigmas, colors = _scene()
    cams = m.cameras(look_at_view_transform, m.B, HW, FOCAL)
    loss, grads, _ = m.step(verts, sigmas, colors, cams, HW, m.K)
    each = [m.step(verts, sigmas, colors, tuple(x[b:b + 1] for x in cams), HW, m.K)
            for b in range(m.B)]
    assert abs(np.mean([e[0] for e in each]) - loss) / loss < 1e-5
    for i in range(3):
        mean = np.mean([e[1][i] for e in each], axis=0)
        assert _rel(mean, grads[i]) < 1e-5


def test_batch8_golden_file_is_voge_tpu_output():
    """The full-width file is what ``voge_tpu`` computes now (atol 1e-6 of
    each tensor's largest entry; overflow and the digests exactly)."""
    m = _maker()
    fresh = m.golden()
    saved = np.load(m.PATH)
    assert sorted(saved.files) == sorted(fresh)
    assert int(fresh["overflow"]) == 0
    for k, v in fresh.items():
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            np.testing.assert_array_equal(saved[k], v)
        else:
            np.testing.assert_allclose(saved[k], v, rtol=0, atol=1e-6 * np.abs(v).max())
