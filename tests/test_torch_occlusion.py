"""The occlusion fitting step (``bench.py:140-186``) against ``voge_tpu`` on
the CPU, at a small shape: the same two cuboids with 400 + 300 Gaussians
requested (604 kept), 160x160 at focal 120 (the full step's field of view),
K = 60, ``max_point_per_bin=200``.  That cap is above every bin's count (the
densest holds 175), so ``voge_tpu``'s CPU coarse stage truncates nothing
(overflow 0 on both sides), and its floor (4 x 200, clamped to the largest
viable 384) is above the capacity heuristic of ``_pick_m_max`` (256 here),
so the port's compacted rows take the ``m_min`` branch with the floor as the
larger term, as the full step's do (a spy says so).

Checks: selections equal but for knife-edge pixels (< 0.1%), weights and
the image within 1e-4 on agreeing pixels, the loss within 1e-5 and the
gradients of verts, sigmas and colours within 1e-3 normwise of ``jax.grad``,
two backward runs equal to the bit.  The golden file of the full step
(``tests/data/voge_tpu_golden_occlusion_400.npz``, which
``tests/test_torch_cuda_paths.py`` holds the card to) is regenerated and compared by a test marked ``slow``:
``voge_tpu``'s CPU chain takes ~14 GB and ~20 s for it.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import voge_tpu_torch as vt
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.converter import Cuboid
from voge_tpu_torch.ops import fine as tfine

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"
HW, FOCAL, MPPB = (160, 160), 120.0, 200


def _maker():
    name = "make_voge_tpu_golden_occlusion"
    spec = importlib.util.spec_from_file_location(name, DATA / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _port_step(verts, sigmas, colors, cams, hw, K, mppb):
    t = lambda x, grad=False: torch.tensor(np.asarray(x), requires_grad=grad)
    v, s, c = t(verts, True), t(sigmas, True), t(colors, True)
    tcams = tuple(t(x) for x in cams)
    ctx = vt.precompute_camera_ctx(*tcams, hw, v.shape[0], max_assign=K,
                                   max_point_per_bin=mppb, device="cpu")
    frag = vt.render_pipeline(v, s, *tcams, image_size=hw, max_assign=K,
                              max_point_per_bin=mppb, cam_ctx=ctx)
    img = vt.interpolate_attr(frag, c)
    loss = ((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
    grads = torch.autograd.grad(loss, (v, s, c), retain_graph=True)
    again = torch.autograd.grad(loss, (v, s, c))
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    return loss.item(), [g.numpy() for g in grads], frag, img


def test_occlusion_step_matches_voge_tpu(monkeypatch):
    m = _maker()
    verts, sigmas, colors = m.scene(Cuboid.cuboid_gauss, 400, 300)
    cams = m.cameras(look_at_view_transform, HW, FOCAL)
    j_loss, j_grads, j_frag = m.step(verts, sigmas, colors, cams, HW, m.K, MPPB)
    picks, floors = [], []
    orig_pick, orig_emit = tfine._pick_m_max, tfine.emit_supertile_candidates

    def pick(P_pad, bins, cc, m_min=0):
        out = orig_pick(P_pad, bins, cc, m_min)
        picks.append((P_pad, bins, cc, m_min, out))
        return out

    def emit(*a, **k):
        floors.append(a[9])
        return orig_emit(*a, **k)

    monkeypatch.setattr(tfine, "_pick_m_max", pick)
    monkeypatch.setattr(tfine, "emit_supertile_candidates", emit)
    loss, grads, frag, img = _port_step(verts, sigmas, colors, cams, HW, m.K, MPPB)
    # the m_min branch, with the floor as the larger term, set the rows' floor
    (P_pad, bins, cc, m_min, out), = picks
    heuristic = -(-max(256, 8 * P_pad // bins) // cc) * cc
    assert m_min == 4 * MPPB and out > heuristic
    assert floors == [out]
    assert int(frag.overflow_points) == 0 == int(j_frag.overflow_points)
    idx_j = np.asarray(j_frag.vert_index)
    assert (idx_j >= 0).sum(-1).max() > 20
    agree = (frag.vert_index.numpy() == idx_j).all(-1)
    assert 1.0 - agree.mean() < 1e-3
    np.testing.assert_allclose(frag.vert_weight.detach().numpy()[agree],
                               np.asarray(j_frag.vert_weight)[agree], rtol=0, atol=1e-4)
    assert abs(loss - j_loss) / abs(j_loss) < 1e-5
    for name, a, b in zip(("verts", "sigmas", "colors"), grads, j_grads):
        assert _rel(a, b) < 1e-3, name


def test_scene_is_the_bench_scene():
    """Both packages' ``cuboid_gauss`` give the occlusion scene's arrays (the
    card builds it with the port's): 6,778 Gaussians at full size."""
    m = _maker()
    a = m.scene(Cuboid.cuboid_gauss)
    b = m.scene(vt.converter.Cuboid.cuboid_gauss)
    assert a[0].shape == (6778, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.slow
def test_occlusion_golden_file_is_voge_tpu_output():
    """The golden file of the full step is what ``voge_tpu`` computes now
    (atol 1e-6 of each tensor's largest entry; the digests exactly)."""
    m = _maker()
    fresh = m.golden()
    saved = np.load(m.PATH)
    assert sorted(saved.files) == sorted(fresh)
    assert int(fresh["overflow"]) == 0 and fresh["valid_hist"][-1] > 0
    for k, v in fresh.items():
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            np.testing.assert_array_equal(saved[k], v)
        else:
            np.testing.assert_allclose(saved[k], v, rtol=0, atol=1e-6 * np.abs(v).max())
