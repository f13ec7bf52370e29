"""The two-stage public tracer of the port (``ops.rasterize_coarse`` then
``ops.ray_tracing_fine``) against ``voge_tpu``'s, on the CPU.

- ``overlap_mask``, ``compact_mask``, ``rasterize_coarse`` and
  ``convert_to_box`` against ``voge_tpu.ops.coarse`` (bool / int outputs:
  exactly; the box extents to 1e-6).
- ``fine_select_bins_plain`` (the plain version of K2's per-bin-list entry)
  against ``pallas_fine.fine_select_pallas`` in interpret mode, on the inputs
  of ``tests/test_pallas.py``: selections equal, len / act / dsd to 1e-5.
- ``ray_tracing_fine`` against ``voge_tpu.ops.fine.ray_tracing_fine``:
  selections equal but for ties, values to 1e-5 on agreeing pixels, and the
  gradients of mus, isigmas and rays against ``jax.grad`` to a normwise 1e-3
  (the port's chain rule runs around the residual ``mu - len r``, another
  rounding than ``voge_tpu``'s sum-then-combine form).
- ``ray_tracing_fine`` on ``rasterize_coarse``'s lists against the port's
  own ``ray_tracing`` (emission-compacted path) where no bin truncates.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voge_tpu.cameras import look_at_view_transform
from voge_tpu.ops import coarse as jcoarse
from voge_tpu.ops import fine as jfine
from voge_tpu.ops.pallas_fine import FEAT, fine_select_pallas
from voge_tpu.rays import camera_rays
from voge_tpu_torch import trace
from voge_tpu_torch import ops as tops
from voge_tpu_torch.ops import coarse as tcoarse
from voge_tpu_torch.ops import fine as tfine
from voge_tpu_torch.ops.cuda_fine import (
    _untile, fine_select_bins, fine_select_bins_plain,
)

torch.set_num_threads(2)

t = torch.as_tensor


def _scene(B=2, P=60, H=33, W=47, seed=5, scale=4.0):
    rng = np.random.RandomState(seed)
    mus = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32) * 0.8
    a = rng.uniform(-1, 1, size=(P, 3, 3)).astype(np.float32)
    isig = (np.einsum("pij,pkj->pik", a, a) + 2.0 * np.eye(3, dtype=np.float32)) * scale
    R, T = look_at_view_transform(dist=[4.0, 4.5][:B], elev=[10.0, 20.0][:B],
                                  azim=[30.0, 50.0][:B])
    focal = jnp.broadcast_to(jnp.asarray([[50.0, 50.0]]), (B, 2))
    principal = jnp.broadcast_to(jnp.asarray([[W / 2, H / 2]]), (B, 2))
    rays, origins = camera_rays(R, T, focal, principal, (H, W))
    pts = np.asarray(jnp.asarray(mus)[None] - origins[:, None, :])
    isig_b = np.broadcast_to(isig[None], (B, P, 3, 3)).copy()
    cams = [np.array(x, np.float32) for x in (R, T, focal, principal)]
    return cams, pts, isig_b, np.array(rays), (H, W)


def test_overlap_mask_and_lists_match_voge_tpu():
    cams, pts, isig, _, hw = _scene()
    j = lambda xs: [jnp.asarray(x) for x in xs]
    bs = 10
    want = np.asarray(jcoarse.overlap_mask(*j(cams), *j((pts, isig)), hw, 0.01, bs))
    got = tcoarse.overlap_mask(*map(t, cams), t(pts), t(isig), hw, 0.01, bs)
    assert got.dtype == torch.bool and want.sum() > 100
    np.testing.assert_array_equal(got.numpy(), want)

    B, BH, BW, P = want.shape
    flat = want.reshape(-1, P)
    base = np.repeat(np.arange(B, dtype=np.int32), BH * BW) * P
    for M in (P, 5):
        bp_j, cnt_j = jcoarse.compact_mask(jnp.asarray(flat), M, jnp.asarray(base))
        bp_t, cnt_t = tcoarse.compact_mask(t(flat), M, t(base))
        assert bp_t.dtype == torch.int32 and cnt_t.dtype == torch.int32
        np.testing.assert_array_equal(bp_t.numpy(), np.asarray(bp_j))
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    bp_t, _ = tcoarse.compact_mask(t(flat), 7)
    np.testing.assert_array_equal(bp_t.numpy(), np.asarray(jcoarse.compact_mask(jnp.asarray(flat), 7)[0]))


@pytest.mark.parametrize("M", [60, 6])
def test_rasterize_coarse_matches_voge_tpu(M):
    """Full lists (M = P) and a cap that truncates: the lowest ids stay and
    the counts stay exact."""
    cams, pts, isig, _, hw = _scene()
    j = lambda xs: [jnp.asarray(x) for x in xs]
    bp_j, cnt_j = jcoarse.rasterize_coarse(*j(cams), *j((pts, isig)), hw, 0.01, 10, M,
                                           return_counts=True)
    bp_t, cnt_t = tops.rasterize_coarse(*map(t, cams), t(pts), t(isig), hw, 0.01, 10, M,
                                        return_counts=True)
    np.testing.assert_array_equal(bp_t.numpy(), np.asarray(bp_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert (np.asarray(cnt_j) > M).any() == (M == 6)
    only = tops.rasterize_coarse(*map(t, cams), t(pts), t(isig), hw, 0.01, 10, M)
    assert torch.equal(only, bp_t)


def test_convert_to_box_matches_voge_tpu():
    rng = np.random.RandomState(3)
    B, N = 2, 9
    a = rng.uniform(-1, 1, size=(B, N, 3, 3)).astype(np.float32)
    isig = np.einsum("bpij,bpkj->bpik", a, a) + 2.0 * np.eye(3, dtype=np.float32)
    z = rng.uniform(0.1, 2.0, size=(B, N)).astype(np.float32)
    mat = rng.uniform(-2, 2, size=(B, 4, 4)).astype(np.float32)
    # a symmetric positive 2x2 block keeps the square root real
    mat[:, :2, :2] = np.eye(2) * 1.5 + 0.1
    want = np.asarray(jcoarse.convert_to_box(jnp.asarray(isig), 0.01, jnp.asarray(z),
                                             jnp.asarray(mat)))
    got = tcoarse.convert_to_box(t(isig), 0.01, t(z), t(mat)).numpy()
    assert got.shape == (B, N, 2) and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _pallas_inputs(rng, nb=3, R=16, M=256, P=40):
    """``tests/test_pallas.py::_random_inputs``: ray features (nb, R, 16),
    candidate feature planes (nb, 16, M) and labels (nb, 1, M), a fifth of
    them -1."""
    rays = rng.normal(size=(nb, R, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    rf = np.zeros((nb, R, FEAT), np.float32)
    rf[:, :, 0:3] = rays
    rf[:, :, 3:12] = (rays[:, :, :, None] * rays[:, :, None, :]).reshape(nb, R, 9)
    mus = rng.uniform(-1, 1, size=(nb, M, 3)).astype(np.float32)
    a = rng.uniform(-1, 1, size=(nb, M, 3, 3)).astype(np.float32)
    lam = np.einsum("nmij,nmkj->nmik", a, a) + 2 * np.eye(3, dtype=np.float32)
    A = np.einsum("nmji,nmj->nmi", lam, mus)
    cf = np.zeros((nb, FEAT, M), np.float32)
    cf[:, 0:3] = A.transpose(0, 2, 1)
    cf[:, 3] = np.einsum("nmi,nmi->nm", mus, A)
    cf[:, 4:13] = lam.reshape(nb, M, 9).transpose(0, 2, 1)
    cf[:, 13:16] = mus.transpose(0, 2, 1)
    idx = rng.randint(0, P, size=(nb, M)).astype(np.int32)
    idx[rng.rand(nb, M) < 0.2] = -1
    return rays, rf, cf, idx


def _as_bins(rays, cf, labels, side):
    """The Pallas kernel's per-bin inputs as the port's: one image row of
    ``nb`` bins of ``side`` x ``side`` pixels, a table with one row per
    (bin, candidate), and lists of those rows (-1 where the label is)."""
    nb, R, _ = rays.shape
    M = cf.shape[2]
    img = _untile(t(rays), 1, side, side * nb, side, side).contiguous()
    table = t(np.ascontiguousarray(cf.transpose(0, 2, 1))).reshape(nb * M, FEAT)
    rows = np.arange(nb * M, dtype=np.int32).reshape(nb, M)
    lists = np.where(labels >= 0, rows, -1).astype(np.int32).reshape(1, 1, nb, M)
    return img, table, t(lists)


def _from_bins(out, labels, side):
    """The port's outputs back in the Pallas layout (nb, R, K), ids mapped
    to the candidates' labels."""
    nb, M = labels.shape
    tiles = [np.asarray(x.reshape(side, nb, side, -1).permute(1, 0, 2, 3)
                        .reshape(nb, side * side, -1)) for x in out]
    idx = tiles[0]
    lab = np.where(idx >= 0, labels.reshape(-1)[np.maximum(idx, 0)], -1)
    return [lab] + tiles[1:]


@pytest.mark.parametrize("K", [6, 40])
def test_select_bins_plain_matches_pallas(K):
    """K = 6 is the Pallas kernel's unrolled regime, K = 40 its loop."""
    rays, rf, cf, labels = _pallas_inputs(np.random.RandomState(0))
    want = fine_select_pallas(jnp.asarray(rf), jnp.asarray(cf), jnp.asarray(labels[:, None, :]),
                              4.0, K, ray_chunk=8, interpret=True)
    img, table, lists = _as_bins(rays, cf, labels, 4)
    with trace.tracing():
        got = _from_bins(fine_select_bins(img, table, lists, 4.0, K, 4), labels, 4)
    assert trace.counts().get("launch.fine_select_bins", 0) == 0   # CPU: the plain version
    assert (got[0] >= 0).sum() > 50
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def test_select_bins_plain_empty_and_full_lists():
    rays, rf, cf, labels = _pallas_inputs(np.random.RandomState(1), nb=2, R=16, M=128)
    labels[0] = -1                                  # bin 0: no candidate at all
    K = 4
    img, table, lists = _as_bins(rays, cf, labels, 4)
    out = _from_bins(fine_select_bins_plain(img, table, lists, 4.0, K, 4), labels, 4)
    assert (out[0][0] == -1).all() and (out[1][0] == 1e10).all()
    assert (out[2][0] == 1e10).all() and (out[3][0] == 0).all()
    want = fine_select_pallas(jnp.asarray(rf), jnp.asarray(cf), jnp.asarray(labels[:, None, :]),
                              1e9, K, ray_chunk=8, interpret=True)
    full = _from_bins(fine_select_bins_plain(img, table, lists, 1e9, K, 4), labels, 4)
    # a huge threshold: every listed candidate passes
    assert (full[0][1] >= 0).sum() == min(int((labels[1] >= 0).sum()), K) * 16
    np.testing.assert_array_equal(full[0], np.asarray(want[0]))
    # fewer list entries than K: the rest are fill values
    few = fine_select_bins_plain(img, table, lists[..., :2].contiguous(), 1e9, K, 4)
    assert few[0].shape[-1] == K and (few[0][..., 2:] == -1).all()


def _fine_case():
    cams, pts, isig, rays, hw = _scene(scale=2.0)
    B, P = pts.shape[:2]
    bp = tops.rasterize_coarse(*map(t, cams), t(pts), t(isig), hw, 0.01, 10, P)
    return pts.reshape(-1, 3), isig.reshape(-1, 3, 3), rays, bp.numpy(), hw


def _agree(idx_t, idx_j):
    agree = (idx_t == idx_j).all(-1)
    assert agree.mean() > 0.999, f"selections differ on {1 - agree.mean():.4f} of the pixels"
    return agree


def test_ray_tracing_fine_matches_voge_tpu():
    mus, isig, rays, bp, hw = _fine_case()
    K = 8
    want = [np.asarray(x) for x in jfine.ray_tracing_fine(
        jnp.asarray(mus), jnp.asarray(isig), jnp.asarray(rays), jnp.asarray(bp), 0.01, 10, K)]
    got = [x.numpy() for x in tops.ray_tracing_fine(t(mus), t(isig), t(rays), t(bp), 0.01, 10, K)]
    assert got[0].dtype == np.int32 and got[0].shape == rays.shape[:3] + (K,)
    assert (want[0] >= 0).sum() > 1000
    agree = _agree(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a[agree], b[agree], rtol=1e-5, atol=1e-5)
    # a whole-image bin given as (height, width), as voge_tpu's no-coarse
    # CPU path calls it
    P = mus.shape[0] // rays.shape[0]
    all_pts = np.stack([np.arange(P, dtype=np.int32) + b * P
                        for b in range(rays.shape[0])])[:, None, None, :]
    want = jfine.ray_tracing_fine(jnp.asarray(mus), jnp.asarray(isig), jnp.asarray(rays),
                                  jnp.asarray(all_pts), 0.01, hw, K)
    got = tops.ray_tracing_fine(t(mus), t(isig), t(rays), t(all_pts), 0.01, hw, K)
    agree = _agree(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy()[agree], np.asarray(want[1])[agree],
                               rtol=1e-5, atol=1e-5)


def test_ray_tracing_fine_gradients_match_jax_grad():
    mus, isig, rays, bp, hw = _fine_case()
    K = 8
    rng = np.random.RandomState(9)
    cots = [rng.normal(size=rays.shape[:3] + (K,)).astype(np.float32) for _ in range(3)]

    def jloss(m, s, r):
        idx, sl, sa, sd = jfine.ray_tracing_fine(m, s, r, jnp.asarray(bp), 0.01, 10, K)
        v = sl * cots[0] + sa * cots[1] + sd * cots[2]
        return jnp.sum(jnp.where(idx >= 0, v, 0.0))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(mus), jnp.asarray(isig),
                                              jnp.asarray(rays))
    leaves = [t(x).clone().requires_grad_(True) for x in (mus, isig, rays)]
    idx, sl, sa, sd = tops.ray_tracing_fine(*leaves, t(bp), 0.01, 10, K)
    v = sl * t(cots[0]) + sa * t(cots[1]) + sd * t(cots[2])
    loss = torch.where(idx >= 0, v, torch.zeros_like(v)).sum()
    got = torch.autograd.grad(loss, leaves, retain_graph=True)
    again = torch.autograd.grad(loss, leaves)
    for name, a, b, c in zip(("mus", "isigmas", "rays"), got, want, again):
        assert torch.equal(a, c), f"{name}: two backward runs differ"
        b = np.asarray(b, np.float64)
        err = np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)
        assert np.linalg.norm(b) > 0 and err <= 1e-3, (name, err)


def test_ray_tracing_fine_on_coarse_lists_equals_the_render_path():
    """Lists from ``rasterize_coarse`` hold every member of a bin, so the
    two-stage tracer selects what the emission-compacted ``ray_tracing``
    selects (overflow 0 on both sides)."""
    cams, pts, isig, rays, hw = _scene(scale=2.0)
    B, P = pts.shape[:2]
    K = 8
    bp, cnt = tops.rasterize_coarse(*map(t, cams), t(pts), t(isig), hw, 0.01, 10, P,
                                    return_counts=True)
    assert int(cnt.max()) <= P
    two = tops.ray_tracing_fine(t(pts).reshape(-1, 3), t(isig).reshape(-1, 3, 3), t(rays),
                                bp, 0.01, 10, K)
    sel, overflow = tops.ray_tracing(tuple(map(t, cams)), t(pts), t(isig), t(rays), hw, 0.01,
                                     K, bin_size=10)
    assert int(overflow) == 0
    assert torch.equal(two[0], sel[0])
    for a, b in zip(two[1:], sel[1:4]):
        assert torch.equal(a, b)


def test_ray_tracing_fine_checks_its_arguments():
    mus, isig, rays, bp, hw = _fine_case()
    with pytest.raises(AssertionError):
        tops.ray_tracing_fine(t(mus)[None], t(isig), t(rays), t(bp), 0.01, 10, 4)
    # K above 128 takes the dense select (voge_tpu's XLA route): its first
    # 128 slots are the K = 128 selection
    big = tops.ray_tracing_fine(t(mus), t(isig), t(rays), t(bp), 0.01, 10, 200)
    small = tops.ray_tracing_fine(t(mus), t(isig), t(rays), t(bp), 0.01, 10, 128)
    assert big[0].shape[-1] == 200
    assert torch.equal(big[0][..., :128], small[0])
    for a, b in zip(big[1:], small[1:]):
        torch.testing.assert_close(a[..., :128], b, rtol=1e-5, atol=1e-5)
    assert tfine.ray_tracing_fine is tops.ray_tracing_fine
