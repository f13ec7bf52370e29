"""Kernels K2 and K3 of the port against ``voge_tpu``'s Pallas kernels in
interpret mode, on the same emission-compacted candidate rows and rays:

- the plain select (``cuda_fine.fine_select_plain``) against
  ``pallas_fine2.fine_select_compact_pallas``, with fused weights
  (``agg_ow=0.9``) and a fused 8-channel attribute image;
- the plain weight fold (``cuda_fine_bwd.fold_weights_plain``) against
  ``pallas_fine2.fold_weights_pallas``;
- the plain fine backward (``cuda_fine_bwd.fine_bwd_plain``) against
  ``pallas_bwd.fine_bwd_compact_t_pallas``, fed the Pallas select's own
  outputs, with and without the attribute VJP, with and without rays: both
  return per-Gaussian rows;
- the per-Gaussian plain backward against the per-candidate-row sums of the
  same slots gathered back through the inverse emission map
  (``ops.fine.gather_back_rows``, the path K3 took before its rows became
  the Gaussians): equal within float32 sum order (rtol 1e-5, atol 1e-6 of
  each tensor's largest entry).

Tolerances (as in ``tests/test_parity_full.py:22-49``): selections equal but
for knife-edge pixels, flipped pixels < 0.1%; len / act / dsd rtol 1e-5, atol
1e-5 on agreeing pixels; weights and the attribute image atol 1e-4 on
agreeing pixels.  The fold: rtol 1e-4, atol 1e-5 (``tests/test_pallas.py``'s
fold test; ``torch.erf`` and ``voge_tpu``'s polynomial ``_erf32`` differ by
~1e-7).  Gradients: normwise relative error <= 1e-3 per tensor and the
elementwise envelope rtol 5e-3, atol 5e-4 of ``tests/test_pallas.py:548-550``
(f32 sums in another order; XLA's ``segment_sum`` order)."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import voge_tpu.ops.fine as F
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.ops import coarse as jcoarse
from voge_tpu.aggregation import weights_from_sel
from voge_tpu.ops.pallas_bwd import fine_bwd_compact_t_pallas
from voge_tpu.ops.pallas_fine2 import (
    fine_select_compact_pallas, fold_weights_pallas, prefix_visit_lists,
)
from voge_tpu.rays import camera_rays
from voge_tpu_torch.ops.cuda_fine import _supertile, fine_select_plain
from voge_tpu_torch.ops.cuda_fine_bwd import (
    _slot_coefs, _slot_grads, fine_bwd_plain, fold_weights_plain,
)

torch.set_num_threads(2)

B, H, W, P, CA, BS, M_MAX = 2, 36, 44, 60, 8, 10, 128
THR_ACT = -math.log(0.01 + 1e-10)
OW = 0.9


def _case():
    """Emission-compacted rows, feature table, rays and attributes of a
    random two-camera scene, as ``fine._rt_fine_compact_impl`` builds them."""
    rng = np.random.RandomState(5)
    mus_w = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32) * 0.8
    a = rng.uniform(-1, 1, size=(P, 3, 3)).astype(np.float32)
    isig = (np.einsum("pij,pkj->pik", a, a) + 2 * np.eye(3, dtype=np.float32)) * 4.0
    R, T = look_at_view_transform(dist=[4.0, 4.5], elev=[5.0, 20.0], azim=[10.0, 40.0])
    focal = jnp.broadcast_to(jnp.asarray([[60.0, 60.0]]), (B, 2))
    principal = jnp.broadcast_to(jnp.asarray([[W / 2, H / 2]]), (B, 2))
    rays, origins = camera_rays(R, T, focal, principal, (H, W))
    mus = jnp.asarray(mus_w)[None] - origins[:, None, :]
    isig_b = jnp.broadcast_to(jnp.asarray(isig)[None], (B, P, 3, 3))
    pos_c, bits_c, ids_c, counts_c, _ = jcoarse.emit_supertile_candidates(
        R, T, focal, principal, mus, isig_b, (H, W), 0.01, BS, M_MAX,
        _force="kernel")
    nb = pos_c.shape[0]
    gf = F._gauss_feature_planes_batched(mus, isig_b)                # (B, 16, P)
    attr = rng.normal(size=(B, CA, P)).astype(np.float32)
    planes = jnp.concatenate([gf, jnp.asarray(attr)], axis=1)        # (B, 24, P)
    rows = jnp.swapaxes(planes, 1, 2).reshape(B * P, 16 + CA)
    img_row = jnp.arange(nb)[:, None] // (nb // B)
    table = rows[(img_row * P + pos_c).reshape(-1)].reshape(nb, M_MAX, 16 + CA)
    return dict(rays=np.array(rays), table=np.array(table),
                bits=np.array(bits_c)[..., 0], ids=np.array(ids_c)[..., 0],
                counts=np.array(counts_c), pos=np.array(pos_c),
                attrs=np.swapaxes(attr, 1, 2).reshape(B * P, CA).copy(),
                feat=np.array(rows[:, :16]))


@pytest.fixture(scope="module")
def case():
    return _case()


BH, BW = (H - 1) // BS + 1, (W - 1) // BS + 1


def _unbin(x):
    """voge_tpu's grouped kernel layout (nb, R_pad, C) -> (B, H, W, C)."""
    return np.asarray(F.unbin_kern(jnp.asarray(x), B, BH, BW, H, W, BS, BS, True))


def _to_kern(x):
    """(B, H, W, C) -> voge_tpu's grouped kernel layout (nb, 4 * R_pad, C)
    (``_rays_features`` + ``_group_supertiles``), zero outside the image and
    in each bin's padding."""
    C = x.shape[-1]
    xp = np.zeros((B, BH * BS, BW * BS, C), np.float32)
    xp[:, :H, :W] = x
    xb = xp.reshape(B, BH, BS, BW, BS, C).transpose(0, 1, 3, 2, 4, 5)
    xb = xb.reshape(B * BH * BW, BS * BS, C)
    r_pad = -(-BS * BS // 8) * 8
    xb = np.concatenate([xb, np.zeros((xb.shape[0], r_pad - BS * BS, C), np.float32)], 1)
    return F._group_supertiles(jnp.asarray(xb), B, BH, BW)[0]


def _pallas(c, K, attrs=True, raw=False):
    rays_feat, _, _ = F._rays_features(jnp.asarray(c["rays"]), BH, BW, BS, BS)
    rf_k, _, _ = F._group_supertiles(rays_feat, B, BH, BW)
    counts = jnp.asarray(c["counts"])
    csel, cnts = prefix_visit_lists(counts, M_MAX, 128)
    table = c["table"] if attrs else c["table"][..., :16]
    out = fine_select_compact_pallas(
        jnp.swapaxes(rf_k, 1, 2), jnp.asarray(table),
        jnp.asarray(c["bits"])[..., None], jnp.asarray(c["ids"])[..., None],
        csel, cnts, THR_ACT, K, sub_bins=4, ray_chunk=rf_k.shape[1],
        cand_chunk=128, per_bin_cand=True, agg_ow=OW, n_attr=CA if attrs else 0,
        interpret=True, return_raw=raw)
    if raw:
        return out
    return [_unbin(x) for x in out[:5]] + [_unbin(jnp.swapaxes(out[5], 1, 2))]


def _port(c, K):
    t = torch.as_tensor
    out = fine_select_plain(t(c["rays"]), t(c["table"][..., :16].copy()), t(c["bits"]),
             t(c["ids"]), t(c["counts"]), THR_ACT, K, BS, OW, t(c["attrs"]))
    return [x.numpy() for x in out]


def _assert_close(got, want):
    idx, idx_ref = got[0], want[0]
    agree = (idx == idx_ref).all(-1)
    assert 1.0 - agree.mean() < 1e-3, 1.0 - agree.mean()
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g[agree], w[agree], rtol=1e-5, atol=1e-5)
    for g, w in zip(got[4:], want[4:]):
        np.testing.assert_allclose(g[agree], w[agree], rtol=0, atol=1e-4)


@pytest.mark.parametrize("K", [5, 20])
def test_plain_select_matches_pallas(case, K):
    want = _pallas(case, K)
    got = _port(case, K)
    assert got[0].shape == (B, H, W, K) and got[5].shape == (B, H, W, CA)
    assert (got[0] >= 0).sum(-1).max() == K      # some pixels fill all K slots
    assert (got[0] < 0).any()                     # and some stay empty
    _assert_close(got, want)


def _grad_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(want).max() > 0
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-3, rel
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("K,Kp", [(5, 8), (20, 24)])
def test_plain_fold_matches_pallas(K, Kp):
    """The weight fold on random selections with invalid slots (len / act
    1e10, dsd 0) against ``fold_weights_pallas`` on the transposed, padded
    buffers the select kernel emits."""
    rng = np.random.RandomState(21)
    nb, R = 3, 40
    l = rng.uniform(1, 9, (nb, R, K)).astype(np.float32)
    a = rng.uniform(0, 4, (nb, R, K)).astype(np.float32)
    d = rng.uniform(0.1, 50, (nb, R, K)).astype(np.float32)
    inv = rng.rand(nb, R, K) < 0.3
    l[inv], a[inv], d[inv] = 1e10, 1e10, 0.0
    gw = rng.normal(size=(nb, R, K)).astype(np.float32)
    w = np.array(weights_from_sel(jnp.asarray(l), jnp.asarray(a), jnp.asarray(d), OW))

    def t_pad(x, fill):
        x_t = np.swapaxes(x, 1, 2)
        return jnp.asarray(np.concatenate(
            [x_t, np.full((nb, Kp - K, R), fill, np.float32)], axis=1))

    want = fold_weights_pallas(t_pad(l, 1e10), t_pad(a, 1e10), t_pad(d, 0.0),
                               t_pad(w, 0.0), t_pad(gw, 0.0), OW, K, interpret=True)
    t = torch.as_tensor
    got = fold_weights_plain(t(l), t(a), t(d), t(w), t(gw), OW)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(x), 1, 2)[..., :K],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["both", "gauss"])
@pytest.mark.parametrize("with_attrs", [False, True])
def test_plain_fine_bwd_matches_pallas(case, with_attrs, mode):
    """K3's plain version against ``fine_bwd_compact_t_pallas`` (the
    transposed unified backward, ``_bwd_t_kernel``), both fed the Pallas
    select's outputs and the same random cotangents; both give one row per
    Gaussian."""
    K = 20
    sel, raw = _pallas(case, K, attrs=with_attrs, raw=True)
    rng = np.random.RandomState(8)
    cot = [rng.normal(size=(B, H, W, K)).astype(np.float32) for _ in range(4)]
    g_img = rng.normal(size=(B, H, W, CA)).astype(np.float32)
    Kp = raw[0].shape[1]
    t_pad = lambda x: jnp.pad(jnp.swapaxes(_to_kern(x), 1, 2), ((0, 0), (0, Kp - K), (0, 0)))
    rays_feat, _, _ = F._rays_features(jnp.asarray(case["rays"]), BH, BW, BS, BS)
    rf_k, _, _ = F._group_supertiles(rays_feat, B, BH, BW)
    table = case["table"] if with_attrs else case["table"][..., :16]
    kw = dict(n_attr=CA, g_img_t=jnp.swapaxes(_to_kern(g_img), 1, 2)) if with_attrs else {}
    gg, rb_t = fine_bwd_compact_t_pallas(
        jnp.swapaxes(rf_k, 1, 2), jnp.asarray(table), jnp.asarray(case["ids"])[..., None],
        jnp.asarray(case["counts"]), raw, tuple(t_pad(x) for x in cot), K=K,
        cand_chunk=128, dst=None, B=B, P_pad=P, agg_ow=OW, mode=mode,
        interpret=True, pos_c=jnp.asarray(case["pos"]), **kw)
    gg = np.swapaxes(np.asarray(gg), 1, 2)                        # (B, P, 16 + Ca)

    t = torch.as_tensor
    idx, l, a, d, w = (t(_unbin(x).copy()) for x in sel[:5])
    assert (idx >= 0).any()
    rows, g_rays = fine_bwd_plain(
        t(case["rays"]), t(case["feat"]), idx, l, a, d, w, *(t(x) for x in cot), OW,
        t(case["attrs"]) if with_attrs else None, t(g_img) if with_attrs else None,
        want_rays=mode == "both")
    C = 12 + (CA if with_attrs else 0)
    assert rows.shape == (B * P, C)
    summed = rows.numpy().reshape(B, P, C)
    _grad_close(summed[..., 0:3], gg[..., 0:3])
    _grad_close(summed[..., 3:12], gg[..., 3:12])
    if with_attrs:
        _grad_close(summed[..., 12:], gg[..., 16:16 + CA])
    if mode == "both":
        want_rays = _unbin(jnp.swapaxes(rb_t, 1, 2)[..., 0:3])
        _grad_close(g_rays.numpy(), want_rays)
    else:
        assert g_rays is None and rb_t is None


def _per_row_sums(rays, table_c, ids_c, idx, coefs, w, g_img):
    """The slots' gradients summed per candidate row (nb, M, 12 + d), each
    slot matched to its supertile's row by id: the contract of K3 before its
    rows became the Gaussians (rows ascending by id, padding last)."""
    nb, M = ids_c.shape
    st = lambda x, fill=0: _supertile(x, BS, fill)
    idx_s = st(idx, -1)
    R, K = idx_s.shape[1], idx_s.shape[2]
    key = torch.where(ids_c >= 0, ids_c, 2 ** 31 - 1)
    rank = torch.searchsorted(key, idx_s.reshape(nb, R * K)).reshape(nb, R, K)
    rank_c = rank.clamp(max=M - 1)
    found = (idx_s >= 0) & (key.gather(1, rank_c.reshape(nb, -1)).reshape(nb, R, K) == idx_s)
    row = torch.arange(nb)[:, None, None] * M + rank_c
    flat = torch.where(found, row, nb * M).reshape(-1)
    feats = torch.cat([table_c.reshape(nb * M, 16), table_c.new_zeros((1, 16))])[flat]
    g_mu, g_L, _ = _slot_grads(feats.reshape(nb, R, K, 16), st(rays)[:, :, None, :],
                               *(st(c)[..., None] for c in coefs), False)
    cols = [g_mu, g_L, st(w)[..., None] * st(g_img)[:, :, None, :]]
    vals = torch.cat(cols, dim=-1).reshape(-1, 12 + g_img.shape[-1])
    rows = vals.new_zeros((nb * M + 1, vals.shape[1])).index_add_(0, flat, vals)
    return rows[:nb * M]


def test_per_gaussian_rows_equal_per_row_sums_gathered_back():
    """The per-Gaussian plain backward (attributes, B = 2) against the
    per-candidate-row sums of the same slots gathered back through the
    inverse emission map of the port's own coarse stage."""
    import voge_tpu_torch as vt
    from voge_tpu_torch.ops import coarse as tcoarse, fine as tfine
    from voge_tpu_torch.rays import camera_rays as t_camera_rays

    rng = np.random.RandomState(5)
    mus_w = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32) * 0.8
    a = rng.uniform(-1, 1, size=(P, 3, 3)).astype(np.float32)
    isig = (np.einsum("pij,pkj->pik", a, a) + 2 * np.eye(3, dtype=np.float32)) * 4.0
    R, T = vt.look_at_view_transform(dist=[4.0, 4.5], elev=[5.0, 20.0], azim=[10.0, 40.0],
                                     device="cpu")
    focal = torch.full((B, 2), 60.0)
    principal = torch.tensor([[W / 2, H / 2]] * B)
    rays, origins = t_camera_rays(R, T, focal, principal, (H, W))
    points = torch.tensor(mus_w)[None] - origins[:, None, :]
    isg = torch.tensor(isig)[None].expand(B, P, 3, 3).contiguous()
    pos_c, bits_c, ids_c, counts_c, _, dst = tcoarse.emit_supertile_candidates(
        R, T, focal, principal, points, isg, (H, W), 0.01, BS, 0, row_align=8,
        return_dst=True)
    table = tfine.feature_table(points, isg)
    table_c = tfine.candidate_table(points, isg, pos_c)
    attrs = torch.tensor(rng.normal(size=(B * P, CA)).astype(np.float32))
    K = 20
    sel = fine_select_plain(rays, table_c, bits_c, ids_c, counts_c, THR_ACT, K, BS, OW, attrs)
    assert (sel[0] >= 0).any() and (sel[0] < 0).any()
    cot = [torch.tensor(rng.normal(size=(B, H, W, K)).astype(np.float32)) for _ in range(4)]
    g_img = torch.tensor(rng.normal(size=(B, H, W, CA)).astype(np.float32))
    rows, _ = fine_bwd_plain(rays, table, *sel[:5], *cot, OW, attrs, g_img, want_rays=False)
    coefs = _slot_coefs(sel[0], *sel[1:5], *cot, OW, attrs, g_img)
    per_row = _per_row_sums(rays, table_c, ids_c, sel[0], coefs, sel[4], g_img)
    want = tfine.gather_back_rows(per_row, dst).reshape(B * P, 12 + CA)
    assert rows.shape == want.shape and want.abs().max() > 0
    for lo, hi in ((0, 3), (3, 12), (12, 12 + CA)):
        torch.testing.assert_close(rows[:, lo:hi], want[:, lo:hi], rtol=1e-5,
                                   atol=1e-6 * want[:, lo:hi].abs().max().item())
