"""Kernels K3f and K4b of the port (the plain versions of
``voge_tpu_torch.ops.cuda_attr.attr_merge`` and ``attr_merge_bwd``) against
``voge_tpu``'s attribute merge ``pallas_attr.attr_merge_compact`` and its VJP
(``_attr_bwd_call``, the Pallas ``_bwd_unified_kernel``) in interpret mode,
on selections drawn from emission-compacted candidate rows.

Tolerance: the composited image and d_w agree to atol 1e-5 (f32 sums of K
terms in another order; the envelope for composited images is 1e-4); d_attr,
a sum over the hundreds of slots that hold one Gaussian, to rtol 1e-5 and
atol 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import voge_tpu.ops.fine as F
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.ops import coarse as jcoarse
from voge_tpu.ops.pallas_attr import attr_merge_compact
from voge_tpu.rays import camera_rays
from voge_tpu_torch import trace
from voge_tpu_torch.ops.cuda_attr import AttrMerge, attr_merge_bwd_plain, attr_merge_plain

torch.set_num_threads(2)

B, H, W, P, CA, BS, M_MAX, K = 2, 36, 44, 60, 8, 10, 128, 20


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(11)
    mus_w = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32) * 0.8
    a = rng.uniform(-1, 1, size=(P, 3, 3)).astype(np.float32)
    isig = (np.einsum("pij,pkj->pik", a, a) + 2 * np.eye(3, dtype=np.float32)) * 4.0
    R, T = look_at_view_transform(dist=[4.0, 4.5], elev=[5.0, 20.0], azim=[10.0, 40.0])
    focal = jnp.broadcast_to(jnp.asarray([[60.0, 60.0]]), (B, 2))
    principal = jnp.broadcast_to(jnp.asarray([[W / 2, H / 2]]), (B, 2))
    _, origins = camera_rays(R, T, focal, principal, (H, W))
    mus = jnp.asarray(mus_w)[None] - origins[:, None, :]
    isig_b = jnp.broadcast_to(jnp.asarray(isig)[None], (B, P, 3, 3))
    pos_c, _, ids_c, counts_c, _ = jcoarse.emit_supertile_candidates(
        R, T, focal, principal, mus, isig_b, (H, W), 0.01, BS, M_MAX,
        _force="kernel")
    ids = np.array(ids_c)[..., 0]
    nb, R_pad = ids.shape[0], 4 * BS * BS
    # selections in kernel layout: K slots per ray drawn from the ray's
    # supertile row (a prefix of valid ids, then -1), random weights
    sel = np.full((nb, R_pad, K), -1, np.int32)
    n_valid = rng.randint(0, K + 1, size=(nb, R_pad))
    for s in range(nb):
        cnt = int(counts_c[s])
        for r in range(R_pad):
            n = min(n_valid[s, r], cnt)
            sel[s, r, :n] = rng.choice(ids[s, :cnt], size=n, replace=False)
    w = rng.uniform(0, 1, size=(nb, R_pad, K)).astype(np.float32)
    attr = rng.normal(size=(B, CA, P)).astype(np.float32)
    return dict(sel=sel, w=w, attr=attr, ids_c=ids_c, pos_c=pos_c,
                counts_c=counts_c)


def test_plain_attr_merge_matches_pallas(case):
    BH, BW = (H - 1) // BS + 1, (W - 1) // BS + 1
    w_eff = np.where(case["sel"] >= 0, case["w"], 0.0).astype(np.float32)
    img_k = attr_merge_compact(
        jnp.asarray(case["attr"]), jnp.asarray(w_eff), jnp.asarray(case["sel"]),
        case["ids_c"], case["pos_c"], case["counts_c"], None, B, True)
    unbin = lambda x: np.array(F.unbin_kern(x, B, BH, BW, H, W, BS, BS, True))
    want = unbin(img_k)
    sel, w = unbin(jnp.asarray(case["sel"])), unbin(jnp.asarray(case["w"]))
    attrs = np.swapaxes(case["attr"], 1, 2).reshape(B * P, CA).copy()
    got = attr_merge_plain(torch.as_tensor(sel), torch.as_tensor(w),
                           torch.as_tensor(attrs)).numpy()
    assert got.shape == (B, H, W, CA) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _unbin(x):
    BH, BW = (H - 1) // BS + 1, (W - 1) // BS + 1
    return np.array(F.unbin_kern(jnp.asarray(x), B, BH, BW, H, W, BS, BS, True))


def _to_kern(x):
    """(B, H, W, C) -> the (nb, 4 * BS * BS, C) kernel layout, zero outside
    the image."""
    BH, BW = (H - 1) // BS + 1, (W - 1) // BS + 1
    C = x.shape[-1]
    xp = np.zeros((B, BH * BS, BW * BS, C), np.float32)
    xp[:, :H, :W] = x
    xb = xp.reshape(B, BH, BS, BW, BS, C).transpose(0, 1, 3, 2, 4, 5)
    xb = xb.reshape(B * BH * BW, BS * BS, C)
    return F._group_supertiles(jnp.asarray(xb), B, BH, BW)[0]


def test_plain_attr_merge_bwd_matches_pallas(case):
    """d_w and d_attr against ``jax.vjp`` of ``attr_merge_compact`` (its
    backward runs the Pallas ``_bwd_unified_kernel`` in interpret mode)."""
    w_eff = jnp.asarray(np.where(case["sel"] >= 0, case["w"], 0.0).astype(np.float32))
    g_img = np.random.RandomState(12).normal(size=(B, H, W, CA)).astype(np.float32)
    sel_k = jnp.asarray(case["sel"])
    _, vjp = jax.vjp(
        lambda a, w: attr_merge_compact(a, w, sel_k, case["ids_c"], case["pos_c"],
                                        case["counts_c"], None, B, True),
        jnp.asarray(case["attr"]), w_eff)
    d_attr_j, d_w_j = vjp(_to_kern(g_img))
    sel, w = _unbin(case["sel"]), _unbin(case["w"])
    attrs = np.swapaxes(case["attr"], 1, 2).reshape(B * P, CA).copy()
    t = torch.as_tensor
    d_w, d_attr = attr_merge_bwd_plain(t(sel), t(w), t(attrs), t(g_img))
    assert d_w.shape == (B, H, W, K) and d_attr.shape == (B * P, CA)
    want_w = np.where(sel >= 0, _unbin(d_w_j), 0.0)
    np.testing.assert_allclose(d_w.numpy(), want_w, rtol=0, atol=1e-5)
    want_attr = np.swapaxes(np.asarray(d_attr_j), 1, 2).reshape(B * P, CA)
    assert np.abs(want_attr).max() > 0.1
    np.testing.assert_allclose(d_attr.numpy(), want_attr, rtol=1e-5, atol=1e-5)


def test_attr_merge_autograd_uses_its_backward(case):
    """``AttrMerge``'s backward returns the plain backward's d_w and d_attr
    and leaves ``idx`` without a gradient."""
    t = torch.as_tensor
    sel, w0 = t(_unbin(case["sel"])), t(_unbin(case["w"]))
    w = w0.clone().requires_grad_(True)
    attrs = t(np.swapaxes(case["attr"], 1, 2).reshape(B * P, CA).copy()).requires_grad_(True)
    g = torch.randn(B, H, W, CA, generator=torch.Generator().manual_seed(1))
    AttrMerge.apply(w, attrs, sel).backward(g)
    d_w, d_attr = attr_merge_bwd_plain(sel, w0, attrs.detach(), g)
    assert torch.equal(w.grad, d_w) and torch.equal(attrs.grad, d_attr)


@pytest.mark.parametrize("K_sel", [6, 40])
def test_plain_halves_match_the_split_pallas_kernels(K_sel):
    """``attr_scatter_plain`` / ``attr_dw_plain`` against
    ``attr_merge_bwd_attr_pallas`` / ``attr_merge_bwd_w_pallas`` in interpret
    mode, driven as ``tests/test_pallas_attr.py`` drives them (K below and
    above the kernels' unroll limit of 32, selections with -1 slots), to
    1e-5; and against the two halves of ``attr_merge_bwd_plain``, exactly."""
    from test_pallas_attr import _scene
    from voge_tpu.ops.pallas_attr import attr_merge_bwd_attr_pallas, attr_merge_bwd_w_pallas
    from voge_tpu_torch.ops.cuda_attr import (
        attr_dw, attr_dw_plain, attr_scatter, attr_scatter_plain,
    )

    rng = np.random.RandomState(21)
    sel_k, w_k, mask_flat, ids_p, planes, _attr, geom = _scene(rng, K=K_sel)
    g = rng.rand(*(w_k.shape[:2] + (8,))).astype(np.float32)
    d_attr_j = np.asarray(attr_merge_bwd_attr_pallas(
        planes, w_k, sel_k, mask_flat, ids_p, jnp.asarray(g), geom["bh_bw"],
        geom["cand_chunk"], interpret=True))
    d_w_j = np.asarray(attr_merge_bwd_w_pallas(
        planes, sel_k, mask_flat, ids_p, jnp.asarray(g), w_k.shape[2], geom["bh_bw"],
        geom["cand_chunk"], interpret=True))
    # the Pallas kernels' candidate planes (B, Ca, P_pad) as rows by id
    ids = np.asarray(ids_p)[:, 0, :]
    pn = np.asarray(planes)
    n_rows = int(ids.max()) + 1
    attrs = np.zeros((n_rows, pn.shape[1]), np.float32)
    attrs[ids[ids >= 0]] = np.swapaxes(pn, 1, 2)[ids >= 0]
    want_attr = np.zeros_like(attrs)
    want_attr[ids[ids >= 0]] = np.swapaxes(d_attr_j, 1, 2)[ids >= 0]

    t = torch.as_tensor
    sel, w = t(np.asarray(sel_k)), t(np.asarray(w_k))
    assert (sel < 0).any() and (sel >= 0).any()
    d_w = attr_dw_plain(sel, t(attrs), t(g))
    d_attr = attr_scatter_plain(sel, w, t(g), n_rows)
    assert np.abs(d_w_j).max() > 0.1 and np.abs(want_attr).max() > 0.1
    np.testing.assert_allclose(d_w.numpy(), d_w_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_attr.numpy(), want_attr, rtol=1e-5, atol=1e-5)
    both = attr_merge_bwd_plain(sel, w, t(attrs), t(g))
    assert torch.equal(d_w, both[0]) and torch.equal(d_attr, both[1])
    # on CPU tensors the wrappers run these plain versions and launch nothing
    with trace.tracing():
        assert torch.equal(attr_dw(sel, t(attrs), t(g)), d_w)
        assert torch.equal(attr_scatter(sel, w, t(g), n_rows), d_attr)
    n = trace.counts()
    assert (n.get("launch.attr_dw", 0), n.get("launch.attr_scatter", 0)) == (0, 0)
    # ids beyond the table add nothing; rows no slot holds stay zero
    wide = attr_scatter_plain(sel, w, t(g), n_rows + 5)
    assert torch.equal(wide[:n_rows], d_attr) and not wide[n_rows:].any()
    short = attr_scatter_plain(sel, w, t(g), n_rows - 3)
    np.testing.assert_array_equal(short.numpy(), d_attr.numpy()[:n_rows - 3])
