"""Kernel K2 of the port (the plain version of
``voge_tpu_torch.ops.cuda_fine.fine_select``) against ``voge_tpu``'s
streaming select kernel ``pallas_fine2.fine_select_compact_pallas`` in
interpret mode, with fused weights (``agg_ow=0.9``) and a fused 8-channel
attribute image, on the same emission-compacted candidate rows and rays.

Tolerances (as in ``tests/test_parity_full.py:22-49``):
selections equal but for knife-edge pixels, flipped pixels < 0.1%;
len / act / dsd rtol 1e-5, atol 1e-5 on agreeing pixels; weights and the
attribute image atol 1e-4 on agreeing pixels."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import voge_tpu.ops.fine as F
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.ops import coarse as jcoarse
from voge_tpu.ops.pallas_fine2 import fine_select_compact_pallas, prefix_visit_lists
from voge_tpu.rays import camera_rays
from voge_tpu_torch.ops.cuda_fine import FineSelect, fine_select_plain

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
                counts=np.array(counts_c),
                attrs=np.swapaxes(attr, 1, 2).reshape(B * P, CA).copy())


@pytest.fixture(scope="module")
def case():
    return _case()


def _pallas(c, K):
    BH, BW = (H - 1) // BS + 1, (W - 1) // BS + 1
    rays_feat, _, _ = F._rays_features(jnp.asarray(c["rays"]), BH, BW, BS, BS)
    rf_k, _, _ = F._group_supertiles(rays_feat, B, BH, BW)
    counts = jnp.asarray(c["counts"])
    csel, cnts = prefix_visit_lists(counts, M_MAX, 128)
    out = fine_select_compact_pallas(
        jnp.swapaxes(rf_k, 1, 2), jnp.asarray(c["table"]),
        jnp.asarray(c["bits"])[..., None], jnp.asarray(c["ids"])[..., None],
        csel, cnts, THR_ACT, K, sub_bins=4, ray_chunk=rf_k.shape[1],
        cand_chunk=128, per_bin_cand=True, agg_ow=OW, n_attr=CA,
        interpret=True)
    unbin = lambda x: np.asarray(F.unbin_kern(x, B, BH, BW, H, W, BS, BS, True))
    return [unbin(x) for x in out[:5]] + [unbin(jnp.swapaxes(out[5], 1, 2))]


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


def test_select_backward_raises(case):
    """Forward with grad-requiring inputs works; ``.backward()`` through the
    select raises until the backward kernel is ported."""
    t = torch.as_tensor
    table = t(case["table"][..., :16].copy()).requires_grad_(True)
    out = FineSelect.apply(table, t(case["rays"]), None, t(case["bits"]),
                           t(case["ids"]), t(case["counts"]), THR_ACT, 20, BS, OW)
    assert out[4].requires_grad and not out[0].requires_grad
    with pytest.raises(NotImplementedError, match="_bwd_t_kernel"):
        out[4].sum().backward()
