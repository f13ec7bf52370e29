"""Kernel K3f of the port (the plain version of
``voge_tpu_torch.ops.cuda_attr.attr_merge``) against ``voge_tpu``'s attribute
merge kernel ``pallas_attr.attr_merge_compact`` in interpret mode, on
selections drawn from emission-compacted candidate rows.

Tolerance: the composited image agrees to atol 1e-5 (f32 sums of K terms in
another order; the envelope for composited images is 1e-4)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import voge_tpu.ops.fine as F
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.ops import coarse as jcoarse
from voge_tpu.ops.pallas_attr import attr_merge_compact
from voge_tpu.rays import camera_rays
from voge_tpu_torch.ops.cuda_attr import AttrMerge, attr_merge_plain

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


def test_attr_merge_backward_raises(case):
    w = torch.as_tensor(case["w"]).requires_grad_(True)
    attrs = torch.as_tensor(np.swapaxes(case["attr"], 1, 2).reshape(B * P, CA).copy())
    out = AttrMerge.apply(w, attrs, torch.as_tensor(case["sel"]))
    with pytest.raises(NotImplementedError, match="pallas_attr"):
        out.sum().backward()
