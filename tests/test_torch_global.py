"""The global entries of K2 and K3 (the no-coarse path) against ``voge_tpu``'s
Pallas kernels in interpret mode, on the same rays, Gaussians and
membership:

- the plain select over the global candidate space
  (``cuda_fine.fine_select_global_plain``) against
  ``pallas_fine2.fine_select_mask_pallas``, with fused weights;
- the plain global backward (``cuda_fine_bwd.fine_bwd_global_plain``)
  against ``pallas_bwd.fine_bwd_unified_pallas``, fed the same selection.

Layout: one TPU bin of 2·bs x 2·bs pixels is one port supertile (G = 1 on
the TPU side), and the port's four sub-bin bits are set where the TPU mask
is 1.  Tolerances: selections equal; len / act / dsd rtol 1e-5, atol 1e-5
(the same operation order, CPU float32); weights atol 1e-4
(``torch.erf`` against ``voge_tpu``'s polynomial ``_erf32``).  The backward:
gradients within a normwise relative 1e-4 (the port's residual-form chain
rule against the TPU kernel's sum-then-combine; sums in another order).
The weight cotangent is zero there, the TPU kernel's unfolded contract; a
third test holds the folded backward to autograd of the plain forward."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import voge_tpu.ops.fine as F
from voge_tpu.ops.pallas_bwd import fine_bwd_unified_pallas
from voge_tpu.ops.pallas_fine2 import fine_select_mask_pallas
from voge_tpu_torch.ops.cuda_fine import fine_select_global_plain
from voge_tpu_torch.ops.cuda_fine_bwd import fine_bwd_global_plain
from voge_tpu_torch.ops.fine import feature_table

torch.set_num_threads(2)

B, BS, H, W, P, P_PAD, CC = 2, 4, 16, 24, 150, 256, 128
ST = 2 * BS                                    # supertile side = TPU bin side
BH, BW = H // ST, W // ST
NB = B * BH * BW
THR_ACT = -math.log(0.01 + 1e-10)
OW = 0.9


def _scene():
    """Unit rays of a 16x24 image per camera; SPD precisions around points
    in front of it (camera-centred), as ``tests/test_pallas.py`` draws them."""
    rng = np.random.RandomState(11)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.zeros((B, H, W, 3), np.float32)
    for b in range(B):
        d = np.stack([(xx - W / 2 + 0.5) / 20.0, (yy - H / 2 + 0.5) / 20.0,
                      np.ones_like(xx, dtype=np.float64)], -1) + 0.02 * b
        rays[b] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    mus = np.concatenate([rng.uniform(-0.6, 0.6, (B, P, 2)),
                          rng.uniform(2.0, 4.0, (B, P, 1))], -1).astype(np.float32)
    a = rng.uniform(-1, 1, size=(B, P, 3, 3)).astype(np.float32)
    lam = (np.einsum("bmij,bmkj->bmik", a, a) + 2 * np.eye(3, dtype=np.float32)) * 30.0
    return rays, mus, lam.astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _tpu_inputs(rays, mus, lam, mask):
    rf, _, r_pad = F._rays_features(jnp.asarray(rays), BH, BW, ST, ST)
    gf = F._gauss_feature_planes_batched(jnp.asarray(mus), jnp.asarray(lam))
    gf = jnp.pad(gf, ((0, 0), (0, 0), (0, P_PAD - P)))
    m = np.zeros((NB, 1, P_PAD), np.int8)
    m[:, 0, :P] = mask
    ids = np.full((B, 1, P_PAD), -1, np.int32)
    ids[:, 0, :P] = np.arange(P)[None] + (np.arange(B) * P)[:, None]
    return rf, gf, jnp.asarray(m), jnp.asarray(ids), r_pad


def _unbin(x):
    return np.asarray(F._unbin(jnp.asarray(x)[:, :ST * ST], B, BH, BW, H, W, ST, ST))


def _port_select(rays, mus, lam, mask, K):
    t = torch.as_tensor
    table = feature_table(t(mus), t(lam))
    bits = None if mask.all() else t(np.where(mask > 0, 0xF, 0).astype(np.int32))
    return table, fine_select_global_plain(t(rays), table, bits, THR_ACT, K, BS, OW)


def _mask(kind):
    if kind == "ones":
        return np.ones((NB, P), np.int8)
    return (np.random.RandomState(4).rand(NB, P) < 0.6).astype(np.int8)


@pytest.mark.parametrize("kind", ["random", "ones"])
@pytest.mark.parametrize("K", [5, 25])
def test_plain_global_select_matches_pallas(scene, K, kind):
    rays, mus, lam = scene
    mask = _mask(kind)
    rf, gf, m, ids, r_pad = _tpu_inputs(rays, mus, lam, mask)
    want = fine_select_mask_pallas(rf, gf, m, ids, THR_ACT, K, bh_bw=BH * BW, n_gauss=P,
                                   ray_chunk=r_pad, cand_chunk=CC, interpret=True,
                                   agg_ow=OW)
    want = [_unbin(x) for x in want]
    _, got = _port_select(rays, mus, lam, mask, K)
    got = [x.numpy() for x in got]
    assert got[0].shape == (B, H, W, K)
    assert (got[0] >= 0).any() and (got[0] < 0).any()
    if K == 5:
        assert ((got[0] >= 0).sum(-1) == K).any()      # some pixels fill every slot
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-4)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(want).max() > 0
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("K", [5, 25])
def test_plain_global_bwd_matches_pallas(scene, K):
    """``fine_bwd_unified_pallas`` recomputes each slot's forms from the
    selection; the port's plain backward reads the saved len / dsd of the
    same selection.  g_w = 0: the TPU kernel takes no weight cotangent."""
    rays, mus, lam = scene
    mask = _mask("random")
    table, sel = _port_select(rays, mus, lam, mask, K)
    rng = np.random.RandomState(8)
    cot = [rng.normal(size=(B, H, W, K)).astype(np.float32) for _ in range(3)]
    rf, gf, m, ids, r_pad = _tpu_inputs(rays, mus, lam, mask)
    binned = lambda x, fill: F._bin_hwk(jnp.asarray(x), BH, BW, ST, ST, H, W, r_pad, fill)
    gg, rb = fine_bwd_unified_pallas(
        rf, gf, m, ids, binned(sel[0].numpy(), -1), *(binned(c, 0.0) for c in cot),
        thr_act=THR_ACT, K=K, bh_bw=BH * BW, n_gauss=P, ray_chunk=r_pad,
        cand_chunk=CC, interpret=True)
    gg = np.swapaxes(np.asarray(gg), 1, 2)[:, :P]                   # (B, P, 16)
    t = torch.as_tensor
    rows, g_rays = fine_bwd_global_plain(
        t(rays), table, *sel, *(t(c) for c in cot), torch.zeros_like(sel[4]), OW)
    assert rows.shape == (B * P, 12)
    rows = rows.numpy().reshape(B, P, 12)
    assert _rel(rows[..., 0:3], gg[..., 0:3]) <= 1e-4
    assert _rel(rows[..., 3:12], gg[..., 3:12]) <= 1e-4
    assert _rel(g_rays.numpy(), _unbin(np.asarray(rb)[..., 0:3])) <= 1e-4
    _, none = fine_bwd_global_plain(t(rays), table, *sel, *(t(c) for c in cot), None,
                                    OW, want_rays=False)
    assert none is None


def test_plain_global_bwd_is_the_gradient_of_the_plain_select(scene):
    """With a weight cotangent: the backward of ``fine_select_global_plain``
    (len, act, dsd and w of a fixed selection as functions of mu, Lambda and
    the rays, evaluated by autograd in float64) against
    ``fine_bwd_global_plain`` (the fold of g_w included).  ``act`` is written
    in the entry-space form ``msm - msk^2 / ksk`` whose derivative
    ``voge_tpu`` defines (``ray_trace_voge.cu``'s chain rule,
    ``fine.py:303-318``): for a symmetric Lambda it equals the forward's
    ``delta^T Lambda delta``, and its gradient in Lambda is the one both
    packages return (the compensated form's differs by an antisymmetric
    part)."""
    rays, mus, lam = scene
    K = 8
    table, sel = _port_select(rays, mus, lam, _mask("ones"), K)
    idx = sel[0]
    rng = np.random.RandomState(3)
    cots = [torch.as_tensor(rng.normal(size=(B, H, W, K)).astype(np.float32))
            for _ in range(4)]
    rows, g_rays = fine_bwd_global_plain(torch.as_tensor(rays), table, *sel, *cots, OW)

    from voge_tpu_torch.aggregation import weights_from_sel

    mu = torch.tensor(mus, dtype=torch.float64, requires_grad=True)
    L = torch.tensor(lam, dtype=torch.float64, requires_grad=True)
    r = torch.tensor(rays, dtype=torch.float64, requires_grad=True)
    valid = idx >= 0
    j = torch.where(valid, idx, 0).long()
    mu_s, L_s = mu.reshape(-1, 3)[j], L.reshape(-1, 3, 3)[j]
    rr = r[..., None, :]
    ksk = torch.einsum("...i,...ij,...j->...", rr, L_s, rr)
    msk = torch.einsum("...i,...ij,...j->...", mu_s, L_s, rr)
    msm = torch.einsum("...i,...ij,...j->...", mu_s, L_s, mu_s)
    length = msk / ksk
    act = msm - msk * msk / ksk
    length = torch.where(valid, length, 1e10)
    act = torch.where(valid, act, 1e10)
    ksk = torch.where(valid, ksk, 0.0)
    w = weights_from_sel(length, act, ksk, OW)
    out = sum((x * c.double()).sum() for x, c in zip((length, act, ksk, w), cots))
    g_mu, g_L, g_r = torch.autograd.grad(out, (mu, L, r))
    rows = rows.numpy().reshape(B, P, 12)
    assert _rel(rows[..., 0:3], g_mu.numpy()) <= 1e-4
    assert _rel(rows[..., 3:12], g_L.numpy().reshape(B, P, 9)) <= 1e-4
    assert _rel(g_rays.numpy(), g_r.numpy()) <= 1e-4
