"""The grouping of slots by id (``voge_tpu_torch.ops.cuda_attr.slot_runs``,
on the CPU its plain version) against numpy, and the two run-kernel halves
that take it (the plain versions of ``attr_scatter`` and ``attr_merge_bwd``)
against ``voge_tpu``'s Pallas kernels in interpret mode at more than 256 ids.

Tolerance: the grouping is integers, held exactly: ``starts`` equal to
``np.searchsorted`` of the stably sorted keys and ``order[:starts[n_rows]]``
equal to ``np.argsort(kind="stable")``'s valid prefix.  d_w and d_attr to
rtol 1e-5 and atol 1e-5 (float32 sums of the same terms in another order).
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

import voge_tpu.ops.fine as F
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.ops.coarse import overlap_mask
from voge_tpu.ops.pallas_attr import (
    attr_merge_bwd_attr_pallas, attr_merge_bwd_unified_pallas,
)
from voge_tpu.rays import camera_rays
from voge_tpu_torch import trace
from voge_tpu_torch.ops.cuda_attr import (
    attr_merge_bwd_plain, attr_scatter_plain, slot_runs, slot_runs_plain,
)

torch.set_num_threads(2)


def _numpy_runs(idx, n_rows):
    """(order, starts) of a stable numpy sort of the flattened ids, the
    out-of-range ones keyed ``n_rows``."""
    flat = np.asarray(idx).reshape(-1)
    key = np.where((flat >= 0) & (flat < n_rows), flat, n_rows)
    order = np.argsort(key, kind="stable")
    return order, np.searchsorted(key[order], np.arange(n_rows + 1), side="left")


def _hold(idx, n_rows):
    """``slot_runs`` on a CPU tensor against numpy: types, run starts, the
    valid prefix of ``order``, each run in ascending slot order on its id."""
    t = torch.as_tensor(idx)
    with trace.tracing():
        order, starts = slot_runs(t, n_rows)
    assert trace.counts().get("launch.slot_runs", 0) == 0     # the plain version ran
    assert order.dtype == torch.int32 and starts.dtype == torch.int64
    assert order.shape == (t.numel(),) and starts.shape == (n_rows + 1,)
    want_order, want_starts = _numpy_runs(idx, n_rows)
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    v = int(want_starts[-1])
    np.testing.assert_array_equal(order.numpy()[:v], want_order[:v])
    flat = t.reshape(-1)
    for j in np.unique(flat.numpy()[want_order[:v]])[:8]:
        run = order[starts[j]:starts[j + 1]].long()
        assert bool((flat[run] == j).all()) and bool((run[1:] > run[:-1]).all())
    return order, starts


@pytest.mark.parametrize("K", [1, 20, 80, 128])
@pytest.mark.parametrize("n_rows", [1, 255, 256, 257, 65535, 65536, 65537])
def test_slot_runs_match_a_stable_numpy_sort(n_rows, K):
    """Seeded ids: a third of the slots empty, some at or above ``n_rows``,
    across the one-, two- and three-digit widths of the kernel's passes."""
    rng = np.random.RandomState(n_rows * 131 + K)
    n_pix = max(1, 6000 // K)
    idx = rng.randint(-(n_rows // 2) - 1, n_rows + 4, size=(n_pix, K)).clip(min=-1)
    idx = idx.astype(np.int32)
    order, starts = _hold(idx, n_rows)
    assert int(starts[-1]) == int(((idx >= 0) & (idx < n_rows)).sum())


@pytest.mark.parametrize("kind", ["all_empty", "one_id", "all_beyond", "one_slot"])
def test_slot_runs_edge_cases(kind):
    """Every slot empty (every run empty, ``starts`` all 0), one id in every
    slot (one run of them all, in slot order), every id at or above
    ``n_rows``, and a single slot."""
    n_rows = 300
    idx = {"all_empty": np.full((50, 20), -1), "one_id": np.full((50, 20), 257),
           "all_beyond": np.full((50, 20), n_rows) + np.arange(20),
           "one_slot": np.full((1, 1), 299)}[kind].astype(np.int32)
    order, starts = _hold(idx, n_rows)
    if kind == "one_id":
        assert int(starts[257]) == 0 and int(starts[258]) == idx.size
        np.testing.assert_array_equal(order.numpy(), np.arange(idx.size))
    elif kind == "one_slot":
        assert starts.tolist() == [0] * 300 + [1] and order.tolist() == [0]
    else:
        assert not starts.any()


@settings(max_examples=120, deadline=None)
@given(n_rows=st.integers(1, 600), K=st.sampled_from([1, 20, 80, 128]),
       data=st.data())
def test_slot_runs_hypothesis(n_rows, K, data):
    """Drawn ids, any mix of empty, valid and out-of-range slots."""
    n_pix = data.draw(st.integers(1, 12))
    ids = data.draw(st.lists(st.integers(-3, n_rows + 3), min_size=n_pix * K,
                             max_size=n_pix * K))
    _hold(np.asarray(ids, np.int32).reshape(n_pix, K), n_rows)


def test_slot_runs_plain_keeps_torch_sort():
    """The plain version is the stable ``torch.sort`` + ``searchsorted`` the
    wrappers took before the grouping kernel, with ``order`` as int32."""
    idx = torch.randint(-5, 400, (64, 20), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(3))
    flat = idx.reshape(-1)
    key = torch.where((flat >= 0) & (flat < 390), flat, 390)
    key_s, want = torch.sort(key, stable=True)
    order, starts = slot_runs_plain(idx, 390)
    assert torch.equal(order.long(), want)
    assert torch.equal(starts, torch.searchsorted(key_s, torch.arange(391)))


def _scene(rng, B=2, H=20, W=20, P=150, K=6, bin_size=5, Ca=3):
    """``tests/test_pallas_attr.py``'s scene with ``B * P`` ids above 256 and
    the candidate planes padded to a multiple of the 128-wide chunk."""
    mus_w = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32) * 0.8
    a = rng.uniform(-1, 1, size=(P, 3, 3)).astype(np.float32)
    isig = np.einsum("pij,pkj->pik", a, a) + 2 * np.eye(3, dtype=np.float32)
    R_, T_ = look_at_view_transform(dist=[4.0, 5.0], elev=[5.0, 25.0], azim=[10.0, 50.0])
    focal = jnp.broadcast_to(jnp.asarray([[30.0, 30.0]]), (B, 2))
    principal = jnp.broadcast_to(jnp.asarray([[10.0, 10.0]]), (B, 2))
    rays, origins = camera_rays(R_, T_, focal, principal, (H, W))
    mus = jnp.asarray(mus_w)[None] - origins[:, None, :]
    isig_b = jnp.broadcast_to(jnp.asarray(isig)[None], (B, P, 3, 3))
    thr_act = -math.log(0.01 + 1e-10)
    base_ids = (jnp.arange(P, dtype=jnp.int32)[None, :]
                + (jnp.arange(B, dtype=jnp.int32) * P)[:, None])
    pts, isg, ids, perm = F._sort_bin_coherent(
        R_, T_, focal, principal, mus, isig_b, (H, W), bin_size, base_ids)
    mask = overlap_mask(R_, T_, focal, principal, pts, isg, (H, W), 0.01, bin_size)
    sel_k, _aux = F._rt_fine_kern(pts, isg, rays, mask, ids, thr_act,
                                  (bin_size, bin_size), K)
    w_k = jnp.where(sel_k[0] >= 0, 1.0 / (1.0 + jnp.abs(sel_k[1])) + 0.1, 0.0)
    _, BH, BW, _ = mask.shape
    cand_chunk = 128
    P_pad = -(-P // cand_chunk) * cand_chunk
    mask_flat = jnp.pad(mask.reshape(B * BH * BW, P).astype(jnp.int8),
                        ((0, 0), (0, P_pad - P)))[:, None, :]
    ids_p = F._prep_ids(ids, P, P_pad)
    attr = jnp.asarray(rng.rand(B * P, Ca).astype(np.float32))
    attr_sorted = jnp.take_along_axis(attr.reshape(B, P, Ca), perm[:, :, None], axis=1)
    planes = jnp.pad(jnp.swapaxes(attr_sorted, 1, 2), ((0, 0), (0, 8 - Ca), (0, P_pad - P)))
    return sel_k[0], w_k, mask_flat, ids_p, planes, BH * BW, cand_chunk


@pytest.mark.parametrize("K_sel", [6, 40])
def test_run_halves_match_the_pallas_kernels_above_256_ids(K_sel):
    """``attr_scatter_plain`` against ``attr_merge_bwd_attr_pallas`` and
    ``attr_merge_bwd_plain`` (d_w and d_attr) against
    ``attr_merge_bwd_unified_pallas``, both in interpret mode, on 300 ids
    (two digits of the grouping kernel), to 1e-5."""
    rng = np.random.RandomState(31)
    sel_k, w_k, mask_flat, ids_p, planes, bh_bw, chunk = _scene(rng, K=K_sel)
    g = rng.rand(*(w_k.shape[:2] + (8,))).astype(np.float32)
    d_attr_j = np.asarray(attr_merge_bwd_attr_pallas(
        planes, w_k, sel_k, mask_flat, ids_p, jnp.asarray(g), bh_bw, chunk, interpret=True))
    u_attr_j, u_w_j = attr_merge_bwd_unified_pallas(
        planes, w_k, sel_k, mask_flat, ids_p, jnp.asarray(g), bh_bw, chunk, interpret=True)
    ids = np.asarray(ids_p)[:, 0, :]
    pn = np.asarray(planes)
    n_rows = int(ids.max()) + 1
    assert n_rows > 256
    attrs = np.zeros((n_rows, pn.shape[1]), np.float32)
    attrs[ids[ids >= 0]] = np.swapaxes(pn, 1, 2)[ids >= 0]

    def rows(planes_j):
        out = np.zeros_like(attrs)
        out[ids[ids >= 0]] = np.swapaxes(np.asarray(planes_j), 1, 2)[ids >= 0]
        return out

    t = torch.as_tensor
    sel, w = t(np.array(sel_k)), t(np.array(w_k))
    held = np.bincount(np.asarray(sel_k)[np.asarray(sel_k) >= 0], minlength=n_rows)
    assert (held == 0).any() and held[:256].any() and held[256:].any()
    d_attr = attr_scatter_plain(sel, w, t(g), n_rows)
    np.testing.assert_allclose(d_attr.numpy(), rows(d_attr_j), rtol=1e-5, atol=1e-5)
    d_w, d_attr_u = attr_merge_bwd_plain(sel, w, t(attrs), t(g))
    assert np.abs(np.asarray(u_w_j)).max() > 0.1 and np.abs(rows(u_attr_j)).max() > 0.1
    np.testing.assert_allclose(d_w.numpy(), np.asarray(u_w_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_attr_u.numpy(), rows(u_attr_j), rtol=1e-5, atol=1e-5)
