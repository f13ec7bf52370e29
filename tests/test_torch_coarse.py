"""Coarse emission of the port (``voge_tpu_torch.ops.coarse`` on the plain
version of kernel K1) against ``voge_tpu``'s Pallas emission kernel run in
interpret mode (``emit_supertile_candidates(..., _force="kernel")``), on the
cases of ``tests/test_ops.py::test_emit_kernel_matches_xla_emission``.
Candidate rows and the inverse emission map are integer outputs: they must
match exactly.  The gather-back through that map against
``pallas_attr.gather_back_rows``: atol 1e-6 (sums of <= 9 rows in another
order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voge_tpu.cameras import look_at_view_transform
from voge_tpu.ops import coarse as jcoarse
from voge_tpu.ops.pallas_attr import gather_back_rows as j_gather_back_rows
from voge_tpu.rays import camera_rays
from voge_tpu_torch import trace
from voge_tpu_torch.ops import coarse as tcoarse
from voge_tpu_torch.ops.cuda_coarse import emit_rows, emit_rows_plain
from voge_tpu_torch.ops.fine import gather_back_rows

torch.set_num_threads(2)


def _inputs(case, B=1, P=60):
    rng = np.random.RandomState(77)
    mus = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32) * 0.8
    a = rng.uniform(-1, 1, size=(P, 3, 3)).astype(np.float32)
    isig = (np.einsum("pij,pkj->pik", a, a) + 2.0 * np.eye(3, dtype=np.float32)) * 100.0
    if case == "big":
        isig[7] = np.eye(3, dtype=np.float32) * 5e-4  # oversize: a global member
    R, T = look_at_view_transform(
        dist=[4.0] * B, elev=list(10.0 + 5 * np.arange(B)),
        azim=list(30.0 + 20 * np.arange(B)))
    focal = jnp.broadcast_to(jnp.asarray([[50.0, 50.0]]), (B, 2))
    principal = jnp.broadcast_to(jnp.asarray([[16.0, 16.0]]), (B, 2))
    H, W = 33, 47
    _, origins = camera_rays(R, T, focal, principal, (H, W))
    pts = np.asarray(jnp.asarray(mus)[None] - origins[:, None, :])
    isig_b = np.broadcast_to(isig[None], (B, P, 3, 3)).copy()
    cams = [np.array(x, np.float32) for x in (R, T, focal, principal)]
    return cams, pts, isig_b, (H, W)


@pytest.mark.parametrize("case", ["plain", "big"])
def test_emit_matches_pallas_emission(case):
    cams, pts, isig, hw = _inputs(case)
    thr, bin_size, M_max = 0.01, 10, 64
    ref = jcoarse.emit_supertile_candidates(
        *[jnp.asarray(c) for c in cams], jnp.asarray(pts), jnp.asarray(isig),
        hw, thr, bin_size, M_max, _force="kernel")
    ref = [np.asarray(x) for x in ref]
    got = tcoarse.emit_supertile_candidates(
        *[torch.as_tensor(c) for c in cams], torch.as_tensor(pts),
        torch.as_tensor(isig), hw, thr, bin_size, M_max)
    got = [x.numpy() for x in got]
    names = ["pos_c", "bits_c", "ids_c", "counts_c", "overflow_c"]
    for nm, r, g in zip(names, ref, got):
        np.testing.assert_array_equal(g, r.reshape(g.shape), err_msg=nm)
    assert ref[3].sum() > 0
    if case == "big":
        # the oversize Gaussian sorts in as a global member of several rows
        assert (got[2] == 7).sum() > 1


def test_rows_grow_to_the_densest_supertile():
    """With ``row_align`` the capacity is a floor: rows grow past it, so a
    capacity that truncates at a fixed width drops nothing."""
    cams, pts, isig, hw = _inputs("plain")
    args = ([torch.as_tensor(c) for c in cams]
            + [torch.as_tensor(pts), torch.as_tensor(isig), hw, 0.01, 10])
    fixed = tcoarse.emit_supertile_candidates(*args, 4)
    grown = tcoarse.emit_supertile_candidates(*args, 4, row_align=8)
    assert fixed[4].sum() > 0 and grown[4].sum() == 0
    assert grown[0].shape[1] % 8 == 0
    assert grown[3].max() == (fixed[3] + fixed[4]).max()


def test_emit_keys_dispatch_on_cpu_is_the_plain_version():
    """On CPU tensors the K1 wrapper (``emit_rows``) runs the plain version,
    launches nothing, and writes int32 row ids and uint8 bits."""
    cams, pts, isig, hw = _inputs("plain", B=2)
    args = ([torch.as_tensor(c) for c in cams]
            + [torch.as_tensor(pts), torch.as_tensor(isig), 0.01, 10, hw,
               6, 2, 3, 3])
    with trace.tracing():
        a = emit_rows(*args)
        b = emit_rows_plain(*args)
    assert trace.counts().get("launch.emit_rows", 0) == 0
    assert a[0].dtype == torch.int32 and a[1].dtype == torch.uint8
    assert a[0].shape == (2, pts.shape[1], 9) and int((a[0] >= 0).sum()) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case,B,M_max", [("plain", 1, 64), ("big", 1, 64),
                                          ("big", 2, 64), ("plain", 1, 8)])
def test_dst_matches_pallas_emission(case, B, M_max):
    """``return_dst=True``: the inverse emission map equals ``voge_tpu``'s
    (local keys, global members, their indices and validity), with one
    image, two images, a global member and rows capped below the densest
    supertile; then gathering random per-slot rows back through it equals
    ``pallas_attr.gather_back_rows``."""
    cams, pts, isig, hw = _inputs(case, B=B)
    thr, bin_size = 0.01, 10
    ref = jcoarse.emit_supertile_candidates(
        *[jnp.asarray(c) for c in cams], jnp.asarray(pts), jnp.asarray(isig),
        hw, thr, bin_size, M_max, return_dst=True, _force="kernel")
    got = tcoarse.emit_supertile_candidates(
        *[torch.as_tensor(c) for c in cams], torch.as_tensor(pts),
        torch.as_tensor(isig), hw, thr, bin_size, M_max, return_dst=True)
    names = ["pos_c", "bits_c", "ids_c", "counts_c", "overflow_c"]
    for nm, r, g in zip(names, ref[:5], got[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).reshape(g.shape), err_msg=nm)
    for nm, r, g in zip(["dst_l", "dst_g", "gpos", "g_valid"], ref[5], got[5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=nm)
    dst_l, dst_g = got[5][0].numpy(), got[5][1].numpy()
    assert (dst_l >= 0).sum() + (dst_g >= 0).sum() == got[3].sum()
    if case == "big":
        assert (dst_g >= 0).sum() > 1
    if M_max == 8:
        assert got[4].sum() > 0

    nb = got[0].shape[0]
    rng = np.random.RandomState(4)
    rows = rng.normal(size=(nb * M_max, 15)).astype(np.float32)
    rows *= (np.arange(M_max)[None] < got[3].numpy()[:, None]).reshape(-1, 1)
    P = pts.shape[1]
    want = j_gather_back_rows(jnp.asarray(rows), tuple(jnp.asarray(x) for x in ref[5]),
                              B, P, nb * M_max)
    gg = gather_back_rows(torch.as_tensor(rows), got[5])
    assert gg.shape == (B, P, 15)
    np.testing.assert_allclose(gg.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _bench_scene(name):
    """Full-width scenes of ``bench.py`` through the port's own converters:
    (cameras, camera-centred points, isigmas, image size, K)."""
    import voge_tpu_torch as vt
    from voge_tpu_torch.aggregation import expend_sigma
    from voge_tpu_torch.rays import camera_rays as t_camera_rays

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    if name == "texture":       # bench.py:204-218
        v, f = vt.ico_sphere(5)
        verts, isig, _ = vt.naive_vertices_converter(v, f, percentage=0.5, max_sig_rate=2)
        R, T = vt.look_at_view_transform(dist=3, elev=0.1, azim=0.6, degrees=False,
                                         device="cpu")
        cams = (R, T, f32([[1800.0, 1800.0]]), f32([[336.0, 128.0]]))
        hw, K = (256, 672), 80
    else:                       # bench.py:52-105 (headline) and the golden 1K scene
        n, hw, focal = {"headline": (10000, (256, 256), 300.0),
                        "1k": (1000, (128, 128), 150.0)}[name]
        verts, isig = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), n,
                                                       percentage=0.6)
        R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70, device="cpu")
        cams = (R, T, f32([[focal, focal]]), f32([[hw[1] / 2, hw[0] / 2]]))
        K = 20
    _, origins = t_camera_rays(*cams, hw)
    points = f32(verts)[None] - origins[:, None, :]
    return cams, points, 2.0 * expend_sigma(f32(isig))[None], hw, K


@pytest.mark.parametrize("name,win,densest", [("texture", 3, 80), ("headline", 2, 767),
                                              ("1k", 3, None)])
def test_full_width_coarse_stage_drops_nothing(name, win, densest):
    """The coarse stage of a render keeps every membership ``voge_tpu``'s
    ``rasterize_coarse`` finds, at full width.  The texture scene (10,242
    Gaussians, 256x672, K = 80, 32-px bins) starts with a 2x2 window that
    1,174 Gaussians in view outgrow (pixel radii up to 47 against 64-px
    supertiles), more than the 64 global members: the emission must run
    again with a 3x3 window instead of dropping them.  The headline keeps its
    2x2 window and the 1K scene its 3x3."""
    from voge_tpu_torch.ops import fine as tfine

    cams, points, isig, hw, K = _bench_scene(name)
    P = points.shape[1]
    c = tfine.compact_candidates(*cams, points, isig, hw, 0.01, K)
    assert int(c.overflow_c.sum()) == 0
    # the same emission with its inverse map, whose width is the window's
    again = tcoarse.emit_supertile_candidates(
        *cams, points, isig, hw, 0.01, c.bin_size, 0,
        row_align=tfine._pick_cand_chunk(P), return_dst=True)
    assert all(torch.equal(a, b) for a, b in zip(again[:5], c[:5]))
    assert again[5][0].shape[-1] == win * win
    if densest is not None:
        assert int(c.counts_c.max()) == densest
    bs = c.bin_size
    ref, cnt = jcoarse.rasterize_coarse(
        *[jnp.asarray(x.numpy()) for x in cams], jnp.asarray(points.numpy()),
        jnp.asarray(isig.numpy()), hw, 0.01, bs, P, return_counts=True)
    ref = np.asarray(ref)
    _, BH, BW, _ = ref.shape
    BW2 = (BW + 1) // 2
    ids, bits, counts = c.ids_c.numpy(), c.bits_c.numpy(), c.counts_c.numpy()
    missing = 0
    for by in range(BH):
        for bx in range(BW):
            s, g = (by // 2) * BW2 + bx // 2, 2 * (by % 2) + bx % 2
            row = ids[s, :counts[s]]
            mine = set(row[((bits[s, :counts[s]] >> g) & 1) > 0].tolist())
            missing += len(set(ref[0, by, bx][ref[0, by, bx] >= 0].tolist()) - mine)
    assert int(np.asarray(cnt).sum()) > 1000 and missing == 0


def test_excess_oversize_gaussians_widen_the_window():
    """Two Gaussians outgrow the 3x3 window (pixel radii 35 and 27 against
    20-px supertiles) and the global list holds one.  With fixed rows the
    second is dropped and counted; a render's exact rows (``row_align``) emit
    once more with the 5x5 window the two need, and nothing is dropped."""
    cams, pts, isig, hw = _inputs("plain")
    isig = isig.copy()
    isig[0, 3] = isig[0, 7] = np.eye(3, dtype=np.float32) * 0.7
    args = ([torch.as_tensor(c) for c in cams]
            + [torch.as_tensor(pts.copy()), torch.as_tensor(isig), hw, 0.01, 10, 64])
    fixed = tcoarse.emit_supertile_candidates(*args, n_globals=1, return_dst=True)
    assert int(fixed[4].sum()) == 1 and fixed[5][0].shape[-1] == 9
    assert (fixed[2] == 3).sum() == 6 and (fixed[2] == 7).sum() == 0
    exact = tcoarse.emit_supertile_candidates(*args, n_globals=1, row_align=8,
                                              return_dst=True)
    assert int(exact[4].sum()) == 0 and exact[5][0].shape[-1] == 25
    assert (exact[2] == 3).sum() == 6 and (exact[2] == 7).sum() == 6
    assert not exact[5][3].any()        # no global member is left
