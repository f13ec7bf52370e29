"""What the select kernel's design rests on, held on the CPU:

- the cone cull's bound in float64 (a ``hypothesis`` property): no pair
  (cone, Gaussian) that the bound drops has ``act < thr_act`` for any ray of
  the cone, at any point of the ray's line;
- the glue the kernel reads (``cuda_fine.cull_rows``, ``block_cones``,
  ``cull_mask_plain``) on a ShapeFitting-like scene, a small point cloud and
  needles of axis ratio 1:100 at the cull's edge: no dropped pair passes the
  plain float32 hit test for a ray of its block;
- the selection as a key: the plain select's stable sort equals a sort by
  (len, candidate position), also on exact ties, and so does a streaming
  stable insertion over candidates that arrive in batches with some dropped;
- the two-level cull: a super-tile's cone holds every ray and every cone of
  its warps' 4 x 8 tiles in float64 (``hypothesis``); level 1's mask keeps
  every Gaussian that a warp's own cone keeps, super-tiles cut by the image's
  edge and two cameras included, and drops none that passes the hit test; the
  plain two-level select equals the plain select to the bit, on duplicated
  Gaussians (ties in len) too;
- the compacted rows' width and the renderer's camera kwargs.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

import voge_tpu.renderer as jr
from voge_tpu.cameras import look_at_view_transform
from voge_tpu.converter import Cuboid
import voge_tpu_torch as vt
from voge_tpu_torch.ops import cuda_fine as cf
from voge_tpu_torch.ops import fine

torch.set_num_threads(2)

THR_ACT = -math.log(0.01 + 1e-10)


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q


@settings(max_examples=150, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       log_aniso=st.floats(0.0, 2.0),            # axis ratio 1 .. 100
       log_scale=st.floats(-1.0, 4.0),
       place=st.sampled_from(["front", "behind", "near_origin", "side"]),
       theta=st.floats(1e-4, 1.2))
def test_cull_bound_is_conservative_in_float64(seed, log_aniso, log_scale, place, theta):
    rng = np.random.RandomState(seed)
    sig = 10.0 ** (-log_scale / 2) * np.array([1.0, 10.0 ** (-log_aniso * rng.rand()),
                                                10.0 ** -log_aniso])
    q = _rotation(rng)
    lam = q @ np.diag(1.0 / sig ** 2) @ q.T
    lam = lam + 1e-3 * np.abs(lam).max() * rng.normal(size=(3, 3))   # not quite symmetric
    axis = _rotation(rng)[:, 0]
    mu = {"front": axis * rng.uniform(0.5, 8.0) + rng.normal(size=3) * rng.uniform(0, 3),
          "behind": -axis * rng.uniform(0.5, 8.0) + rng.normal(size=3) * rng.uniform(0, 3),
          "near_origin": rng.normal(size=3) * 10.0 ** rng.uniform(-12, -2),
          "side": _rotation(rng)[:, 1] * rng.uniform(0.1, 8.0)}[place]
    # rays of the cone: the axis, its edge all around, and its inside
    n = 64
    ang = np.concatenate([[0.0], np.full(n // 2, theta), theta * np.sqrt(rng.rand(n // 2))])
    az = rng.uniform(0, 2 * np.pi, ang.shape)
    e1, e2 = np.linalg.svd(axis[None])[2][1:]
    rays = (np.cos(ang)[:, None] * axis + np.sin(ang)[:, None]
            * (np.cos(az)[:, None] * e1 + np.sin(az)[:, None] * e2))
    rays = rays * rng.uniform(0.5, 2.0, (len(rays), 1))               # any length
    table = torch.zeros((1, 16), dtype=torch.float64)
    table[0, 4:13] = torch.as_tensor(lam.reshape(9))
    table[0, 13:16] = torch.as_tensor(mu)
    row = cf.cull_rows(table, THR_ACT)
    cones = cf.block_cones(torch.as_tensor(rays, dtype=torch.float64)[None, None], 1, len(rays))
    assert cones.shape == (1, 8)
    if not bool(cf.cull_mask_plain(cones, row)[0, 0]):
        return
    # a dropped pair: the quadratic form is at least thr_act everywhere on
    # every ray's line (its least value, and the value at the kernel's len)
    sym = 0.5 * (lam + lam.T)
    for r in rays:
        t_min = (r @ sym @ mu) / (r @ sym @ r)
        t_kern = (mu @ lam @ r) / (r @ lam @ r)        # A.r / ksk with A = Lambda^T mu
        for t in (t_min, t_kern, 0.0, -t_min):
            d = mu - t * r
            assert d @ lam @ d >= THR_ACT, (place, theta, d @ lam @ d)


def _camera_rays(B, H, W, focal, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.zeros((B, H, W, 3), np.float32)
    for b in range(B):
        d = np.stack([(xx - W / 2 + 0.5) / focal, (yy - H / 2 + 0.5) / focal,
                      np.ones_like(xx, dtype=np.float64)], -1)
        d = d @ _rotation(rng).T * (1.0 if b % 2 == 0 else -1.0)
        rays[b] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return rays


def _cull_scene(kind):
    """(rays (B, H, W, 3), table (B * P, 16), P): a mesh-like shell of large
    anisotropic Gaussians around the camera axis (ShapeFitting-like), a
    cloud of small isotropic ones with some behind the camera and one at the
    camera centre, or needles of axis ratio 1:100 (Lambda's condition 1e4) in
    every orientation, spread so that many lie at the edge of a block's cull
    (where float32 rounding of a long ``len r`` would show)."""
    rng = np.random.RandomState({"shell": 5, "cloud": 6, "needles": 8}[kind])
    B, H, W = 2, 21, 37
    rays = _camera_rays(B, H, W, 30.0, 7)
    centre = rays[:, H // 2, W // 2]                                # (B, 3)
    if kind == "shell":
        P = 180
        mus = centre[:, None] * 2.7 + rng.normal(size=(B, P, 3)) * 0.6
        a = rng.uniform(-1, 1, size=(B, P, 3, 3))
        lam = (np.einsum("bmij,bmkj->bmik", a, a) + 0.3 * np.eye(3)) * 80.0
    elif kind == "needles":
        P = 600
        mus = centre[:, None] * 3.0 + rng.uniform(-2.0, 2.0, size=(B, P, 3))
        mus[:, :60] -= centre[:, None] * 6.0                        # behind the camera
        sig = 0.3 * np.stack([np.ones((B, P)), 10.0 ** (-2.0 * rng.rand(B, P)),
                              np.full((B, P), 0.01)], -1)
        q = np.linalg.qr(rng.normal(size=(B, P, 3, 3)))[0]
        lam = np.einsum("bmij,bmj,bmkj->bmik", q, 1.0 / sig ** 2, q)
    else:
        P = 700
        mus = centre[:, None] * 4.0 + rng.uniform(-1.5, 1.5, size=(B, P, 3))
        mus[:, :40] -= centre[:, None] * 8.0                        # behind the camera
        mus[:, 40] = 0.0
        lam = np.broadcast_to(np.eye(3) * 2.0 / (2 * 0.03 ** 2), (B, P, 3, 3)).copy()
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    return t(rays), fine.feature_table(t(mus), t(lam)), P


@pytest.mark.parametrize("with_bits", [False, True])
@pytest.mark.parametrize("kind", ["shell", "cloud", "needles"])
def test_no_culled_pair_passes_the_hit_test(kind, with_bits, capsys):
    rays, table, P = _cull_scene(kind)
    B, H, W, _ = rays.shape
    bs = 5
    th, tw = cf.global_tile(with_bits, bs)
    cones = cf.block_cones(rays, th, tw)
    rows = cf.cull_rows(table, THR_ACT)
    nchunk = (th * tw - 1) // 128 + 1
    tiles = cf._tiles(rays, th, tw, float("nan"))                   # (nt, th*tw, 3)
    nt = tiles.shape[0]
    assert cones.shape == (nt * nchunk, 8) and rows.shape == (B * P, 4)
    pad = torch.full((nt, nchunk * 128 - th * tw, 3), float("nan"))
    blocks = torch.cat([tiles, pad], 1).reshape(nt * nchunk, 128, 3)
    img = torch.arange(nt * nchunk) // (nt // B * nchunk)
    culled_pairs = passing_pairs = both = at_edge = 0
    nudge = lambda rows, f: rows * torch.tensor([1.0, 1.0, 1.0, f])
    for b in range(B):
        sel = img == b
        r = [blocks[sel][:, :, None, i] for i in range(3)]
        _, act, _ = cf.hit_plain(table[b * P:(b + 1) * P][None, None], r)
        passing = act < THR_ACT                                     # NaN rays: False
        culled = cf.cull_mask_plain(cones[sel], rows[b * P:(b + 1) * P])
        # pairs within 5% of the bound, on either side of it
        at_edge += int((culled ^ cf.cull_mask_plain(
            cones[sel], nudge(rows[b * P:(b + 1) * P], 0.95))).sum())
        at_edge += int((culled ^ cf.cull_mask_plain(
            cones[sel], nudge(rows[b * P:(b + 1) * P], 1.05))).sum())
        both += int((passing & culled[:, None, :]).sum())
        culled_pairs += int(culled.sum())
        passing_pairs += int(passing.sum())
    assert both == 0
    assert passing_pairs > 0
    share = culled_pairs / (cones.shape[0] * P)
    with capsys.disabled():
        print(f"\n[cull {kind} bits={with_bits}] {share:.3f} of {cones.shape[0] * P} "
              f"(block, Gaussian) pairs culled; {passing_pairs} (ray, Gaussian) pairs pass")
    assert share > {"shell": 0.2, "cloud": 0.5, "needles": 0.1}[kind]
    assert at_edge > 0
    if kind == "cloud":
        assert not culled[:, 40].any()                  # |mu| = 0 is never culled


def test_cull_rows_never_cull_what_they_cannot_bound():
    table = torch.zeros((5, 16))
    table[:, 4:13] = torch.eye(3).reshape(9) * 50.0
    table[:, 13:16] = torch.tensor([0.0, 0.0, 3.0])
    table[1, 4] = -50.0                                             # indefinite
    table[2, 13:16] = 0.0                                           # at the camera
    table[3, 8] = float("nan")
    table[4, 15] = float("inf")
    rows = cf.cull_rows(table, THR_ACT)
    assert rows[0, 3] > 0 and torch.equal(rows[1:], torch.zeros((4, 4)))
    assert torch.equal(cf.cull_rows(table, -1.0), torch.zeros((5, 4)))
    # a block with a ray that is not finite, or with none, culls nothing
    rays = torch.nn.functional.normalize(torch.tensor([[0.1, 0.0, 1.0]]).repeat(16, 1), dim=-1)
    rays = rays.reshape(1, 1, 16, 3).clone()
    side = torch.zeros((1, 16))
    side[0, 4:13] = torch.eye(3).reshape(9) * 50.0
    side[0, 13:16] = torch.tensor([3.0, 0.0, 0.0])
    good = cf.cull_rows(side, THR_ACT)
    assert bool(cf.cull_mask_plain(cf.block_cones(rays, 1, 16), good).all())
    rays[0, 0, 3, 1] = float("nan")
    assert not bool(cf.cull_mask_plain(cf.block_cones(rays, 1, 16), good).any())


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       H=st.integers(1, 70), W=st.integers(1, 90),
       log_focal=st.floats(1.0, 3.0),
       G=st.integers(1, 8))
def test_super_cone_holds_every_ray_and_cone_of_its_tiles_in_float64(seed, H, W, log_focal, G):
    """The cone of a super-tile of G x G warps' tiles (4 x 8 pixels), as
    stored (float32), holds in float64 every ray of its tiles and every
    tile's stored cone with 1e-6 to spare (the slack the proof needs for the
    kernel's rounding of ``len r``), also where the image's edge cuts the
    super-tile; a cone at pi / 2 culls nothing."""
    rays = torch.as_tensor(_camera_rays(1, H, W, 10.0 ** log_focal, seed))
    th, tw = cf._WARP_TILE
    TH, TW = (H - 1) // th + 1, (W - 1) // tw + 1
    STH, STW = cf.super_grid(TH, TW, G)
    cones = cf.block_cones(rays, th, tw)
    sup = cf.super_cones(cones, 1, TH, TW, G)
    assert sup.shape == (STH * STW, 8) and torch.isfinite(sup).all()
    f64 = lambda x: x.to(torch.float64)
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)
    tiles = f64(cf._tiles(rays, th, tw, float("nan")))                     # (TH * TW, 128, 3)
    c_b, th_b = unit(f64(cones[:, :3])), torch.atan2(f64(cones[:, 3]), f64(cones[:, 4]))
    for t in range(STH * STW):
        c_t, th_t = unit(f64(sup[t, :3])), math.atan2(float(sup[t, 3]), float(sup[t, 4]))
        if th_t >= 0.5 * math.pi - 1e-6:
            assert float(sup[t, 4]) < 1e-4                                   # culls nothing
            continue
        sy, sx = divmod(t, STW)
        for by in range(sy * G, min(sy * G + G, TH)):
            for bx in range(sx * G, min(sx * G + G, TW)):
                q = by * TW + bx
                r = unit(tiles[q][torch.isfinite(tiles[q]).all(1)])
                assert r.shape[0] > 0
                ang = torch.acos((r @ c_t).clamp(-1.0, 1.0))
                assert float(ang.max()) <= th_t - 1e-6
                reach = math.acos(min(1.0, float(c_b[q] @ c_t))) + float(th_b[q])
                assert reach <= th_t - 1e-6


def _super_layout(rays, S):
    """The warps' tiles and super-tiles of ``S`` x ``S`` blocks of an image:
    (th, tw, TH, TW, super-tiles, the super-tile of each warp's tile)."""
    B, H, W, _ = rays.shape
    th, tw = cf._WARP_TILE
    TH, TW = (H - 1) // th + 1, (W - 1) // tw + 1
    STH, STW = cf.super_grid(TH, TW, 2 * S)
    q = torch.arange(TH * TW)
    return th, tw, TH, TW, STH * STW, (q // TW // (2 * S)) * STW + (q % TW) // (2 * S)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("kind", ["shell", "cloud", "needles"])
def test_level_one_keeps_every_survivor_of_its_warps(kind, S):
    """Level 1's mask (two cameras; at S = 2 the 3 x 3 blocks of a 21 x 37
    image make four super-tiles, three cut by the image's edge) keeps every
    Gaussian that a warp's own cone keeps, and drops none that passes the
    hit test for a ray of its super-tile; no bit at or past P."""
    rays, table, P = _cull_scene(kind)
    B = rays.shape[0]
    th, tw, TH, TW, nsup, st_of = _super_layout(rays, S)
    rows = cf.cull_rows(table, THR_ACT)
    cones, sup, grid = cf.two_level_cones(rays, S)
    assert grid == (TH, TW) and sup.shape == (B * nsup, 8)
    mask = cf.cull_lists(rows, sup, B, P)
    assert mask.shape == (B, nsup, cf._mask_words(P)) and mask.dtype == torch.int32
    kept = cf.mask_bits(mask, P)
    assert not cf.mask_bits(mask, mask.shape[2] * 32)[..., P:].any()      # nothing past P
    blocks = cf._tiles(rays, th, tw, float("nan"))                         # (B * TH * TW, 32, 3)
    for b in range(B):
        own = ~cf.cull_mask_plain(cones[b * TH * TW:(b + 1) * TH * TW], rows[b * P:(b + 1) * P])
        assert not (own & ~kept[b, st_of]).any()
        r = [blocks[b * TH * TW:(b + 1) * TH * TW][:, :, None, i] for i in range(3)]
        _, act, _ = cf.hit_plain(table[b * P:(b + 1) * P][None, None], r)
        passing = (act < THR_ACT).any(1)                                   # (blocks, P)
        assert passing.any() and not (passing & ~kept[b, st_of]).any()
    if S <= 2:
        assert float(kept.float().mean()) < 0.7                            # level 1 culls


def _tied(table, B, P, seed=11):
    """Every Gaussian of ``table`` (B * P, 16) three times, shuffled: exact
    ties in len."""
    perm = torch.as_tensor(np.random.RandomState(seed).permutation(3 * P))
    return table.reshape(B, P, 16).repeat(1, 3, 1)[:, perm].reshape(B * 3 * P, 16)


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("K,kind", [(8, "shell"), (8, "cloud"), (8, "needles"), (3, "ties"),
                                    (20, "ties")])
def test_two_level_plain_select_equals_the_plain_select(kind, K, S):
    """The plain two-level route (every warp's candidates: its super-tile's
    survivors that its own cone keeps) equals the plain select over every
    Gaussian to the bit: selections, their order, len / act / dsd and the
    weights; with three copies of each Gaussian the copies tie in len and
    the lower id wins."""
    rays, table, P = _cull_scene("cloud" if kind == "ties" else kind)
    B = rays.shape[0]
    if kind == "ties":
        table, P = _tied(table, B, P), 3 * P
    got = cf.fine_select_two_level_plain(rays, table, THR_ACT, K, 1.0, S)
    want = cf.fine_select_global_plain(rays, table, None, THR_ACT, K, 5, 1.0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    valid = got[0] >= 0
    assert valid.any()
    if kind == "ties":
        same = (got[1][..., 1:] == got[1][..., :-1]) & valid[..., 1:]
        assert same.any() and (got[0][..., 1:] > got[0][..., :-1])[same].all()


def _dense_lengths(rays, table, thr_act):
    """(n_rays, P) float32 lengths of the passing pairs (inf elsewhere)."""
    r = [rays.reshape(-1, 3)[:, None, i] for i in range(3)]
    length, act, _ = cf.hit_plain(table[None], r)
    return torch.where(act < thr_act, length, float("inf")).numpy()


def _streamed(lengths_row, K, batch, dropped):
    """Stable insertion with a strict '<' over candidates arriving in batches
    of ``batch``, those in ``dropped`` never arriving: positions kept."""
    keep_len, keep_pos = [], []
    for c0 in range(0, len(lengths_row), batch):
        for c in range(c0, min(c0 + batch, len(lengths_row))):
            ln = lengths_row[c]
            if c in dropped or not ln < np.inf:
                continue
            if len(keep_len) == K and not ln < keep_len[-1]:
                continue
            k = len(keep_len) if len(keep_len) < K else K - 1
            if len(keep_len) < K:
                keep_len.append(0.0), keep_pos.append(0)
            while k > 0 and ln < keep_len[k - 1]:
                keep_len[k], keep_pos[k] = keep_len[k - 1], keep_pos[k - 1]
                k -= 1
            keep_len[k], keep_pos[k] = ln, c
    return keep_pos


@pytest.mark.parametrize("K", [3, 8])
def test_selection_is_the_k_smallest_by_len_then_position(K):
    """On a table with duplicated Gaussians (exact ties in len): the plain
    select's choices, a lexicographic sort by (len, position), and the
    kernel's streaming insertion over batched, partly dropped candidates all
    agree."""
    rng = np.random.RandomState(9)
    rays = torch.as_tensor(_camera_rays(1, 6, 7, 12.0, 3))
    P0 = 40
    mus = np.concatenate([rng.uniform(-0.5, 0.5, (P0, 2)), rng.uniform(2, 4, (P0, 1))], -1)
    lam = np.broadcast_to(np.eye(3) * 6.0, (P0, 3, 3))
    dup = rng.permutation(np.concatenate([np.arange(P0)] * 3))      # every Gaussian thrice
    centre = rays[0, 3, 3].numpy()
    mus = (mus[dup] @ np.linalg.svd(centre[None])[2][[1, 2, 0]]).astype(np.float32)
    table = fine.feature_table(torch.as_tensor(mus)[None],
                               torch.as_tensor(lam[dup].astype(np.float32))[None])
    idx = cf.fine_select_global_plain(rays, table, None, THR_ACT, K, 2, 1.0)[0]
    idx = idx.reshape(-1, K).numpy()
    lengths = _dense_lengths(rays, table, THR_ACT)
    assert (np.isfinite(lengths).sum(1) > K).any()                   # some rays overflow K
    ties = 0
    for ray, row in enumerate(lengths):
        order = np.lexsort((np.arange(len(row)), row))[:K]           # by len, then position
        want = [int(c) for c in order if np.isfinite(row[c])]
        got = [int(c) for c in idx[ray] if c >= 0]
        assert got == want
        ties += len(set(row[want])) < len(want)
        # dropped candidates never pass, as the cull guarantees
        dropped = set(np.flatnonzero(~np.isfinite(row))[::2].tolist())
        assert _streamed(row, K, 16, dropped) == want
    assert ties > 0


def _row_scene():
    gj = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6, as_obj=True)
    R, T = look_at_view_transform(dist=6, elev=10, azim=70)
    focal, principal = np.array([[75.0, 75.0]], np.float32), np.array([[32.0, 32.0]], np.float32)
    return gj, np.array(R), np.array(T), focal, principal


@pytest.mark.parametrize("mppb", [None, 300])
def test_compacted_rows_are_as_wide_as_the_densest_supertile(mppb):
    gj, R, T, focal, principal = _row_scene()
    t = lambda x: torch.as_tensor(np.array(x, np.float32))
    from voge_tpu_torch.aggregation import expend_sigma
    from voge_tpu_torch.rays import camera_rays

    cams = (t(R), t(T), t(focal), t(principal))
    _, origins = camera_rays(*cams, (64, 64))
    points = t(gj.verts)[None] - origins[:, None, :]
    isig = 2.0 * expend_sigma(t(gj.sigmas))[None]
    c = fine.compact_candidates(*cams, points, isig, (64, 64), 0.01, 20,
                                max_points_per_bin=mppb)
    P = points.shape[1]
    cc = fine._pick_cand_chunk(P)
    densest = int(c.counts_c.max())
    exact = -(-densest // cc) * cc
    assert int(c.overflow_c.sum()) == 0
    if mppb is None:
        assert c.pos_c.shape[1] == exact
    else:
        nst = c.pos_c.shape[0]
        floor = fine._pick_m_max(1024, nst, cc, 4 * c_mppb(P, mppb))
        assert c.pos_c.shape[1] == max(floor, exact) and floor > exact


def c_mppb(P, mppb):
    return fine.production_bin_geometry((64, 64), 20, P, None, mppb)[1]


def test_render_is_the_same_at_either_row_width_and_equals_voge_tpu():
    gj, R, T, focal, principal = _row_scene()
    colors = (np.asarray(gj.verts) + 1) / 3
    t = lambda x: torch.as_tensor(np.array(x, np.float32))
    frags = []
    for mppb in (None, 1000):
        frags.append(vt.render_pipeline(t(gj.verts), t(gj.sigmas), t(R), t(T), t(focal),
                                        t(principal), image_size=(64, 64), max_assign=20,
                                        max_point_per_bin=mppb, attrs=t(colors)))
    a, b = frags
    assert int(a.overflow_points) == 0 == int(b.overflow_points)
    for name in ("vert_index", "vert_weight", "vert_hit_length", "attr_img"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    frag_j = jr.render_pipeline(gj.verts, gj.sigmas, R, T, jnp.asarray(focal),
                                jnp.asarray(principal), image_size=(64, 64), max_assign=20,
                                max_point_per_bin=1000, attrs=jnp.asarray(colors))
    agree = (a.vert_index.numpy() == np.asarray(frag_j.vert_index)).all(-1)
    assert 1.0 - agree.mean() < 1e-3
    np.testing.assert_allclose(a.vert_weight.numpy()[agree],
                               np.asarray(frag_j.vert_weight)[agree], rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.attr_img.numpy()[agree], np.asarray(frag_j.attr_img)[agree],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["numpy64", "list", "tensor64"])
def test_renderer_takes_any_array_for_its_camera_kwargs(kind):
    """``renderer(gmesh, R=R, T=T)`` with float64 numpy arrays, lists or
    float64 tensors gives the fragments of float32 tensors."""
    gj, R, T, _, _ = _row_scene()
    g, _ = vt.scene_from_numpy(np.asarray(gj.verts), np.asarray(gj.sigmas), None, device="cpu")
    cam = vt.PerspectiveCameras(focal_length=75.0, principal_point=((32.0, 32.0),),
                                image_size=((64, 64),), device="cpu")
    rend = vt.GaussianRenderer(cam, vt.GaussianRenderSettings(image_size=(64, 64)))
    want = rend(g, R=torch.as_tensor(R, dtype=torch.float32),
                T=torch.as_tensor(T, dtype=torch.float32))
    conv = {"numpy64": lambda x: np.asarray(x, np.float64),
            "list": lambda x: np.asarray(x, np.float32).tolist(),
            "tensor64": lambda x: torch.as_tensor(np.asarray(x, np.float32)).double()}[kind]
    got = rend(g, R=conv(R), T=conv(T))
    assert rend.cameras.R.dtype == torch.float32 and rend.cameras.T.dtype == torch.float32
    assert (got.vert_index >= 0).any()
    for name in ("vert_index", "vert_weight", "vert_hit_length", "valid_num"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
