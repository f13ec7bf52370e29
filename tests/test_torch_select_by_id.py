"""K2's compacted entry (``ops.cuda_fine.fine_select``) reads each
candidate's feature row from the (B * P, 16) table by the slot's id; before,
the forward copied one row a slot into an (nb, M, 16) table by ``pos_c`` and
the select read that copy.  On the CPU (the plain route):

- the select by id equals that gather-then-select to the bit, on the port's
  own coarse stage and on seeded slots that hold pads (id -1), a supertile
  whose counted slots name the table's last row (B * P - 1) and B = 3;
- ``FineSelect``'s fragments on the golden file's scene (the 1K cuboid at
  128x128, K = 20, colours) equal the gather-then-select's and
  ``render_pipeline``'s, and hold to ``voge_tpu``'s golden file within the
  card's tests' tolerances (``tests/cuda_common.py``);
- a counted slot whose id names no row of the table is no candidate;
- the wrapper refuses a per-slot table.

The kernel against the plain version, at the main paths' shapes and with
the table at the end of mapped memory, is ``tests/test_torch_cuda_paths.py``'s.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from voge_tpu_torch.ops import coarse, cuda_fine as cf, fine
from voge_tpu_torch.ops.cuda_attr import attr_merge_plain

from cuda_common import FLIP_MAX, THR_ACT, W_TOL, scene, stage_inputs

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / "data" / "voge_tpu_golden_1k_128.npz"


def gather_then_select(rays, table, pos_c, bits_c, ids_c, counts_c, thr_act, K, bin_size,
                       agg_ow, attrs=None):
    """The select as it stood before it read rows by id: every slot's row
    copied from ``table`` (B * P, 16) by ``pos_c`` into (nb, M, 16), then the
    dense select over the slots below each supertile's count whose sub-bin
    bit is set."""
    B, H, W, _ = rays.shape
    nb, M = pos_c.shape
    P = table.shape[0] // B
    img_row = torch.arange(nb)[:, None] // (nb // B)
    table_c = table[(img_row * P + pos_c).reshape(-1).long()].reshape(nb, M, 16)
    st = 2 * bin_size
    lr, lc = torch.arange(st * st) // st, torch.arange(st * st) % st
    g = (2 * (lr // bin_size) + lc // bin_size)[None, :, None]
    slots = torch.arange(M)

    def member(s0, s1):
        bit = (bits_c[s0:s1, None, :].to(torch.int64) >> g) & 1
        return (bit > 0) & (slots[None, None, :] < counts_c[s0:s1, None, None])

    idx, sl, sa, sd = cf._select_tiles_plain(cf._supertile(rays, bin_size), table_c, ids_c,
                                             member, thr_act, K)
    w = cf._weights_plain(sl, sa, sd, agg_ow)
    to_img = lambda x: cf._to_image(x, B, H, W, bin_size).contiguous()
    idx, w = to_img(idx.to(torch.int32)), to_img(w)
    img = None if attrs is None else attr_merge_plain(idx, w, attrs)
    return idx, to_img(sl), to_img(sa), to_img(sd), w, img


def _coarse_case():
    """Two cameras on 60 random Gaussians at 36x44: the port's coarse
    stage's slots."""
    import voge_tpu_torch as vt
    from voge_tpu_torch.rays import camera_rays

    B, P, H, W = 2, 60, 36, 44
    rng = np.random.RandomState(5)
    mus = torch.tensor(rng.uniform(-1, 1, size=(P, 3)).astype(np.float32) * 0.8)
    a = rng.uniform(-1, 1, size=(P, 3, 3)).astype(np.float32)
    isig = torch.tensor((np.einsum("pij,pkj->pik", a, a) + 2 * np.eye(3, dtype=np.float32)) * 4)
    R, T = vt.look_at_view_transform(dist=[4.0, 4.5], elev=[5.0, 20.0], azim=[10.0, 40.0],
                                     device="cpu")
    cams = (R, T, torch.full((B, 2), 60.0), torch.tensor([[W / 2, H / 2]] * B))
    rays, origins = camera_rays(*cams, (H, W))
    points = mus[None] - origins[:, None, :]
    isg = isig[None].expand(B, P, 3, 3).contiguous()
    c = fine.compact_candidates(*cams, points, isg, (H, W), 0.01, 20)
    return (rays, fine.feature_table(points, isg), c.pos_c, c.bits_c, c.ids_c, c.counts_c,
            c.thr_act, c.bin_size)


def _seeded_case():
    """B = 3 images of 80 Gaussians, camera-centred, at 30x38 (supertiles of
    12 x 12 pixels), and seeded slots (M = 48): ascending positions, random
    sub-bin bits, counts from 0 to M, pads of position 0 and id -1; the last
    supertile's counted slots end with the last Gaussian of the last image,
    row B * P - 1 of the table, a wide Gaussian nearer than any other."""
    B, P, H, W, bs, M = 3, 80, 30, 38, 6, 48
    gen = torch.Generator().manual_seed(21)
    u = lambda *s: torch.rand(*s, generator=gen)
    ys, xs = torch.meshgrid(torch.arange(H) + 0.5, torch.arange(W) + 0.5, indexing="ij")
    d = torch.stack([(xs - W / 2) / 40.0, (ys - H / 2) / 40.0, torch.ones_like(xs)], -1)
    rays = (d / d.norm(dim=-1, keepdim=True))[None].expand(B, H, W, 3).contiguous()
    z = 3.0 + 2.0 * u(B, P)
    points = torch.stack([(u(B, P) - 0.5) * 0.9 * z, (u(B, P) - 0.5) * 0.9 * z, z], -1)
    a = u(B, P, 3, 3) * 2 - 1
    isg = (a @ a.transpose(-1, -2) + 2 * torch.eye(3)) * 4.0
    points[-1, -1] = torch.tensor([0.0, 0.0, 1.5])
    isg[-1, -1] = 0.05 * torch.eye(3)
    table = fine.feature_table(points, isg)
    BH2, BW2 = coarse.supertile_grid(H, W, bs)
    nb = B * BH2 * BW2
    counts = torch.randint(0, M + 1, (nb,), generator=gen)
    counts[0], counts[1], counts[-1] = 0, M, max(int(counts[-1]), 1)
    pos = torch.zeros((nb, M), dtype=torch.int64)
    for s in range(nb):
        pick = torch.randperm(P, generator=gen)[:int(counts[s])]
        if s == nb - 1:
            pick = torch.cat([torch.randperm(P - 1, generator=gen)[:int(counts[s]) - 1],
                              torch.tensor([P - 1])])
        pos[s, :len(pick)] = pick.sort().values
    occupied = torch.arange(M)[None] < counts[:, None]
    img = torch.arange(nb)[:, None] // (BH2 * BW2)
    ids = torch.where(occupied, img * P + pos, -1).to(torch.int32)
    bits = torch.randint(1, 16, (nb, M), generator=gen, dtype=torch.int32)
    assert int(ids[-1, int(counts[-1]) - 1]) == B * P - 1
    return (rays, table, pos.to(torch.int32), bits, ids, counts.to(torch.int32), THR_ACT, bs)


@pytest.mark.parametrize("with_attrs", [False, True])
@pytest.mark.parametrize("K", [5, 20])
@pytest.mark.parametrize("case", ["coarse", "seeded"])
def test_select_by_id_equals_gather_then_select(case, K, with_attrs):
    rays, table, pos_c, bits_c, ids_c, counts_c, thr_act, bs = (
        _coarse_case() if case == "coarse" else _seeded_case())
    B = rays.shape[0]
    assert B > 1 and (ids_c < 0).any()
    gen = torch.Generator().manual_seed(K)
    attrs = torch.rand((table.shape[0], 5), generator=gen) if with_attrs else None
    got = cf.fine_select(rays, table, bits_c, ids_c, counts_c, thr_act, K, bs, 0.9, attrs)
    want = gather_then_select(rays, table, pos_c, bits_c, ids_c, counts_c, thr_act, K, bs,
                              0.9, attrs)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    assert (got[0] >= 0).any() and (got[0] < 0).any()
    if case == "seeded":
        assert (got[0] == table.shape[0] - 1).any()      # the table's last row selected


@pytest.mark.parametrize("case", ["coarse", "seeded"])
def test_a_counted_slot_whose_id_names_no_row_is_no_candidate(case):
    """Counted slots whose ids are -1 or past the table's rows select as if
    their sub-bin bits were clear."""
    rays, table, _, bits_c, ids_c, counts_c, thr_act, bs = (
        _coarse_case() if case == "coarse" else _seeded_case())
    s = int(counts_c.argmax())
    assert int(counts_c[s]) > 2
    bad, clear = ids_c.clone(), bits_c.clone()
    bad[s, :2] = torch.tensor([-1, table.shape[0]], dtype=torch.int32)
    clear[s, :2] = 0
    got = cf.fine_select(rays, table, bits_c, bad, counts_c, thr_act, 20, bs, 0.9)
    want = cf.fine_select(rays, table, clear, ids_c, counts_c, thr_act, 20, bs, 0.9)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


def test_fine_select_fragments_on_the_golden_scene():
    """``FineSelect`` (the compacted route's forward) on the golden file's
    scene: its outputs equal the gather-then-select's and
    ``render_pipeline``'s fragments to the bit, and hold to ``voge_tpu``'s
    render (flips under FLIP_MAX, weights and image within W_TOL)."""
    import voge_tpu_torch as vt

    hw = (128, 128)
    g, cams, colors = scene(1000, hw, 150.0, "cpu")
    rays, points, isig = stage_inputs(g, cams, hw)
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, 20)
    with torch.no_grad():
        got = fine.FineSelect.apply(points, isig, rays.contiguous(), colors[None], None, c, 20,
                                    1.0, True)
        frag = vt.render_pipeline(g.verts, g.sigmas, *cams, image_size=hw, max_assign=20,
                                  attrs=colors)
    want = gather_then_select(rays, fine.feature_table(points, isig), c.pos_c, c.bits_c,
                              c.ids_c, c.counts_c, c.thr_act, 20, c.bin_size, 1.0, colors)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert torch.equal(frag.vert_index, got[0]) and torch.equal(frag.vert_weight, got[4])
    assert torch.equal(frag.attr_img, got[5])
    gold = np.load(GOLDEN)
    agree = (got[0] == torch.as_tensor(gold["vert_index"])).all(-1)
    assert 1.0 - agree.float().mean().item() < FLIP_MAX
    for name, val in (("vert_weight", got[4]), ("attr_img", got[5])):
        ref = torch.as_tensor(gold[name])
        assert (val[agree] - ref[agree]).abs().max().item() <= W_TOL, name


@pytest.mark.parametrize("table", ["per_slot", "rows_not_a_multiple_of_B", "wide_rows"])
def test_the_wrapper_refuses_a_table_that_is_not_the_feature_rows(table):
    rays, feats, pos_c, bits_c, ids_c, counts_c, thr_act, bs = _coarse_case()
    bad = {"per_slot": lambda: feats[pos_c.long()],
           "rows_not_a_multiple_of_B": lambda: feats[1:],
           "wide_rows": lambda: torch.cat([feats, feats[:, :1]], 1)}[table]()
    with pytest.raises(ValueError):
        cf.fine_select(rays, bad, bits_c, ids_c, counts_c, thr_act, 20, bs, 1.0)
