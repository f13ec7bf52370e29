"""The staged coarse stage (``ops.coarse._emit_candidates``: the emission K1,
``slot_runs``, the globals and rows kernels, here on their plain versions)
against the port's int64 route (``_emit_candidates_sorted``: one sort of
int64 keys, ``searchsorted``, row slicing) and against ``voge_tpu``'s Pallas
emission in interpret mode.  Every output is an integer: they must match
exactly."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_coarse import _inputs
from voge_tpu.ops import coarse as jcoarse
from voge_tpu.ops.pallas_coarse import emit_keys_pallas
from voge_tpu_torch.ops import coarse as tcoarse
from voge_tpu_torch.ops.cuda_attr import slot_runs_plain
from voge_tpu_torch.ops.cuda_coarse import (
    coarse_globals, coarse_globals_plain, coarse_rows, coarse_rows_plain, emit_rows_plain,
    pack_flags, unpack_flags,
)

torch.set_num_threads(2)
THR, BS = 0.01, 10


def _torch(cams, pts, isig):
    return [torch.as_tensor(c) for c in cams] + [torch.as_tensor(pts.copy()),
                                                torch.as_tensor(isig.copy())]


def _stage(args, hw, M_max, row_align=0, return_dst=False, n_globals=64, sorted_route=False):
    P = args[4].shape[1]
    win = tcoarse.emission_geometry(P, hw, BS)[-1]
    fn = tcoarse._emit_candidates_sorted if sorted_route else tcoarse._emit_candidates
    return fn(*args, hw, THR, BS, M_max, n_globals, row_align, return_dst, win)


def _assert_same(got, want):
    for i, (g, w) in enumerate(zip(got[:5], want[:5])):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    if len(want) > 5:
        for i, (g, w) in enumerate(zip(got[5], want[5])):
            assert g.dtype == w.dtype and torch.equal(g, w), f"dst {i}"


def _ascending(ids_c, counts_c):
    for r in range(ids_c.shape[0]):
        row = ids_c[r, :int(counts_c[r])]
        assert bool((row[1:] > row[:-1]).all()), r


def test_flag_words_round_trip():
    rng = np.random.RandomState(1)
    for P in (1, 31, 32, 33, 100):
        flags = torch.as_tensor(rng.uniform(size=(3, P)) < 0.4)
        words = pack_flags(flags)
        assert words.dtype == torch.int32 and words.shape == (3, (P + 31) // 32)
        assert torch.equal(unpack_flags(words, P), flags)
    assert int(pack_flags(torch.ones((1, 32), dtype=torch.bool))[0, 0]) == -1


@pytest.mark.parametrize("case,B", [("plain", 1), ("big", 1), ("big", 2)])
def test_emission_matches_pallas_keys(case, B):
    """K1's plain version: the row ids and bits, packed as ``voge_tpu``'s
    int32 keys, are the Pallas kernel's keys (interpret mode); the oversize
    flags are its flags and the planes its planes to a relative 1e-6 (XLA's
    CPU code may round a term once differently; the keys must not move)."""
    cams, pts, isig, hw = _inputs(case, B=B)
    P = pts.shape[1]
    nst, BH2, BW2, S, win = tcoarse.emission_geometry(P, hw, BS)
    keys, u, v, rx, ry, over = emit_keys_pallas(
        *[jnp.asarray(c) for c in cams], jnp.asarray(pts), jnp.asarray(isig), THR, BS, hw,
        nst, BH2, BW2, S, win=win, interpret=True)
    rid, bits, planes, words, info = emit_rows_plain(*_torch(cams, pts, isig), THR, BS, hw,
                                                     nst, BH2, BW2, win)
    p = torch.arange(P)[:, None]
    mine = torch.where(rid >= 0, (rid.long() * S + p) * 16 + bits.long(), B * nst * S * 16)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(keys))
    np.testing.assert_array_equal(unpack_flags(words, P).numpy(), np.asarray(over))
    for got, want in zip(planes.unbind(1), (u, v, rx, ry)):   # XLA may round once differently
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert bool((bits[rid < 0] == 0).all()) and bool((bits[rid >= 0] > 0).all())
    assert info.tolist()[:2] == [0, 0]
    assert int((rid >= 0).sum()) > 0 and bool(np.asarray(over).any()) == (case == "big")


@pytest.mark.parametrize("case,B", [("plain", 1), ("big", 1), ("big", 2)])
def test_globals_match_the_sorted_route(case, B):
    """The globals' plain version: members, validity and the densest row
    equal the int64 route's (and ``voge_tpu``'s inverse map's gpos /
    g_valid); the dropped count is the excess over ``n_globals``."""
    cams, pts, isig, hw = _inputs(case, B=B)
    args = _torch(cams, pts, isig)
    P = pts.shape[1]
    nst, BH2, BW2, _, win = tcoarse.emission_geometry(P, hw, BS)
    rid, _, planes, words, info = emit_rows_plain(*args, THR, BS, hw, nst, BH2, BW2, win)
    _, starts = slot_runs_plain(rid, B * nst)
    for ng in (min(64, P), 1, 0):         # the stage passes at most P
        inf = info.clone()
        gpos, g_valid, bits_g, gstat = coarse_globals(words, planes, starts, inf, ng, nst,
                                                      BW2, BS, hw)
        want = _stage(args, hw, 64, return_dst=True, n_globals=ng, sorted_route=True)
        assert torch.equal(gpos, want[5][2]) and torch.equal(g_valid, want[5][3])
        assert bits_g.shape == (B, ng, nst) and bits_g.dtype == torch.uint8
        n_over = unpack_flags(words, P).sum(1)
        assert gstat[:, 1].tolist() == (n_over - ng).clamp(min=0).tolist()
        assert gstat[:, 0].tolist() == n_over.clamp(max=ng).tolist()
        assert int(inf[0]) == int(want[3].max())        # rows of 64 hold every member
        assert int(inf[1]) == int(gstat[:, 1].max())
        if ng > 1:
            ref = jcoarse.emit_supertile_candidates(
                *[jnp.asarray(c) for c in cams], jnp.asarray(pts), jnp.asarray(isig), hw,
                THR, BS, 64, return_dst=True, _force="kernel")
            np.testing.assert_array_equal(gpos.numpy(), np.asarray(ref[5][2]))
            np.testing.assert_array_equal(g_valid.numpy(), np.asarray(ref[5][3]))


@pytest.mark.parametrize("case,B,M_max,row_align", [
    ("plain", 1, 64, 0), ("big", 1, 64, 0), ("big", 2, 64, 0), ("plain", 1, 8, 0),
    ("big", 2, 8, 0), ("plain", 2, 4, 8), ("big", 2, 0, 8)])
@pytest.mark.parametrize("return_dst", [False, True])
def test_staged_route_equals_the_sorted_route(case, B, M_max, row_align, return_dst):
    """The whole stage, fixed rows (``row_align`` 0: members past ``M_max``
    dropped and counted) and exact rows, with and without the inverse map:
    equal to the int64 route to the bit, every row ascending."""
    cams, pts, isig, hw = _inputs(case, B=B)
    args = _torch(cams, pts, isig)
    got = _stage(args, hw, M_max, row_align, return_dst)
    want = _stage(args, hw, M_max, row_align, return_dst, sorted_route=True)
    assert len(got) == len(want) == (6 if return_dst else 5)
    _assert_same(got, want)
    _ascending(got[2], got[3])
    if row_align == 0 and M_max == 8:
        assert int(got[4].sum()) > 0
    if row_align:
        assert int(got[4].sum()) == 0 and got[0].shape[1] % row_align == 0


def test_rows_plain_keeps_the_first_M():
    """The rows' plain version at one emission and several widths: the rows
    are prefixes of the widest, each drop counted, the map of a dropped slot
    -1."""
    cams, pts, isig, hw = _inputs("big", B=2)
    args = _torch(cams, pts, isig)
    P = pts.shape[1]
    nst, BH2, BW2, _, win = tcoarse.emission_geometry(P, hw, BS)
    rid, bits, planes, words, info = emit_rows_plain(*args, THR, BS, hw, nst, BH2, BW2, win)
    order, starts = slot_runs_plain(rid, 2 * nst)
    glob = coarse_globals_plain(words, planes, starts, info, 64, nst, BW2, BS, hw)
    wide = coarse_rows(order, starts, bits, glob[0], glob[2], glob[3], 64, nst, True)
    assert int(wide[4].sum()) == 0
    for M in (0, 1, 3, 8):
        got = coarse_rows_plain(order, starts, bits, glob[0], glob[2], glob[3], M, nst, True)
        for a, b in zip(got[:3], wide[:3]):
            assert torch.equal(a, b[:, :M])
        assert torch.equal(got[3], wide[3].clamp(max=M))
        assert torch.equal(got[4], wide[3] - got[3])
        for a, b in zip(got[5:], wide[5:]):
            assert torch.equal(a, torch.where(b % 64 < M, b // 64 * M + b % 64, -1))


def test_global_between_two_locals_keeps_rows_ascending():
    """A global member whose index lies between two local members of one
    row: the merge puts it between them (a grouping by row id alone would
    put it last), equal to the int64 route and to ``voge_tpu``."""
    cams, pts, isig, hw = _inputs("plain")
    args = _torch(cams, pts, isig)
    rows = _stage(args, hw, 64)
    r = int(rows[3].argmax())
    n = int(rows[3][r])
    assert n >= 3
    k = int(rows[2][r, n // 2])                 # a local member in the middle
    isig = isig.copy()
    isig[0, k] = np.eye(3, dtype=np.float32) * 5e-4
    args = _torch(cams, pts, isig)
    got = _stage(args, hw, 64, return_dst=True)
    gpos, g_valid = got[5][2], got[5][3]
    assert int(gpos[0, 0]) == k and bool(g_valid[0, 0]) and not bool(g_valid[0, 1:].any())
    row = got[2][r, :int(got[3][r])]
    assert bool((row < k).any()) and bool((row > k).any()) and k in row.tolist()
    _ascending(got[2], got[3])
    _assert_same(got, _stage(args, hw, 64, return_dst=True, sorted_route=True))
    ref = jcoarse.emit_supertile_candidates(
        *[jnp.asarray(c) for c in cams], jnp.asarray(pts), jnp.asarray(isig), hw, THR, BS,
        64, return_dst=True, _force="kernel")
    for g, w in zip(got[:5], ref[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(g.shape))
    for g, w in zip(got[5], ref[5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class _HostReads:
    """Count the reads of tensor values into Python."""
    NAMES = ("tolist", "item", "__int__", "__float__", "__bool__", "__index__")

    def __enter__(self):
        self.n = 0
        self.saved = {k: getattr(torch.Tensor, k) for k in self.NAMES}

        def spy(fn):
            def read(t, *a, **k):
                self.n += 1
                return fn(t, *a, **k)
            return read
        for k, fn in self.saved.items():
            setattr(torch.Tensor, k, spy(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(torch.Tensor, k, fn)


def test_a_render_reads_the_card_once_and_twice_when_it_reemits():
    """Exact rows: one read of the stage's info a render; a render whose
    oversize Gaussians outgrow the global list reads once more, after its
    second emission, and no more.  Fixed rows read nothing."""
    cams, pts, isig, hw = _inputs("plain")
    isig2 = isig.copy()
    isig2[0, 3] = isig2[0, 7] = np.eye(3, dtype=np.float32) * 0.7
    plain, wide = _torch(cams, pts, isig), _torch(cams, pts, isig2)
    for args, kw, reads in ((plain, dict(row_align=8), 1),
                            (wide, dict(row_align=8, n_globals=1), 2),
                            (wide, dict(row_align=8, n_globals=1, return_dst=True), 2),
                            (wide, dict(n_globals=1), 0)):
        with _HostReads() as spy:
            out = tcoarse.emit_supertile_candidates(*args, hw, THR, BS, 64, **kw)
        assert spy.n == reads, (kw, spy.n)
        if reads == 2:
            assert int(out[4].sum()) == 0 and (out[2] == 7).sum() == 6
