"""The plain versions of K3f and K4b (``attr_merge_plain``, ``attr_dw_plain``,
``attr_merge_bwd_plain``) against ``voge_tpu``'s Pallas kernels in interpret
mode at the attribute merge's edge shapes: one and five and 33 channels, one
and 128 slots a pixel, a pixel count that no block size divides, ids of -1
and ids at or beyond the table; and the cache behind the kernel wrappers'
C entries (``ops._dispatch.bind``).

The Pallas kernels take candidate planes: here one image whose 128 candidate
columns hold ids 0 .. 99 in order (the rest padding, id -1, zero planes), so
column j is attribute row j.  An id beyond the table matches no column and
reads nothing, which is the port's contract; ``attr_merge_plain`` indexes
rows directly, so it is given such ids as -1.

Tolerance: the image and d_w to atol 1e-5 (f32 sums in another order, values
within [0, 1]: weights summing to at most 1 a pixel), d_attr rtol 1e-5 and
atol 1e-5, as in ``tests/test_torch_attr.py``."""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voge_tpu.ops.pallas_attr import (
    attr_merge_bwd_unified_pallas, attr_merge_bwd_w_pallas, attr_merge_fwd_pallas,
)
from voge_tpu_torch.ops import _dispatch, cuda_attr
from voge_tpu_torch.ops.cuda_attr import attr_dw_plain, attr_merge_bwd_plain, attr_merge_plain

torch.set_num_threads(2)

N_ROWS, P_PAD, CHUNK = 100, 128, 128
NB, R = 3, 37                       # 111 pixels in three bins of one image
CASES = [(d, K) for d in (1, 5, 33) for K in (1, 128)]
_cache = {}


def _case(d, K):
    """Inputs and the Pallas kernels' outputs (interpret mode) for one shape,
    once a shape."""
    if (d, K) in _cache:
        return _cache[(d, K)]
    rng = np.random.RandomState(100 + 7 * d + K)
    sel = rng.randint(-N_ROWS // 4, N_ROWS + 12, size=(NB, R, K)).clip(min=-1).astype(np.int32)
    sel[0, 0] = N_ROWS                  # ids at and beyond the table
    sel[0, 1] = -1
    w = (rng.uniform(0, 1, size=(NB, R, K)) / K).astype(np.float32)
    w_eff = np.where(sel >= 0, w, 0.0).astype(np.float32)
    attrs = rng.uniform(0, 1, size=(N_ROWS, d)).astype(np.float32)
    g = rng.normal(size=(NB, R, d)).astype(np.float32)
    ca = -(-d // 8) * 8
    planes = np.zeros((1, ca, P_PAD), np.float32)
    planes[0, :d, :N_ROWS] = attrs.T
    ids_p = np.full((1, 1, P_PAD), -1, np.int32)
    ids_p[0, 0, :N_ROWS] = np.arange(N_ROWS)
    mask = np.ones((NB, 1, P_PAD), np.int8)
    g_pad = np.zeros((NB, R, ca), np.float32)
    g_pad[..., :d] = g
    j = lambda x: jnp.asarray(x)
    img = np.asarray(attr_merge_fwd_pallas(j(planes), j(w_eff), j(sel), j(mask), j(ids_p), NB,
                                           CHUNK, interpret=True))[..., :d]
    d_w = np.asarray(attr_merge_bwd_w_pallas(j(planes), j(sel), j(mask), j(ids_p), j(g_pad), K,
                                             NB, CHUNK, interpret=True))
    d_attr_u, d_w_u = attr_merge_bwd_unified_pallas(j(planes), j(w_eff), j(sel), j(mask),
                                                    j(ids_p), j(g_pad), NB, CHUNK,
                                                    interpret=True)
    d_attr = np.asarray(d_attr_u)[0, :d, :N_ROWS].T
    t = torch.as_tensor
    port = dict(idx=t(sel.reshape(NB * R, K)), w=t(w.reshape(NB * R, K)), attrs=t(attrs),
                g=t(g.reshape(NB * R, d)))
    want = dict(img=img.reshape(NB * R, d), d_w=d_w.reshape(NB * R, K),
                d_w_u=np.asarray(d_w_u).reshape(NB * R, K), d_attr=d_attr)
    _cache[(d, K)] = port, want
    return port, want


@pytest.mark.parametrize("d, K", CASES)
def test_plain_attr_merge_matches_pallas_at_edges(d, K):
    port, want = _case(d, K)
    idx = port["idx"]
    got = attr_merge_plain(torch.where(idx < N_ROWS, idx, -1), port["w"], port["attrs"])
    assert got.shape == (NB * R, d) and np.abs(want["img"]).max() > 0.01
    np.testing.assert_allclose(got.numpy(), want["img"], rtol=0, atol=1e-5)
    # the slots beyond the table, read as empty, add nothing
    assert (idx >= N_ROWS).any() and (idx < 0).any()


@pytest.mark.parametrize("d, K", CASES)
def test_plain_attr_dw_matches_pallas_at_edges(d, K):
    port, want = _case(d, K)
    got = attr_dw_plain(port["idx"], port["attrs"], port["g"])
    assert got.shape == (NB * R, K) and np.abs(want["d_w"]).max() > 0.01
    np.testing.assert_allclose(got.numpy(), want["d_w"], rtol=0, atol=1e-5)
    outside = (port["idx"] < 0) | (port["idx"] >= N_ROWS)
    assert outside.any() and not got[outside].any()


@pytest.mark.parametrize("d, K", CASES)
def test_plain_attr_merge_bwd_matches_pallas_at_edges(d, K):
    port, want = _case(d, K)
    d_w, d_attr = attr_merge_bwd_plain(port["idx"], port["w"], port["attrs"], port["g"])
    np.testing.assert_allclose(d_w.numpy(), want["d_w_u"], rtol=0, atol=1e-5)
    assert d_attr.shape == (N_ROWS, d) and np.abs(want["d_attr"]).max() > 0.01
    np.testing.assert_allclose(d_attr.numpy(), want["d_attr"], rtol=1e-5, atol=1e-5)
    assert torch.equal(d_w, attr_dw_plain(port["idx"], port["attrs"], port["g"]))


class _Entry:
    """A stand-in for a ctypes function: counts assignments of argtypes."""

    def __init__(self):
        self.assigned = 0
        self._argtypes = None
        self.restype = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.assigned += 1
        self._argtypes = value


def test_bind_assigns_argtypes_once_a_symbol(monkeypatch):
    """Across many calls ``bind`` loads each library's entry once, assigns its
    argtypes and restype once, and hands back the same function."""
    entries, loads = {}, []

    class _Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, symbol):
            return entries.setdefault((self.name, symbol), _Entry())

    def stub_load(name):
        loads.append(name)
        return _Lib(name)

    monkeypatch.setattr(_dispatch, "load", stub_load)
    monkeypatch.setattr(_dispatch, "_bound", {})
    argtypes = (_dispatch.VOIDP,) * 4 + (_dispatch.LONG, _dispatch.INT)
    got = [_dispatch.bind("lib_a", sym, argtypes) for _ in range(50) for sym in ("f", "g")]
    got += [_dispatch.bind("lib_b", "f", argtypes, _dispatch.LONG) for _ in range(50)]
    assert sorted(loads) == ["lib_a", "lib_a", "lib_b"]
    assert set(entries) == {("lib_a", "f"), ("lib_a", "g"), ("lib_b", "f")}
    for (lib, sym), entry in entries.items():
        assert entry.assigned == 1 and entry.argtypes == list(argtypes)
        assert entry.restype == (_dispatch.LONG if lib == "lib_b" else _dispatch.INT)
        assert got.count(entry) == 50


def test_attr_wrappers_bind_their_entries_once():
    """The attribute family's wrappers reach their C entries through ``bind``
    only: no argtypes are assigned in the module, and every entry they name
    has its argument list beside it."""
    src = inspect.getsource(cuda_attr)
    assert ".argtypes" not in src and "load(" not in src
    entries = [v for k, v in vars(cuda_attr).items() if k.isupper() and isinstance(v, tuple)
               and len(v) >= 3 and isinstance(v[0], str)]
    assert {e[1] for e in entries} == {
        "voge_attr_merge", "voge_slot_runs", "voge_slot_runs_scratch", "voge_attr_dw",
        "voge_attr_scatter", "voge_attr_merge_bwd"}
    for lib, _symbol, argtypes, *_ in entries:
        assert lib in ("attr_merge", "attr_merge_bwd", "slot_runs")
        assert all(a in (_dispatch.VOIDP, _dispatch.INT, _dispatch.LONG) for a in argtypes)
