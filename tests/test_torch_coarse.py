"""Coarse emission of the port (``voge_tpu_torch.ops.coarse`` on the plain
version of kernel K1) against ``voge_tpu``'s Pallas emission kernel run in
interpret mode (``emit_supertile_candidates(..., _force="kernel")``), on the
cases of ``tests/test_ops.py::test_emit_kernel_matches_xla_emission``.
Candidate rows are integer outputs: they must match exactly."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voge_tpu.cameras import look_at_view_transform
from voge_tpu.ops import coarse as jcoarse
from voge_tpu.rays import camera_rays
from voge_tpu_torch.ops import coarse as tcoarse
from voge_tpu_torch.ops.cuda_coarse import emit_keys, emit_keys_plain

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
    """On CPU tensors the K1 wrapper runs the plain version, launches
    nothing, and the keys are int64."""
    cams, pts, isig, hw = _inputs("plain", B=2)
    args = ([torch.as_tensor(c) for c in cams]
            + [torch.as_tensor(pts), torch.as_tensor(isig), 0.01, 10, hw,
               6, 2, 3, 64, 3])
    before = emit_keys.launches
    a = emit_keys(*args)
    b = emit_keys_plain(*args)
    assert emit_keys.launches == before
    assert a[0].dtype == torch.int64
    for x, y in zip(a, b):
        assert torch.equal(x, y)
