"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip elsewhere.  The
GPU machine has no JAX, so this file imports only torch and the port, and is
run there without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: K1 and K3f's inputs give equal outputs (K1 bit for bit, K3f to
1e-5: the kernel's sum may contract into FMAs); K2 selections equal but for
knife-edge pixels (< 0.1% flipped), len / act / dsd rtol 1e-5 atol 1e-5 and
weights / images atol 1e-4 on agreeing pixels.
"""
import numpy as np
import pytest
import torch

import voge_tpu_torch as vt
from voge_tpu_torch.aggregation import expend_sigma
from voge_tpu_torch.ops import coarse, fine
from voge_tpu_torch.ops.cuda_attr import attr_merge, attr_merge_plain
from voge_tpu_torch.ops.cuda_coarse import emit_keys, emit_keys_plain
from voge_tpu_torch.ops.cuda_fine import fine_select, fine_select_plain
from voge_tpu_torch.rays import camera_rays

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["random", "cuboid"])
def stage(request, dev):
    """Two cameras over a random anisotropic scene (with one oversize
    global member) or the 1K cuboid: rays, camera-centred points and
    precisions, colours."""
    B, hw = 2, (52, 60)
    if request.param == "random":
        rng = np.random.RandomState(3)
        verts = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
        a = rng.uniform(-1, 1, size=(400, 3, 3)).astype(np.float32)
        isig = (np.einsum("pij,pkj->pik", a, a) + 2 * np.eye(3, dtype=np.float32)) * 60.0
        isig[7] = np.eye(3, dtype=np.float32) * 1e-3
        verts, isig = torch.as_tensor(verts, device=dev), torch.as_tensor(isig, device=dev)
    else:
        g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000,
                                             percentage=0.6, as_obj=True, device=dev)
        verts, isig = g.verts.detach(), expend_sigma(g.sigmas.detach())
    R, T = vt.look_at_view_transform(dist=[4.5, 6.0], elev=[10.0, 35.0],
                                     azim=[70.0, -20.0], device=dev)
    cams = (R, T, torch.tensor([[70.0, 70.0], [60.0, 80.0]], device=dev),
            torch.tensor([[30.0, 26.0], [29.0, 25.0]], device=dev))
    rays, origins = camera_rays(*cams, hw)
    points = verts[None] - origins[:, None, :]
    isig = (2.0 * isig)[None].expand(B, -1, 3, 3)
    colors = torch.rand(B * verts.shape[0], 3, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    return cams, hw, rays, points, isig, colors


def test_emit_kernel_equals_plain(stage):
    cams, hw, _, points, isig, _ = stage
    bs = 10
    args = (*cams, points, isig, 0.01, bs, hw,
            *coarse.emission_geometry(points.shape[1], hw, bs))
    before = emit_keys.launches
    got = emit_keys(*args)
    want = emit_keys_plain(*args)
    torch.cuda.synchronize()
    assert emit_keys.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("K", [5, 20, 40])
@pytest.mark.parametrize("with_attrs", [False, True])
def test_select_kernel_matches_plain(stage, K, with_attrs):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
    args = (rays, c.table_c, c.bits_c, c.ids_c, c.counts_c, c.thr_act, K,
            c.bin_size, 0.9, colors if with_attrs else None)
    before = fine_select.launches
    got = fine_select(*args)
    want = fine_select_plain(*args)
    torch.cuda.synchronize()
    assert fine_select.launches == before + 1
    agree = (got[0] == want[0]).all(-1)
    assert 1.0 - agree.float().mean().item() < 1e-3
    assert (got[0] >= 0).any()
    for g, w in zip(got[1:4], want[1:4]):
        torch.testing.assert_close(g[agree], w[agree], rtol=1e-5, atol=1e-5)
    for g, w in zip(got[4:], want[4:]):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g[agree], w[agree], rtol=0, atol=1e-4)


def test_attr_kernel_matches_plain(stage):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, 20)
    idx, _, _, _, w, _ = fine_select_plain(rays, c.table_c, c.bits_c, c.ids_c,
                                           c.counts_c, c.thr_act, 20, c.bin_size, 1.0)
    before = attr_merge.launches
    got = attr_merge(idx, w, colors)
    assert attr_merge.launches == before + 1
    torch.testing.assert_close(got, attr_merge_plain(idx, w, colors), rtol=0, atol=1e-5)


def test_wrappers_check_their_inputs(stage):
    cams, hw, rays, points, isig, colors = stage
    c = fine.compact_candidates(*cams, points, isig, hw, 0.01, 20)
    with pytest.raises(TypeError):
        fine_select(rays, c.table_c, c.bits_c.long(), c.ids_c, c.counts_c,
                    c.thr_act, 20, c.bin_size, 1.0)
    with pytest.raises(ValueError):
        fine_select(rays.cpu(), c.table_c, c.bits_c, c.ids_c, c.counts_c,
                    c.thr_act, 20, c.bin_size, 1.0)
    with pytest.raises(ValueError):
        attr_merge(c.ids_c[:, ::2], torch.ones_like(c.table_c[:, ::2, 0]), colors)
