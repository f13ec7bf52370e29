"""The port's converters against ``voge_tpu``'s on the same numpy inputs
(``tests/test_converters.py:29-70`` are the twins against the reference).

Both packages compute in numpy float64 and return float32, so most outputs
are equal or within float32 rounding (rtol 1e-6).  ``voge_tpu`` takes its
C++ helpers where they are built (float32 edge lengths and a grid-accelerated
k-NN), the port vectorised numpy and a chunked ``torch.cdist`` + ``topk``:
the k-NN distances agree to float32 rounding of the squared differences
(rtol 1e-5 on the inverse sigmas).
"""
import os

import numpy as np
import pytest
import torch

from voge_tpu.converter import converters as jconv
from voge_tpu.meshes import GaussianMeshes as JGaussianMeshes
import voge_tpu_torch as vt
from voge_tpu_torch.converter import converters

torch.set_num_threads(2)


def _rand_mesh(rng, n=40, f=60):
    verts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    faces = rng.randint(0, n, size=(f, 3)).astype(np.int64)
    return verts, faces


def test_look_at_rotation_np_equals_voge_tpu():
    rng = np.random.RandomState(0)
    cp = rng.normal(size=(30, 3))
    cp[3] = [0.0, 2.0, 0.0]                        # up parallel to the view axis
    np.testing.assert_array_equal(converters._look_at_rotation_np(cp),
                                  jconv._look_at_rotation_np(cp))


@pytest.mark.parametrize("max_sig_rate", [-1, 1.5])
def test_normal_mesh_converter_matches_voge_tpu(max_sig_rate):
    rng = np.random.RandomState(1)
    verts, faces = _rand_mesh(rng)
    normals = rng.normal(size=(verts.shape[0], 3))
    normals = (normals / np.linalg.norm(normals, axis=-1, keepdims=True)).astype(np.float32)
    kw = dict(percentage=0.5, shape_ratio=0.4, max_sig_rate=max_sig_rate)
    v, s, r = converters.normal_mesh_converter(torch.as_tensor(verts), faces, normals, **kw)
    vj, sj, _ = jconv.normal_mesh_converter(verts, faces, normals, **kw)
    assert r is None and s.dtype == np.float32 and s.shape == (40, 3, 3)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_allclose(s, sj, rtol=1e-5, atol=1e-5 * np.abs(sj).max())
    with pytest.raises(ValueError):
        converters.normal_mesh_converter(verts, faces, normals * 2.0)


@pytest.mark.parametrize("n,k", [(200, 4), (700, 6), (3, 4)])
def test_naive_point_cloud_converter_matches_voge_tpu(n, k):
    pts = np.random.RandomState(2).uniform(-1, 1, size=(n, 3)).astype(np.float32)
    v, s, r = converters.naive_point_cloud_converter(pts, percentage=0.5, n_nearest=min(k, n),
                                                     device="cpu")
    vj, sj, _ = jconv.naive_point_cloud_converter(pts, percentage=0.5, n_nearest=min(k, n))
    assert r is None and s.dtype == np.float32
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_allclose(s, sj, rtol=1e-5)


def test_knn_mean_dist_chunks_and_clips(monkeypatch):
    """Chunked rows give what one chunk gives; the clip at ``mean * thr_max``
    bites on an outlier; against a dense numpy evaluation."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    pts[0] = [5.0, 5.0, 5.0]                       # far from everything
    t = torch.as_tensor(pts)
    whole = converters.knn_mean_dist(t, 4, 1.2)
    monkeypatch.setattr(converters, "_KNN_CHUNK_ELEMS", 300 * 7)   # 7 rows at a time
    chunked = converters.knn_mean_dist(t, 4, 1.2)
    assert torch.equal(whole, chunked)
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    part = np.sort(d, axis=1)[:, :4]
    want = np.minimum(part, part.mean(1, keepdims=True) * 1.2).mean(1)
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-5)
    assert (np.minimum(part, part.mean(1, keepdims=True) * 1.2) < part).any()


def test_fixed_pointcloud_converter_matches_voge_tpu():
    pts = np.random.RandomState(4).uniform(-1, 1, size=(50, 3)).astype(np.float32)
    for radius in (0.003, 0.01, np.linspace(0.01, 0.02, 50)):
        v, s, r = converters.fixed_pointcloud_converter(pts, radius=radius)
        vj, sj, _ = jconv.fixed_pointcloud_converter(pts, radius=radius)
        assert r is None and s.dtype == np.float32 and s.shape == (50,)
        np.testing.assert_array_equal(v, vj)
        np.testing.assert_array_equal(s, sj)
    # tensors in: the same arrays out
    v, s, _ = converters.fixed_pointcloud_converter(torch.as_tensor(pts),
                                                    radius=torch.as_tensor(radius))
    np.testing.assert_array_equal(s, sj)


def test_to_gaussian_mesh_matches_voge_tpu_and_lands_on_the_device():
    pts = np.random.RandomState(5).uniform(-1, 1, size=(20, 3)).astype(np.float32)
    wrap = converters.to_gaussian_mesh(converters.fixed_pointcloud_converter, radius=0.02)
    g = wrap(pts, gradianted_args=[True, False, False], device="cpu")
    gj = jconv.to_gaussian_mesh(jconv.fixed_pointcloud_converter, radius=0.02)(
        pts, gradianted_args=[True, False, False])
    assert isinstance(g, vt.GaussianMeshes) and isinstance(gj, JGaussianMeshes)
    assert g.verts.device.type == "cpu" and g.verts.requires_grad and not g.sigmas.requires_grad
    np.testing.assert_array_equal(g.verts.detach().numpy(), np.asarray(gj.verts))
    np.testing.assert_array_equal(g.sigmas.numpy(), np.asarray(gj.sigmas))
    assert converters.pytorch3d2gaussian is converters.to_gaussian_mesh


def test_composed_converter_and_convert_path_write_what_voge_tpu_writes(tmp_path):
    """``convert_path`` over a directory tree with a ``ComposedConverter`` of
    the port's OFF loader, mesh converter and GOFF saver: the same files,
    byte for byte, as ``voge_tpu``'s pipeline writes."""
    from voge_tpu.converter import io as jio
    from voge_tpu_torch.converter import io as tio

    rng = np.random.RandomState(6)
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    for name in ("a.off", "skip.txt", os.path.join("sub", "b.off")):
        jio.save_off(str(src / name), *_rand_mesh(rng, n=12, f=16))
    only_off = lambda name: name.endswith(".off")
    convert = converters.ComposedConverter(tio.load_off, tio.save_goff,
                                           converters.naive_vertices_converter, percentage=0.6)
    convert_j = jconv.ComposedConverter(jio.load_off, jio.save_goff,
                                        jconv.naive_vertices_converter, percentage=0.6)
    converters.convert_path(str(src), str(tmp_path / "t"), convert, filter_=only_off)
    jconv.convert_path(str(src), str(tmp_path / "j"), convert_j, filter_=only_off)
    for name in ("a.off", os.path.join("sub", "b.off")):
        got = (tmp_path / "t" / name).read_text()
        want = (tmp_path / "j" / name).read_text()
        # the edge lengths may differ in the last float32 bit (see the module note)
        assert got.splitlines()[:14] == want.splitlines()[:14]
        np.testing.assert_allclose(tio.load_goff(str(tmp_path / "t" / name))[1],
                                   jio.load_goff(str(tmp_path / "j" / name))[1], rtol=1e-6)
    assert not (tmp_path / "t" / "skip.txt").exists()
