"""The port's shapes and mesh-vertex converter against ``voge_tpu``'s on the
same input.  Both are numpy: the icosphere and the OBJ loader give equal
arrays.  ``get_vert_edge_length`` sums float64 distances in the port;
``voge_tpu`` takes its C++ helper where it is built, which rounds each mean
to float32, so edge lengths and inverse sigmas agree to a relative 1e-6
(float32 rounding)."""
import numpy as np
import pytest
import torch

from voge_tpu.converter import converters as jconv
from voge_tpu.converter import shapes as jshapes
from voge_tpu_torch.converter import converters, shapes


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_ico_sphere_equals_voge_tpu(level):
    v, f = shapes.ico_sphere(level, radius=1.5)
    vj, fj = jshapes.ico_sphere(level, radius=1.5)
    assert v.dtype == np.float32 and f.dtype == np.int64
    assert v.shape == (10 * 4 ** level + 2, 3) and f.shape == (20 * 4 ** level, 3)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)


def test_load_obj_and_normals_equal_voge_tpu(tmp_path):
    v, f = jshapes.ico_sphere(1)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    lines += ["f 1/1 2/2 3/3 4/4"]                  # a quad, fan-triangulated
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in f]
    path = tmp_path / "sphere.obj"
    path.write_text("\n".join(lines) + "\n")
    got, want = shapes.load_obj(str(path)), jshapes.load_obj(str(path))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].shape == (f.shape[0] + 2, 3)
    np.testing.assert_array_equal(shapes.vertex_normals(*got), jshapes.vertex_normals(*want))


@pytest.mark.parametrize("level", [2, 4])
def test_edge_length_and_converter_match_voge_tpu(level):
    v, f = shapes.ico_sphere(level)
    default = jconv._default_l(v)
    assert converters._default_l(v) == default
    np.testing.assert_allclose(converters.get_vert_edge_length(v, f, default),
                               jconv.get_vert_edge_length(v, f, default), rtol=1e-6)
    for p in (0.5, 0.8):
        got = converters.naive_vertices_converter(v, f, percentage=p)
        want = jconv.naive_vertices_converter(v, f, percentage=p)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].dtype == np.float32 and got[2] is None
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def test_converter_takes_tensors_and_caps_sigma():
    v, f = shapes.ico_sphere(2)
    v[:5] *= 1.3                                    # uneven edges, so the cap bites
    got = converters.naive_vertices_converter(torch.as_tensor(v), torch.as_tensor(f),
                                              percentage=0.5, max_sig_rate=1.05)
    want = jconv.naive_vertices_converter(v, f, percentage=0.5, max_sig_rate=1.05)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert got[1].max() <= np.mean(1.0 / ((converters.get_vert_edge_length(
        v, f, converters._default_l(v)) ** 2) / (2 * np.log(2)) + 1e-10)) * 1.05 * (1 + 1e-6)
    assert (converters.get_vert_edge_length(v, np.zeros((0, 3), np.int64), 0.25) == 0.25).all()
