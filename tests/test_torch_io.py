"""The port's OFF / COFF / GOFF IO against ``voge_tpu``'s: the bytes written
for the same arrays are equal, and a file written by either package loads
in the other to equal arrays (text of 16 decimals, exact for float32)."""
import numpy as np
import pytest
import torch

from voge_tpu.converter import io as jio
from voge_tpu_torch.converter import io as tio

torch.set_num_threads(2)


def _mesh(seed, n=15, f=20):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, size=(n, 3)).astype(np.float32),
            rng.randint(0, n, size=(f, 3)).astype(np.int64))


@pytest.mark.parametrize("colors", ["none", "vert", "vert_and_face"])
def test_off_bytes_equal_and_cross_load(tmp_path, colors):
    verts, faces = _mesh(0)
    rng = np.random.RandomState(1)
    kw = {}
    if colors != "none":
        kw["vert_color"] = rng.uniform(size=(15, 3)).astype(np.float32)
    if colors == "vert_and_face":
        kw["face_color"] = rng.uniform(size=(20, 3)).astype(np.float32)
    mine, theirs = str(tmp_path / "t.off"), str(tmp_path / "j.off")
    tio.save_off(mine, torch.as_tensor(verts), faces, **kw)
    jio.save_off(theirs, verts, faces, **kw)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert open(mine).readline().strip() == ("OFF" if colors == "none" else "COFF")
    if colors != "vert_and_face":      # face colours go on their own lines: not loadable
        for path in (mine, theirs):
            got, want = tio.load_off(path), jio.load_off(path)
            assert len(got) == len(want) == (2 if colors == "none" else 3)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tio.load_off(theirs)[0], verts)
        np.testing.assert_array_equal(tio.load_off(theirs)[1], faces)
        v, f = tio.load_off(mine, ignore_color=True)[:2]
        np.testing.assert_array_equal(v, verts)
    if colors != "vert_and_face":
        got = tio.load_off(theirs, to_torch=True, device="cpu")
        assert len(got) == (2 if colors == "none" else 3)
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in got)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), verts)
        np.testing.assert_array_equal(got[1].numpy(), faces)


def test_load_off_refuses_other_formats(tmp_path):
    path = tmp_path / "x.off"
    path.write_text("PLY\n0 0 0\n")
    with pytest.raises(ValueError):
        tio.load_off(str(path))


@pytest.mark.parametrize("sigma_shape", [(), (3,), (6,), (3, 3)])
@pytest.mark.parametrize("radians", [False, True])
def test_goff_bytes_equal_and_cross_load(tmp_path, sigma_shape, radians):
    rng = np.random.RandomState(2)
    pts = rng.uniform(-1, 1, size=(20, 3)).astype(np.float32)
    sig = rng.uniform(0.5, 2, size=(20,) + sigma_shape).astype(np.float32)
    rad = rng.uniform(0, 3, size=(20,)).astype(np.float32) if radians else None
    sig_arg = tuple(np.split(sig, [3], axis=1)) if sigma_shape == (6,) else sig
    mine, theirs = str(tmp_path / "t.goff"), str(tmp_path / "j.goff")
    tio.save_goff(mine, torch.as_tensor(pts),
                  sig_arg if isinstance(sig_arg, tuple) else torch.as_tensor(sig_arg), rad)
    jio.save_goff(theirs, pts, sig_arg, rad)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for path in (mine, theirs):
        p, s, r = tio.load_goff(path)
        pj, sj, rj = jio.load_goff(path)
        np.testing.assert_array_equal(p, pts)
        np.testing.assert_array_equal(p, pj)
        if sigma_shape == (6,):
            assert isinstance(s, tuple) and len(s) == 2
            for a, b, c in zip(s, sj, sig_arg):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
        else:
            assert s.shape == sig.shape
            np.testing.assert_array_equal(s, sj)
            np.testing.assert_array_equal(s, sig)
        if radians:
            np.testing.assert_array_equal(r, rad)
            np.testing.assert_array_equal(r, rj)
        else:
            assert r is None and rj is None
    tp, ts, tr = tio.load_goff(mine, to_torch=True, device="cpu")
    assert isinstance(tp, torch.Tensor) and tp.device.type == "cpu"
    assert (tr is None) == (not radians)
    np.testing.assert_array_equal(tp.numpy(), pts)
    if sigma_shape == (6,):
        assert isinstance(ts, tuple) and all(isinstance(t, torch.Tensor) for t in ts)
        np.testing.assert_array_equal(torch.cat(ts, dim=1).numpy(), sig)
    else:
        assert isinstance(ts, torch.Tensor) and ts.device.type == "cpu"
        np.testing.assert_array_equal(ts.numpy(), sig)
    if radians:
        assert isinstance(tr, torch.Tensor) and tr.device.type == "cpu"


def test_loaders_default_device_is_the_card(tmp_path):
    """``to_torch=True`` without a device puts the tensors on the card: on a
    machine without one that is PyTorch's CUDA error, never CPU tensors."""
    verts, faces = _mesh(5)
    off, goff = str(tmp_path / "m.off"), str(tmp_path / "s.goff")
    tio.save_off(off, verts, faces)
    tio.save_goff(goff, verts, np.ones(15, np.float32))
    for load in (lambda: tio.load_off(off, to_torch=True)[0],
                 lambda: tio.load_goff(goff, to_torch=True)[0],
                 lambda: tio.to_torch(verts)[0]):
        try:
            out = load()
        except (AssertionError, RuntimeError) as e:
            assert "CUDA" in str(e) or "cuda" in str(e), e
        else:
            assert out.device.type == "cuda"
    # a tensor among to_torch's arguments keeps its device
    assert tio.to_torch(verts, torch.zeros(2))[0].device.type == "cpu"


def test_to_torch_and_pre_process_pascal():
    rng = np.random.RandomState(3)
    verts = rng.uniform(size=(5, 3))
    a, b, c = tio.to_torch(verts, None, [1, 2], device="cpu")
    assert b is None and a.dtype == torch.float32 == c.dtype and a.device.type == "cpu"
    np.testing.assert_array_equal(a.numpy(), verts.astype(np.float32))
    out, extra = tio.pre_process_pascal(torch.as_tensor(verts), "x")
    want, _ = jio.pre_process_pascal(verts, "x")
    np.testing.assert_array_equal(out, want)
    assert extra == "x"
