"""The demo twins (``voge_tpu_torch.demo``) against the JAX scripts of
``demo/`` on the CPU.  The JAX scripts write under ``tmp_path`` (their
``demo_utils.OUT_DIR`` monkeypatched), the twins take ``out_dir=tmp_path``;
no test writes under ``demo/output/``.

- The renders (cuboid, bunny, light diffusion, point cloud) run at their own
  image sizes; their PNGs agree within one 8-bit level on at least 99.9% of
  the pixels.  The point cloud's ~50K points cost the port's dense plain
  select a minute on the CPU, so both scripts draw 5,000 points of the same
  synthesiser there (the synthesiser itself is held equal at 50K).
- The optimization demos run at small sizes: the returned loss or error
  agrees within 1e-4 relative where it is taken before any update, within
  1e-3 after one; the PNGs of their targets, rendered before any update,
  agree as the renders' do.
- Both sides look for upstream data only under this checkout's
  ``reference/demo/data``; ``extract_texture`` skips on both sides when its
  car data is not in the data directory.
"""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
DEMO = ROOT / "demo"

torch.set_num_threads(2)


REF_DATA = ROOT / "reference" / "demo" / "data"


@pytest.fixture
def jax_demo(monkeypatch, tmp_path):
    """``demo/<name>.py`` loaded as a module, writing under tmp_path/jax and
    reading upstream data where the twins read it."""
    monkeypatch.syspath_prepend(str(DEMO))
    import demo_utils

    monkeypatch.setattr(demo_utils, "OUT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(demo_utils, "REF_DATA", str(REF_DATA))

    def load(name):
        spec = importlib.util.spec_from_file_location(f"jax_demo_{name}", DEMO / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    return load


def _twin(name):
    return importlib.import_module(f"voge_tpu_torch.demo.{name}")


def _hold_pngs(tmp_path, stems):
    for stem in stems:
        a = np.asarray(Image.open(tmp_path / "jax" / f"{stem}.png")).astype(np.int16)
        b = np.asarray(Image.open(tmp_path / "torch" / f"{stem}.png")).astype(np.int16)
        assert a.shape == b.shape and a.dtype == b.dtype
        close = (np.abs(a - b) <= 1).all(-1)
        assert close.mean() >= 0.999, (stem, close.mean())
        assert a.std() > 0, stem      # the image shows something


@pytest.mark.parametrize("name,stems", [
    ("render_cuboid", ["cuboid"]),
    ("render_bunny", ["bunny"]),
    ("light_diffusion", [f"light_diffusion_{i}" for i in range(3)]),
])
def test_render_demo_matches_jax_script(name, stems, jax_demo, tmp_path):
    assert jax_demo(name).main() is None
    assert _twin(name).main(device="cpu", out_dir=tmp_path / "torch") is None
    _hold_pngs(tmp_path, stems)
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == sorted(
        f"{s}.png" for s in stems)


def test_point_cloud_demo_matches_jax_script(jax_demo, tmp_path, monkeypatch):
    j, t = jax_demo("render_pointclouds"), _twin("render_pointclouds")
    for a, b in zip(j.synth_pointcloud(), t.synth_pointcloud()):
        np.testing.assert_array_equal(a, b)
    for mod in (j, t):
        monkeypatch.setattr(mod, "synth_pointcloud",
                            lambda real=mod.synth_pointcloud: real(n=5000))
    j.main()
    t.main(device="cpu", out_dir=tmp_path / "torch")
    _hold_pngs(tmp_path, ["pointcloud"])


def test_shape_fitting_demo_matches_jax_script(jax_demo, tmp_path):
    """Two steps (the returned loss is taken after one update) on 4 views
    of 64x64, 2 a step."""
    kw = dict(iters=2, num_views=4, views_per_iter=2, image_size=(64, 64))
    lj = jax_demo("shape_fitting").main(**kw)
    lt = _twin("shape_fitting").main(device="cpu", out_dir=tmp_path / "torch", **kw)
    assert np.isfinite(lt) and abs(lt - lj) <= 1e-3 * abs(lj)
    _hold_pngs(tmp_path, ["shape_fitting_target"])


def test_reason_occlusion_demo_matches_jax_script(jax_demo, tmp_path):
    """One Adam step at 64x64: the translation error after one update."""
    ej = jax_demo("reason_occlusion").main(iters=1, image_size=(64, 64))
    et = _twin("reason_occlusion").main(iters=1, image_size=(64, 64), device="cpu",
                                        out_dir=tmp_path / "torch")
    assert abs(et - ej) <= 1e-3 * abs(ej)
    _hold_pngs(tmp_path, ["reason_occ_target", "reason_occ_before"])


@pytest.mark.parametrize("iters,tol", [(1, 1e-4), (2, 1e-3)])
def test_efficient_cuboid_demo_matches_jax_script(iters, tol, jax_demo, tmp_path):
    """At 48x48: one step returns the loss before any update, two the loss
    after one."""
    lj = jax_demo("efficient_cuboid").main(iters=iters, image_size=(48, 48))
    lt = _twin("efficient_cuboid").main(iters=iters, image_size=(48, 48), device="cpu",
                                        out_dir=tmp_path / "torch")
    assert abs(lt - lj) <= tol * abs(lj)


def test_extract_texture_skips_without_the_car_data(jax_demo, tmp_path, capsys, monkeypatch):
    import demo_utils

    from voge_tpu_torch.demo import _utils

    assert _utils.REF_DATA == REF_DATA      # inside the checkout
    empty = tmp_path / "no_data"
    monkeypatch.setattr(demo_utils, "REF_DATA", str(empty))
    monkeypatch.setattr(_utils, "REF_DATA", empty)
    assert _utils.ref_data("car.off") is None
    assert jax_demo("extract_texture").main() is None
    assert "unavailable; skipping" in capsys.readouterr().out
    assert _twin("extract_texture").main(device="cpu", out_dir=tmp_path / "torch") is None
    assert "skipped: no reference car data" in capsys.readouterr().out
    assert not (tmp_path / "jax").exists() and not (tmp_path / "torch").exists()


def test_save_image_writes_where_asked(tmp_path):
    from voge_tpu_torch.demo import _utils

    assert _utils.OUT_DIR == ROOT / "demo" / "output_torch"
    path = _utils.save_image("x", torch.full((1, 4, 5, 1), 0.5), tmp_path)
    img = np.asarray(Image.open(path))
    assert path == str(tmp_path / "x.png") and img.shape == (4, 5, 3) and (img == 127).all()
