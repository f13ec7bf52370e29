"""The plain reference against the program's plain CPU path at a tiny scene,
each cell's whole run at a small size, its control, and the faults the
check must catch."""
import math
import time

import pytest
import torch

from portbench import control, faults, harness
from portbench.reference import render as ref
from portbench.reference.cameras import look_at
from portbench.tests.conftest import WORKLOADS as CELLS, small

SEED = 2 ** 31 + 977


def run_small(name, seed=SEED):
    return harness.run(name, seed, 3, False, time.time(), device="cpu", log=lambda s: None,
                       files=small(name))


def test_render_equals_the_programs_plain_path():
    import voge_tpu_torch as vt

    from portbench.scenes.cuboid import cuboid

    v, s = cuboid([[-1, 1]] * 3, 300, 0.6)
    verts = torch.tensor(v, dtype=torch.float32)
    sig = torch.tensor(s, dtype=torch.float32)
    R, T = look_at(*torch.tensor([[6.0], [math.radians(10)], [math.radians(70)]],
                                 dtype=torch.float64))
    R, T = R.float(), T.float()
    focal, principal = torch.tensor([[40.0, 40.0]]), torch.tensor([[16.0, 16.0]])
    colors = (verts + 1) / 3
    v_p = verts.clone().requires_grad_(True)
    frag = vt.render_pipeline(v_p, sig, R, T, focal, principal, image_size=(32, 32),
                              max_assign=20, attrs=colors)
    frag.attr_img.sum().backward()
    v_r = verts.double().requires_grad_(True)
    im = ref.render_image(v_r, sig, R[0], T[0], focal[0], principal[0], (32, 32), 20,
                          attrs=colors)
    im.img.sum().backward()
    assert torch.equal(frag.vert_index.reshape(-1, 20).long(), im.ids)
    assert (frag.vert_weight.reshape(-1, 20).double() - im.w).abs().max() < 1e-5
    assert (frag.attr_img.reshape(-1, 3).double() - im.img).abs().max() < 1e-5
    g, gr = v_p.grad.double(), v_r.grad
    assert (g - gr).norm() / gr.norm() < 1e-4


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10, -3.0001])
    assert ref.tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -3.0]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_at_a_small_size(name):
    res = run_small(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] == 3


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in TF32 in the program's place fails a limit, on three
    seeds (here at a small size; on the card at the cell's own size by
    ``portbench/control.py``)."""
    _, wl, _ = files = small(name)
    for row in control.readings(name, [11, 12, 13], 3, True, "cpu", files):
        assert any(row["control"][k] > lim for k, lim in wl["limits"].items()), row


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                         for f in sorted(faults.faults(small(c)[1]["entry"]))])
def test_faults_make_correct_false(name, fault, monkeypatch):
    faults.faults(small(name)[1]["entry"])[fault](monkeypatch)
    assert not run_small(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_setup_times_the_reference_apart(name):
    """The targets the reference makes in set-up are timed apart, for
    ``setup_s`` to leave out."""
    from portbench.entries import Spans

    _, wl, cfg = small(name)
    obj = harness.entry_class(wl["entry"])(cfg, wl, SEED, "cpu", Spans(False))
    assert obj.reference_s > 0
