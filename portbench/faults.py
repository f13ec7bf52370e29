"""The faults the check must catch, planted in the program underneath a
run: its state left unchanged, half its batch left out with the mean taken
over the rest, an answer altered where it is produced.  (Every cell runs on
one card, so no exchange between cards can be left out.)  Each fault is a
function that patches with ``setattr(obj, name, value)`` of a
``pytest.MonkeyPatch``-like object; ``portbench/control.py --fault`` reads
them at a cell's own size, the CPU tests at a small one."""
from __future__ import annotations

import contextlib

import torch


def _fit_faults():
    from portbench.entries import fit

    loss = fit.loss_fn

    def half(img, sil, t_img, t_sil):
        """Half the cameras."""
        h = img.shape[0] // 2
        return loss(img[:h], sil[:h], t_img[:h], t_sil[:h])

    return {"state_unchanged": lambda mp: mp.setattr(torch.optim.SGD, "step",
                                                     lambda self, closure=None: None),
            "half_batch": lambda mp: mp.setattr(fit, "loss_fn", half),
            "answer_altered": lambda mp: mp.setattr(
                fit, "loss_fn", lambda img, sil, t_img, t_sil: loss(img + 0.01, sil, t_img, t_sil))}


def _score_faults():
    from voge_tpu_torch.models import pose

    sim = pose.feature_similarity

    def half(pred, target, mask=None):
        h = pred.shape[1] // 2
        return sim(pred[:, :h], target[:, :h])

    return {"half_batch": lambda mp: mp.setattr(pose, "feature_similarity", half),
            "answer_altered": lambda mp: mp.setattr(
                pose, "feature_similarity", lambda p, t, mask=None: sim(p, t) + 1e-3)}


def faults(entry: str) -> dict:
    """name -> patch of the faults a cell of kind ``entry`` can have."""
    return _fit_faults() if entry == "fit" else _score_faults()


class Patcher:
    """``setattr`` that ``undo`` reverses (the CLI's stand-in for pytest's
    monkeypatch)."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()


@contextlib.contextmanager
def planted(entry: str, name: str | None):
    """The fault ``name`` of a cell of kind ``entry`` planted (None: none)."""
    p = Patcher()
    if name:
        faults(entry)[name](p)
    try:
        yield
    finally:
        p.undo()
