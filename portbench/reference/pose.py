"""NeMo's pose refinement of one image, in plain PyTorch over
:mod:`portbench.reference.render`: the pose (distance, elevation, azimuth,
in-plane theta; radians) through :func:`cameras.look_at`, the image's
feature render, the cosine similarity to its target
(:func:`calls.similarity`), the pose's gradient by autograd, and Adam
written out with ``torch.optim.Adam``'s arithmetic: betas (0.9, 0.999), eps
1e-8 outside the square root, both moments bias-corrected.  A batch's images
are independent refinements, so each is followed alone.  Computed at a
:class:`Precision` (float64 for the reference), with TF32 off for every
matrix product; it imports nothing of the program."""
from __future__ import annotations

import math

import torch

from portbench.reference.calls import feature_render, similarity
from portbench.reference.cameras import look_at
from portbench.reference.render import REF, Precision, _no_tf32

BETAS, EPS = (0.9, 0.999), 1e-8


def refine(scene: dict, features, pose, target, settings: dict, steps: int, lr: float,
           prec: Precision = REF):
    """``steps`` Adam steps from ``pose`` (4,) against ``target`` (n_pix, C):
    (the refined pose (4,), the similarity at the last step's start, each
    step's render counts)."""
    b1, b2 = BETAS
    p = pose.detach().to(prec.dtype).clone()
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    feats, tgt = features.to(prec.dtype), target.to(prec.dtype)
    sim, facts = None, []
    with _no_tf32():
        for t in range(1, steps + 1):
            leaf = p.clone().requires_grad_(True)
            R, T = look_at(*leaf[:, None])
            im = feature_render(scene, feats, R[0], T[0], settings, prec)
            s = similarity(im.img, tgt, prec)
            (g,) = torch.autograd.grad(-s, leaf)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            denom = v.sqrt() / math.sqrt(1 - b2 ** t) + EPS
            p = p - lr / (1 - b1 ** t) * m / denom
            sim = s.detach()
            facts.append(im.facts)
    return p, sim, facts
