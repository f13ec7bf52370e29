"""The two kinds of call the cells time, in plain PyTorch over
:mod:`portbench.reference.render`: a fitting step (render, image and
silhouette MSE, backward, SGD with momentum) and the cosine feature
similarity of a pose hypothesis.  The optimizer is written out here with
``torch.optim.SGD``'s arithmetic (``buf = g`` then ``buf = mu buf + g``,
``p -= lr buf``), so nothing of the program's path is shared.  Inputs are the benchmark's own
tensors; every leaf is copied into the reference's dtype."""
from __future__ import annotations

import torch

from portbench.reference.render import REF, Precision, dot, render_image


def similarity(pred: torch.Tensor, target: torch.Tensor, prec: Precision = REF) -> torch.Tensor:
    """Mean over pixels of the cosine between predicted and target feature
    rows (n_pix, C), each normalised by its norm + 1e-8."""
    pn = pred / (torch.linalg.norm(pred, dim=-1, keepdim=True) + 1e-8)
    tn = target / (torch.linalg.norm(target, dim=-1, keepdim=True) + 1e-8)
    return dot(pn, tn, prec).mean()


def fit_loss(img, sil, t_img, t_sil):
    """mean((image - target)^2) + mean((silhouette - target silhouette)^2)."""
    return ((img - t_img) ** 2).mean() + ((sil - t_sil) ** 2).mean()


def fit_render(leaves: dict, scene: dict, settings: dict, prec):
    """The fitting scene seen by each of its cameras, one image after
    another: (images (B * n_pix, d), silhouettes (B * n_pix,), each image's
    counts); ``leaves`` override the scene's tensors by name (verts, sigmas,
    colors, R, T)."""
    get = lambda k: leaves[k] if k in leaves else scene[k].to(prec.dtype)
    R, T = get("R"), get("T")
    ims = [render_image(get("verts"), get("sigmas"), R[b], T[b], scene["focal"][b],
                        scene["principal"][b], settings["hw"], settings["K"], settings["thr"],
                        attrs=get("colors"), prec=prec) for b in range(R.shape[0])]
    return (torch.cat([im.img for im in ims]), torch.cat([im.sil for im in ims]),
            [im.facts for im in ims])


def fit_follow(scene: dict, settings: dict, leaf_names, lrs: dict, momentum: float, targets,
               steps: int, prec: Precision = REF):
    """The first ``steps`` fitting steps from the scene's leaves: (losses,
    first gradients by leaf, each leaf's change after ``steps``, the first
    step's counts, an image each)."""
    leaves = {k: scene[k].detach().to(prec.dtype).clone().requires_grad_(True)
              for k in leaf_names}
    start = {k: v.detach().clone() for k, v in leaves.items()}
    bufs = {}
    losses, first, facts = [], None, None
    for s in range(steps):
        t_img, t_sil = targets[s]
        img, sil, counts = fit_render(leaves, scene, settings, prec)
        loss = fit_loss(img, sil, t_img.to(prec.dtype), t_sil.to(prec.dtype))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        if s == 0:
            first = {k: g.detach().clone() for k, g in zip(leaves, grads)}
            facts = counts
        with torch.no_grad():
            for (k, p), g in zip(leaves.items(), grads):
                bufs[k] = g.clone() if k not in bufs else bufs[k] * momentum + g
                p -= lrs[k] * bufs[k]
        losses.append(loss.detach().item())
    change = {k: leaves[k].detach() - start[k] for k in leaf_names}
    return losses, first, change, facts


def feature_render(scene: dict, features, R, T, settings: dict, prec: Precision = REF):
    """One camera's feature image (n_pix, C) of the scene."""
    return render_image(scene["verts"], scene["sigmas"], R, T, scene["focal"][0],
                        scene["principal"][0], settings["hw"], settings["K"], settings["thr"],
                        attrs=features, prec=prec)


@torch.no_grad()
def scores(scene: dict, features, Rs, Ts, target, settings: dict, prec: Precision = REF):
    """(similarity of each of the cameras (B,) to the target (n_pix, C),
    the renders' counts)."""
    out, facts = [], []
    for R, T in zip(Rs, Ts):
        im = feature_render(scene, features, R, T, settings, prec)
        out.append(similarity(im.img, target.to(prec.dtype), prec))
        facts.append(im.facts)
    return torch.stack(out), facts

