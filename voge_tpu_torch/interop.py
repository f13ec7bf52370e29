"""Carry scenes, cameras and fitting state over from numpy arrays: the
arrays a ``voge_tpu`` object exposes (``np.asarray(g.verts)``) or a saved
scene (``voge_tpu.checkpoint.save_scene``'s ``.npz``), without importing
JAX."""
from __future__ import annotations

import numpy as np
import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import PerspectiveCameras
from voge_tpu_torch.meshes import GaussianMeshes
from voge_tpu_torch.models.fitting import ShapeFitter
from voge_tpu_torch.models.pose import PoseHypothesisScorer


def scene_from_numpy(verts, sigmas, colors=None, device=None):
    """(GaussianMeshes with float32 verts / sigmas on ``device``, colours as a
    float32 tensor or None).  ``device=None`` is the card
    (``_device.resolve_device``); pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    g = GaussianMeshes(np.array(verts, np.float32),
                       np.array(sigmas, np.float32), device=device)
    if colors is not None:
        colors = torch.as_tensor(np.array(colors, np.float32), device=device)
    return g, colors


def cameras_from_numpy(R, T, focal, principal, image_size, device=None):
    """Screen-space ``PerspectiveCameras`` on ``device`` (None: the card)."""
    return PerspectiveCameras(
        focal_length=np.asarray(focal, np.float32),
        principal_point=np.asarray(principal, np.float32),
        R=np.asarray(R, np.float32), T=np.asarray(T, np.float32),
        image_size=image_size, device=device,
    )


def fitter_from_numpy(params, fixed=None, opt_trace=None, **kwargs) -> ShapeFitter:
    """A ``ShapeFitter`` from a ``voge_tpu.models.ShapeFitter``'s state as
    numpy arrays (``{k: np.asarray(v) for k, v in fitter.params.items()}``,
    likewise ``fixed``), so that a fit can resume in the port.

    :param opt_trace: optional ``{name: array}`` momentum trace of
        ``voge_tpu``'s default ``optax.sgd(0.8, momentum=0.9)``
        (``fitter.opt_state[0].trace``); it becomes the ``momentum_buffer``
        of each parameter in ``torch.optim.SGD``'s state, whose next update
        is then ``optax``'s
    :param kwargs: ``ShapeFitter``'s keyword arguments (``image_size``,
        ``focal``, ``principal``, ``device``, ...); ``device=None`` is the
        card, as for ``ShapeFitter``
    """
    f = ShapeFitter({k: np.array(v, np.float32) for k, v in params.items()},
                    {k: np.array(v, np.float32) for k, v in (fixed or {}).items()},
                    **kwargs)
    if opt_trace is not None:
        f.set_momentum({k: np.array(v, np.float32) for k, v in opt_trace.items()})
    return f


def scorer_from_numpy(verts, sigmas, features, focal, principal, **kwargs) -> PoseHypothesisScorer:
    """A ``PoseHypothesisScorer`` from a ``voge_tpu.models.PoseHypothesisScorer``'s
    arrays (``np.asarray(scorer.verts)``, ...).

    :param kwargs: the scorer's keyword arguments (``image_size``,
        ``max_assign``, ``chunk``, ``device``, ...); ``device=None`` is the card
    """
    f32 = lambda x: np.array(x, np.float32)
    return PoseHypothesisScorer(f32(verts), f32(sigmas), f32(features), f32(focal),
                                f32(principal), **kwargs)
