"""Gaussian-ellipsoid scenes as ``nn.Module``s (counterpart of
``voge_tpu/meshes.py`` and the reference ``VoGE/Meshes.py``).

A scene is N kernels with centres ``verts`` (N, 3), inverse covariances
``sigmas`` of shape (N,), (N, 3) or (N, 3, 3), and an optional ``radians``
field that the renderer carries but ignores.  Calling a scene returns
``(verts, sigmas, radians)``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

_FIELDS = ("verts", "sigmas", "radians")


def _tensor(x, device):
    if x is None:
        return None
    return torch.as_tensor(x, device=device)


class GaussianMeshesNaive(nn.Module):
    """Plain container: the fields are buffers (not trained)."""

    def __init__(self, verts, sigmas, radians=None, device=None):
        super().__init__()
        for name, val in zip(_FIELDS, (verts, sigmas, radians)):
            self.register_buffer(name, _tensor(val, device))

    def forward(self):
        return self.verts, self.sigmas, self.radians

    def __getitem__(self, item):
        return type(self)(
            self.verts[item], self.sigmas[item],
            None if self.radians is None else self.radians[item],
        )


class GaussianMeshes(GaussianMeshesNaive):
    """Trainable variant (reference ``Meshes.py:30``): ``gradianted_args``
    marks (verts, sigmas, radians) trainable, by default all that exist.
    Trainable fields are ``nn.Parameter``s, the others buffers."""

    def __init__(self, verts, sigmas, radians=None,
                 gradianted_args: Optional[Sequence[bool]] = None,
                 device=None):
        nn.Module.__init__(self)
        flags = list(gradianted_args) if gradianted_args is not None else [True] * 3
        if radians is None:
            flags[2] = False
        self.gradianted_args = flags
        for name, val, train in zip(_FIELDS, (verts, sigmas, radians), flags):
            t = _tensor(val, device)
            if train:
                self.register_parameter(name, nn.Parameter(t))
            else:
                self.register_buffer(name, t)

    def __getitem__(self, item):
        return type(self)(
            self.verts[item].detach(), self.sigmas[item].detach(),
            None if self.radians is None else self.radians[item].detach(),
            gradianted_args=self.gradianted_args,
        )

    def grad_parameters(self):
        return tuple(getattr(self, n) for n, f in zip(_FIELDS, self.gradianted_args)
                     if f)
