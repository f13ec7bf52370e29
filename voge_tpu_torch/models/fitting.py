"""Gradient-based Gaussian-scene fitting (counterpart of
``voge_tpu/models/fitting.py``): the training loop of the reference
ShapeFitting demo as a reusable trainer, on one device or over a mesh of
devices (``parallel.render_pipeline_sharded``)."""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from voge_tpu_torch._device import normalize_device, resolve_device
from voge_tpu_torch.parallel.shard import Mesh, render_pipeline_sharded
from voge_tpu_torch.renderer import get_silhouette, interpolate_attr, render_pipeline


def _default_optimizer(params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """``optax.sgd(0.8, momentum=0.9)``'s updates: no dampening, no Nesterov,
    the momentum trace starting at the first gradient."""
    return torch.optim.SGD(params, lr=0.8, momentum=0.9)


class ShapeFitter:
    """Fit Gaussian centres / inverse covariances / colours to target
    multi-view RGB images and silhouettes.

    :param params: dict with any of "verts" (N, 3), "sigmas", "colors"
        (N, 3), the optimized tensors (copied to ``device`` as float32
        leaves that require grad); the others go in ``fixed``
    :param optimizer: a factory ``f(list of tensors) -> torch.optim.Optimizer``
        (default: ``torch.optim.SGD(lr=0.8, momentum=0.9)``, the updates of
        ``voge_tpu``'s default ``optax.sgd(0.8, momentum=0.9)``)
    :param mesh: optional :class:`~voge_tpu_torch.parallel.Mesh`: renders
        then run through ``parallel.render_pipeline_sharded`` with the
        cameras on ``data_axis`` and the Gaussians on ``model_axis`` (None:
        the scene replicated), and the parameters live on the mesh's first
        device
    :param device: where the parameters and renders live (default: the
        mesh's first device, else the device of the first tensor in
        ``params``, else the card, ``_device.resolve_device``; pass
        ``device="cpu"`` for the CPU)
    """

    def __init__(
        self,
        params: Dict[str, torch.Tensor],
        fixed: Optional[Dict[str, torch.Tensor]] = None,
        *,
        image_size: Tuple[int, int],
        focal, principal,
        max_assign: int = 25,
        thr_activation: float = 0.01,
        max_point_per_bin: Optional[int] = -1,
        w_rgb: float = 1.0,
        w_sil: float = 1.0,
        optimizer: Optional[Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]] = None,
        mesh: Optional[Mesh] = None,
        data_axis: str = "data",
        model_axis: Optional[str] = "model",
        device=None,
    ):
        if mesh is not None:
            first = mesh.devices.flat[0]
            if device is not None and normalize_device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first device {first}")
            device = first
        self.device = resolve_device(device, *params.values())
        self.mesh, self.data_axis, self.model_axis = mesh, data_axis, model_axis
        as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=self.device)
        self.params = {k: as_f32(v).detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.fixed = {k: as_f32(v) for k, v in (fixed or {}).items()}
        self.image_size = tuple(int(x) for x in image_size)
        self.focal = as_f32(focal).reshape(1, -1)[:, :2]
        self.principal = as_f32(principal).reshape(1, -1)[:, :2]
        self.settings = dict(image_size=self.image_size, max_assign=max_assign,
                             thr_activation=thr_activation,
                             max_point_per_bin=max_point_per_bin)
        self.w_rgb, self.w_sil = w_rgb, w_sil
        self.opt = (optimizer or _default_optimizer)(list(self.params.values()))

    def _get(self, name):
        return self.params[name] if name in self.params else self.fixed[name]

    def set_momentum(self, trace: Dict[str, torch.Tensor]) -> None:
        """Set the momentum trace of SGD with momentum, one array per
        parameter: ``optax``'s ``trace``, ``torch.optim.SGD``'s
        ``momentum_buffer``."""
        if not isinstance(self.opt, torch.optim.SGD) or not self.opt.defaults["momentum"]:
            raise ValueError("the momentum trace belongs to SGD with momentum")
        if set(trace) != set(self.params):
            raise ValueError(f"the trace has {sorted(trace)}, the params {sorted(self.params)}")
        for k, p in self.params.items():
            buf = torch.as_tensor(trace[k], dtype=torch.float32, device=p.device)
            self.opt.state[p]["momentum_buffer"] = buf.detach().clone().reshape(p.shape)

    def train_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{"params": ..., "momentum": ...}``: the parameters and the SGD
        momentum trace (zeros before the first step, which starts the trace
        at the first gradient either way), what
        ``checkpoint.save_train_state`` persists of a fit."""
        if not isinstance(self.opt, torch.optim.SGD) or not self.opt.defaults["momentum"]:
            raise ValueError("the train state is that of SGD with momentum")
        momentum = {k: self.opt.state[p].get("momentum_buffer", torch.zeros_like(p)).detach()
                    for k, p in self.params.items()}
        return {"params": {k: p.detach() for k, p in self.params.items()},
                "momentum": momentum}

    def load_train_state(self, state) -> None:
        """Resume from :meth:`train_state`'s structure (as
        ``checkpoint.load_train_state`` returns it)."""
        if set(state["params"]) != set(self.params):
            raise ValueError(f"the state has {sorted(state['params'])}, the params "
                             f"{sorted(self.params)}")
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(torch.as_tensor(state["params"][k], device=p.device))
        self.set_momentum(state["momentum"])

    def render(self, R, T):
        """(rgb (B, H, W, 3), silhouette (B, H, W)) of the current scene."""
        R, T = (torch.as_tensor(x, dtype=torch.float32, device=self.device) for x in (R, T))
        B = R.shape[0]
        scene = (self._get("verts"), self._get("sigmas"), R, T,
                 self.focal.expand(B, 2), self.principal.expand(B, 2))
        if self.mesh is not None:
            frag = render_pipeline_sharded(*scene, mesh=self.mesh, data_axis=self.data_axis,
                                           model_axis=self.model_axis, **self.settings)
        else:
            frag = render_pipeline(*scene, **self.settings)
        return interpolate_attr(frag, self._get("colors")), get_silhouette(frag)

    def loss(self, R, T, target_rgb, target_sil) -> torch.Tensor:
        """``w_sil mean((sil - target_sil)^2) + w_rgb mean((rgb - target_rgb)^2)``."""
        rgb, sil = self.render(R, T)
        t_rgb, t_sil = (torch.as_tensor(x, dtype=torch.float32, device=self.device)
                        for x in (target_rgb, target_sil))
        loss = torch.zeros((), device=self.device)
        if self.w_sil:
            loss = loss + self.w_sil * ((sil - t_sil) ** 2).mean()
        if self.w_rgb:
            loss = loss + self.w_rgb * ((rgb - t_rgb) ** 2).mean()
        return loss

    def step(self, R, T, target_rgb, target_sil) -> float:
        """One optimization step on a batch of views; returns the loss."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(R, T, target_rgb, target_sil)
        loss.backward()
        self.opt.step()
        return loss.item()

    def fit(self, R, T, target_rgb, target_sil, iters: int,
            views_per_iter: Optional[int] = None, seed: int = 0,
            log_every: int = 0) -> float:
        """Run ``iters`` steps, sampling ``views_per_iter`` random views per
        step with ``np.random.RandomState(seed)``, as ``voge_tpu`` does (so
        both pick the same views)."""
        rng = np.random.RandomState(seed)
        n = R.shape[0]
        loss = float("nan")
        for i in range(iters):
            if views_per_iter is not None and views_per_iter < n:
                js = rng.permutation(n)[:views_per_iter]
            else:
                js = np.arange(n)
            pick = lambda x: (x[torch.as_tensor(js, device=x.device)]
                              if isinstance(x, torch.Tensor) else np.asarray(x)[js])
            loss = self.step(pick(R), pick(T), pick(target_rgb), pick(target_sil))
            if log_every and (i + 1) % log_every == 0:
                print(f"iter {i + 1}: loss {loss:.6f}")
        return loss
