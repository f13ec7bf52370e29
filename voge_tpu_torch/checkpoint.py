"""Scene and training-state persistence (counterpart of
``voge_tpu/checkpoint.py``).

- GOFF stays the interchange text format (``converter.io``);
- :func:`save_scene` / :func:`load_scene` persist a Gaussian scene (plus
  extra arrays, e.g. colours or features) as a compressed ``.npz`` with
  ``voge_tpu``'s keys (``verts``, ``sigmas``, ``radians``,
  ``gradianted_args``, ``extra_<name>``), so a scene saved by either package
  loads in the other, exact in float32;
- :func:`save_train_state` / :func:`load_train_state` persist a nested
  structure of dicts, lists and tuples whose leaves are tensors, arrays or
  numbers, e.g. ``ShapeFitter.train_state()`` (the parameters and the SGD
  momentum), for checkpoint / resume of a fitting loop.  The structure is
  stored with the leaves and checked on load.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from voge_tpu_torch.meshes import GaussianMeshes, GaussianMeshesNaive


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_scene(path: str, gmesh, **extra_arrays) -> None:
    """Save a Gaussian scene (and optional per-kernel arrays) to ``.npz``."""
    verts, sigmas, radians = gmesh()
    data = {"verts": _np(verts), "sigmas": _np(sigmas)}
    if radians is not None:
        data["radians"] = _np(radians)
    if isinstance(gmesh, GaussianMeshes):
        data["gradianted_args"] = np.asarray(gmesh.gradianted_args)
    for k, v in extra_arrays.items():
        data[f"extra_{k}"] = _np(v)
    np.savez_compressed(path, **data)


def load_scene(path: str, naive: bool = False, device=None):
    """Load a scene saved by :func:`save_scene` (of either package).

    :param device: where the scene's tensors go (None: the card,
        ``_device.resolve_device``; pass ``device="cpu"`` for the CPU)
    :return: (GaussianMeshes or GaussianMeshesNaive, dict of extra numpy arrays)
    """
    with np.load(path) as z:
        verts, sigmas = z["verts"], z["sigmas"]
        radians = z["radians"] if "radians" in z else None
        extras = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
        if naive or "gradianted_args" not in z:
            mesh = GaussianMeshesNaive(verts, sigmas, radians, device=device)
        else:
            mesh = GaussianMeshes(verts, sigmas, radians,
                                  gradianted_args=[bool(b) for b in z["gradianted_args"]],
                                  device=device)
    return mesh, extras


def _flatten(state: Any, leaves: List[Any]) -> str:
    """Append ``state``'s leaves to ``leaves`` in a fixed order (dict keys
    sorted) and return a description of its structure."""
    if isinstance(state, dict):
        keys = sorted(state)
        return "{" + ", ".join(f"{k!r}: {_flatten(state[k], leaves)}" for k in keys) + "}"
    if isinstance(state, (list, tuple)):
        inner = ", ".join(_flatten(v, leaves) for v in state)
        return f"[{inner}]" if isinstance(state, list) else f"({inner})"
    leaves.append(state)
    return "*"


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    leaf = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(leaf, device=like.device)
    if isinstance(like, (bool, int, float)):
        return type(like)(leaf.item())
    return leaf


def save_train_state(path: str, state: Any) -> None:
    """Persist a nested structure (parameters, optimizer state, step
    counters) with tensor, array or number leaves."""
    leaves: List[Any] = []
    treedef = _flatten(state, leaves)
    np.savez_compressed(
        path, __treedef__=np.frombuffer(treedef.encode(), dtype=np.uint8),
        **{f"leaf_{i}": _np(leaf) for i, leaf in enumerate(leaves)})


def load_train_state(path: str, like: Any) -> Any:
    """Restore what :func:`save_train_state` saved into the structure of
    ``like``: a tensor leaf comes back as a tensor on that leaf's device, a
    Python number as a number, anything else as a numpy array.  Raises
    ``ValueError`` when the stored structure is not ``like``'s."""
    leaves_like: List[Any] = []
    treedef = _flatten(like, leaves_like)
    with np.load(path) as z:
        stored = z["__treedef__"].tobytes().decode()
        if stored != treedef:
            raise ValueError("checkpoint structure mismatch:\n saved: %s\n want:  %s"
                             % (stored, treedef))
        leaves = [z[f"leaf_{i}"] for i in range(len(leaves_like))]
    return _unflatten(like, iter(leaves))
