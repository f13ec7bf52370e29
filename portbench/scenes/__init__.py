"""Seeded scene generators, one module a scene kind.  A configuration file
names its kind (``"scene": "cuboid"``); :func:`make` imports
``portbench.scenes.<kind>`` and builds the scene on the device from the
seed, without the program."""
from __future__ import annotations

import importlib
import math

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by any whole number (folded into 63
    bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def make(cfg: dict, seed: int, device) -> dict:
    """The scene of ``cfg`` as float32 tensors on ``device``: ``verts`` (N,
    3), ``sigmas`` (N,) inverse sigmas, and the configuration's camera:
    ``R`` (1, 3, 3), ``T`` (1, 3), ``focal`` (1, 2), ``principal`` (1, 2)."""
    from portbench.reference.cameras import look_at

    kind = importlib.import_module(f"portbench.scenes.{cfg['scene']}")
    verts, sigmas = kind.make(cfg, seed, device)
    cam = cfg["camera"]
    f64 = lambda x: torch.tensor([float(x)], dtype=torch.float64, device=device)
    R, T = look_at(f64(cam["dist"]), f64(math.radians(cam["elev_deg"])),
                   f64(math.radians(cam["azim_deg"])))
    pair = lambda x: torch.tensor([list(map(float, x))], dtype=torch.float32, device=device)
    return dict(verts=verts, sigmas=sigmas, R=R.float(), T=T.float(),
                focal=pair([cfg["focal"]] * 2), principal=pair(cfg["principal"]))
