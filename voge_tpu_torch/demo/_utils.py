"""What the demos share (counterpart of ``demo/demo_utils.py``): where PNGs
go, where the upstream demo data is looked for, and the command line."""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "demo" / "output_torch"
# upstream VoGE's demo data (``bunny.off``, ``cow.obj``, the car files), looked
# for only inside this checkout, under ``reference/demo/data`` (gitignored);
# nothing is downloaded, and a demo without its file falls back or skips
REF_DATA = ROOT / "reference" / "demo" / "data"


def save_image(path_stem: str, img, out_dir=None) -> str:
    """Save a (H, W, 3) or (1, H, W, 3) float image in [0, 1] as
    ``<out_dir>/<path_stem>.png`` (default ``out_dir``: :data:`OUT_DIR`),
    encoded as ``demo_utils.save_image`` encodes it."""
    from PIL import Image

    out = Path(out_dir) if out_dir is not None else OUT_DIR
    out.mkdir(parents=True, exist_ok=True)
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    path = out / f"{path_stem}.png"
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
    print("saved", path)
    return str(path)


def ref_data(name: str) -> Optional[str]:
    """Path to an upstream demo data file, or None if it is absent."""
    p = REF_DATA / name
    return str(p) if p.exists() else None


def run(main, iters: Optional[int] = None) -> None:
    """The demos' command line: ``--iters`` where the demo optimizes (default
    ``iters``), ``--device`` (default the card) and ``--out-dir``."""
    ap = argparse.ArgumentParser()
    if iters is not None:
        ap.add_argument("--iters", type=int, default=iters)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out-dir", default=None)
    a = ap.parse_args()
    kw = dict(device=a.device, out_dir=a.out_dir)
    if iters is not None:
        kw["iters"] = a.iters
    main(**kw)
