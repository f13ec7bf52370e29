"""Small cells for the CPU: the benchmark's own cells cut to a 32 x 32
image and a few hundred Gaussians, run on the program's plain versions."""
import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

# the cells BENCHMARK.json lists, and every workload file (those it does
# not list run here all the same)
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
WORKLOADS = sorted(p.stem for p in (ROOT / "portbench" / "workloads").glob("*.json"))


def small(name: str):
    """(BENCHMARK.json, the workload file, the configuration file) of cell
    ``name`` at a size the CPU runs in a second: 32 x 32 pixels, 300
    Gaussians requested of a cuboid or 3,000 points of a cloud, 8 feature
    channels, batches of 4."""
    bench = harness.benchmark()
    _, wl, cfg = harness.cell(name, bench)
    wl, cfg = copy.deepcopy(wl), copy.deepcopy(cfg)
    cfg.update(image_size=[32, 32], focal=cfg["focal"] / 8, principal=[16, 16])
    if cfg["scene"] == "cuboid":
        cfg.update(number_vertices=300, feature_dim=8)
    else:
        cfg["n_points"] = 3000
    tr = wl["traffic"]
    if "batch" in tr:
        tr.update(batch=4, pose_sets=3)
    return bench, wl, cfg


@pytest.fixture
def card():
    """Skips where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
