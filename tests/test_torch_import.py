"""``import voge_tpu_torch`` (its sharding and its demos too) pulls in
neither JAX, nor ``voge_tpu``, nor ``demo/demo_utils.py``, and builds no
kernel."""
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_and_voge_tpu_out():
    code = (
        "import sys, voge_tpu_torch, voge_tpu_torch.ops.fine\n"
        "import voge_tpu_torch.sampler, voge_tpu_torch.ops.coarse\n"
        "from voge_tpu_torch import sample_features, scatter_max_weight\n"
        "from voge_tpu_torch.ops import rasterize_coarse, ray_tracing_fine\n"
        "from voge_tpu_torch.ops.coarse import overlap_mask, compact_mask, convert_to_box\n"
        "from voge_tpu_torch.ops.cuda_attr import attr_scatter, attr_dw\n"
        "from voge_tpu_torch.ops.cuda_fine import fine_select_bins\n"
        "from voge_tpu_torch.ops.cuda_fine_bwd import fine_bwd_gauss, fine_bwd_rays\n"
        "from voge_tpu_torch.ops.fine import global_backward\n"
        "import voge_tpu_torch.checkpoint, voge_tpu_torch.models.pose\n"
        "import voge_tpu_torch.converter.io, voge_tpu_torch.converter.converters\n"
        "from voge_tpu_torch import PoseHypothesisScorer, refine_pose, scorer_from_numpy\n"
        "from voge_tpu_torch.converter import IO, Converters, naive_point_cloud_converter\n"
        "import voge_tpu_torch.parallel.shard, voge_tpu_torch.demo\n"
        "import voge_tpu_torch.demo.shape_fitting, voge_tpu_torch.demo._utils\n"
        "from voge_tpu_torch.parallel import make_mesh, render_pipeline_sharded\n"
        "from voge_tpu_torch import _build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'voge_tpu' or m.startswith('voge_tpu.')\n"
        "       or m == 'demo_utils' or m.endswith('.demo_utils')]\n"
        "assert not bad, bad\n"
        "assert not _build._libs, _build._libs\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_sources_import_no_jax():
    for path in (ROOT / "voge_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for line in text.splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax", "import voge_tpu ",
                                      "from voge_tpu "))
                        or s.startswith(("import voge_tpu.", "from voge_tpu."))
                        or (s.startswith(("import ", "from ")) and "demo_utils" in s)), (path, s)
