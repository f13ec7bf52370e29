"""``import voge_tpu_torch`` pulls in neither JAX nor ``voge_tpu`` and builds
no kernel."""
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_and_voge_tpu_out():
    code = (
        "import sys, voge_tpu_torch, voge_tpu_torch.ops.fine\n"
        "from voge_tpu_torch import _build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'voge_tpu' or m.startswith('voge_tpu.')]\n"
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
                        or s.startswith(("import voge_tpu.", "from voge_tpu."))), (path, s)
