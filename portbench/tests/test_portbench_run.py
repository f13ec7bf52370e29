"""The run's last line, the command's refusals, and what the benchmark
imports."""
import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.tests.conftest import CELLS, ROOT, small

HERE = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "voge_tpu"}


def test_result_keys_in_order():
    res = harness.run(CELLS[0], 5, 2, False, time.time(), device="cpu", log=lambda s: None,
                      files=small(CELLS[0]))
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["failed"] == 0 and isinstance(res["correct"], bool)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def run_cmd(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                           str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def test_no_card_no_result():
    out = run_cmd(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip()


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cmd(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def sources():
    return [p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts]


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, n)
            if "reference" in path.parts:
                assert n.split(".")[0] != "voge_tpu_torch", (path, n)
    text = path.read_text()
    # nothing reads the JAX package's benchmark or its results
    assert "bench" + ".py" not in text and "BENCH" + "_" not in text


def test_what_the_harness_imports():
    """Every module of the benchmark imported (the program with it), then
    the process's modules compared by whole top-level names; the reference
    alone loads nothing of the program."""
    code = ("import sys, importlib; sys.path.insert(0, {root!r});"
            "from portbench import harness, control, faults, roofline, tracing, layers;"
            "[importlib.import_module('portbench.entries.' + e) for e in ('fit', 'score')];"
            "[harness.metric_module(m) for m in harness.metric_names()];"
            "import voge_tpu_torch;"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True,
                         text=True, timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not tops & FORBIDDEN and "voge_tpu_torch" in tops
    ref = subprocess.run([sys.executable, "-c",
                          f"import sys; sys.path.insert(0, {str(ROOT)!r});"
                          "import portbench.reference.calls, portbench.reference.render;"
                          "print('voge_tpu_torch' in sys.modules)"],
                         capture_output=True, text=True, timeout=300, check=True)
    assert ref.stdout.strip() == "False"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(name, card):
    """The control on the card at a small size: TF32 in the program's place
    fails a limit on three seeds, the program passes them."""
    from portbench import control

    _, wl, _ = files = small(name)
    for row in control.readings(name, [21, 22, 23], 3, True, card, files):
        assert all(row["program"][k] <= lim for k, lim in wl["limits"].items()), row
        assert any(row["control"][k] > lim for k, lim in wl["limits"].items()), row
