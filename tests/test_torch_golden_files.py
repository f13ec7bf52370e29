"""Every golden file of ``voge_tpu`` under ``tests/data`` has its check on
the card: ``tests/test_torch_cuda_paths.py`` (run there with ``-m cuda``)
names it, so that no file can lose its check unseen.  Runs on the CPU."""
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"
ON_THE_CARD = Path(__file__).resolve().parent / "test_torch_cuda_paths.py"


@pytest.mark.parametrize("name", sorted(p.name for p in DATA.glob("voge_tpu_golden_*.npz")))
def test_each_golden_file_is_held_on_the_card(name):
    assert name in ON_THE_CARD.read_text(), f"no test on the card reads {name}"


def test_the_golden_files_are_found():
    """The parametrisation above is not silently empty."""
    assert len(list(DATA.glob("voge_tpu_golden_*.npz"))) >= 8
