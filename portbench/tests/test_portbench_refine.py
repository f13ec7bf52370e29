"""The refinement cell's check against faults that leave some images out
while the others stay right: the medians of the checked images' gaps pass
while half of them are wrong, so ``stray_images`` has to catch these.  At
the small size a call's 4 images are all checked, 2 of them wrong."""
import time

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import small

NAME = "cuboid10k.refine_b32"


def _half_left_out(sim):
    """The loss over the first half of the images: the rest get no
    gradient and stay where they started."""
    def patched(pred, target, mask=None):
        s = sim(pred, target)
        h = s.shape[0] // 2
        return torch.cat([s[:h], s[h:].detach()])
    return patched


def _half_wrong_target(sim):
    """The second half of the images refined against one another's
    targets."""
    def patched(pred, target, mask=None):
        h = target.shape[0] // 2
        return sim(pred, torch.cat([target[:h], target[h:].roll(1, 0)]))
    return patched


@pytest.mark.parametrize("seed", [2 ** 31 + 977, 3 * 2 ** 30 + 5, 4 * 10 ** 9 + 7])
@pytest.mark.parametrize("fault", [_half_left_out, _half_wrong_target])
def test_half_the_images_wrong_is_not_correct(fault, seed, monkeypatch):
    from voge_tpu_torch.models import pose

    monkeypatch.setattr(pose, "feature_similarity", fault(pose.feature_similarity))
    res = harness.run(NAME, seed, 3, False, time.time(), device="cpu", log=lambda s: None,
                      files=small(NAME))
    checks = res["checks"]
    assert not res["correct"], checks
    assert checks["stray_images"]["value"] == 2, checks
