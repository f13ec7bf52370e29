"""Batched pose refinement (``models.pose.refine_pose`` over B poses, one
target map each; the benchmark's cell ``cuboid10k.refine_b32``) on the CPU,
where the port's kernels run their plain versions.

The scene is the benchmark's cuboid cut to the CPU tests' size (300
Gaussians requested, 32 x 32, focal 37.5, K = 20, 8 seeded unit feature
channels); B = 4 poses drawn as the cell draws them (distance 6, elevation
5-25, azimuth 0-360, theta +-10 degrees), targets the float64 reference's
maps plus noise, and initial poses offset from the true ones; 3 Adam steps
of lr 0.02.

- B poses refined together equal B scalar calls to the bit: every image is
  rendered, compared and differentiated on its own, and Adam is
  elementwise;
- a (1, 4) batch equals the scalar form to the bit, and four (B,) tensors
  the (B, 4) tensor;
- the batch against ``portbench/reference/pose.py`` in float64: the
  similarities within 3e-6 and the poses within 1e-5 (radians and scene
  units), ~10x the widest gaps over eight seeds (2.9e-7 and 8.5e-7): the
  similarity is a mean over 1,024 pixels of cosines of float32 renders, and
  a pixel whose Gaussian sits at the activation threshold may flip between
  float32 and float64;
- tracing on: the three spans and the two counters; off: nothing counted.
"""
import math
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import voge_tpu_torch as vt
from voge_tpu_torch import trace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.reference import calls as ref_calls  # noqa: E402
from portbench.reference import pose as ref_pose  # noqa: E402
from portbench.reference.cameras import look_at  # noqa: E402
from portbench.scenes.cuboid import cuboid  # noqa: E402

torch.set_num_threads(2)
B, HW, K, C, STEPS, LR = 4, (32, 32), 20, 8, 3, 0.02
FOCAL = 37.5
SIM_TOL, POSE_TOL = 3e-6, 1e-5
NAMES = ("dist", "elev", "azim", "theta")


def problem(seed):
    """(scorer, initial poses (B, 4) float32, targets (B, H, W, C), scene
    and settings for the reference)."""
    g = torch.Generator().manual_seed(seed)
    v, s = cuboid([[-1, 1]] * 3, 300, 0.6)
    verts = torch.tensor(v, dtype=torch.float32)
    sigmas = torch.tensor(s, dtype=torch.float32)
    f = torch.randn((verts.shape[0], C), generator=g)
    features = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, generator=g, dtype=torch.float64)
    true = torch.stack([torch.full((B,), 6.0, dtype=torch.float64), u(5, 25) * math.pi / 180,
                        u(0, 360) * math.pi / 180, u(-10, 10) * math.pi / 180], -1)
    half = torch.tensor([0.3] + [math.radians(d) for d in (5, 10, 5)], dtype=torch.float64)
    init = (true + (2 * torch.rand((B, 4), generator=g, dtype=torch.float64) - 1) * half).float()
    scene = dict(verts=verts, sigmas=sigmas, focal=torch.tensor([[FOCAL, FOCAL]]),
                 principal=torch.tensor([[16.0, 16.0]]))
    settings = dict(hw=HW, K=K, thr=0.01)
    R, T = look_at(*true.T)
    with torch.no_grad():
        maps = [ref_calls.feature_render(scene, features, R[b], T[b], settings).img
                for b in range(B)]
    targets = torch.stack([(m + 0.05 * torch.randn(m.shape, generator=g, dtype=m.dtype)).float()
                           .reshape(HW + (C,)) for m in maps])
    scorer = vt.PoseHypothesisScorer(verts, sigmas, features, FOCAL, 16.0, image_size=HW,
                                     max_assign=K, chunk=B, device="cpu")
    return scorer, init, targets, scene, features, settings


@pytest.fixture(scope="module")
def prob():
    return problem(2 ** 31 + 31)


@pytest.fixture(scope="module")
def batched(prob):
    scorer, init, targets = prob[:3]
    return vt.refine_pose(scorer, targets, init, steps=STEPS, lr=LR)


def stacked(poses):
    return torch.stack([poses[k] for k in NAMES], -1)


def test_batch_shapes_and_no_host_value(batched):
    poses, sims = batched
    assert set(poses) == set(NAMES)
    assert all(p.shape == (B,) and not p.requires_grad for p in poses.values())
    assert torch.is_tensor(sims) and sims.shape == (B,) and not sims.requires_grad


def test_batch_equals_b_scalar_calls(prob, batched):
    scorer, init, targets = prob[:3]
    poses, sims = batched
    for b in range(B):
        p, s = vt.refine_pose(scorer, targets[b], tuple(init[b].tolist()), steps=STEPS, lr=LR)
        assert torch.equal(stacked(poses)[b], stacked(p)), b
        assert sims[b].item() == s, b


@pytest.mark.parametrize("form", ["columns", "float64"])
def test_other_batch_forms_equal_the_tensor(prob, batched, form):
    """Four (B,) tensors, or a (B, 4) float64 tensor of the same values,
    refine as the (B, 4) float32 tensor."""
    scorer, init, targets = prob[:3]
    arg = tuple(init.unbind(-1)) if form == "columns" else init.double()
    poses, sims = vt.refine_pose(scorer, targets, arg, steps=STEPS, lr=LR)
    assert torch.equal(stacked(poses), stacked(batched[0])) and torch.equal(sims, batched[1])


def test_a_batch_of_one_is_the_scalar_form(prob):
    scorer, init, targets = prob[:3]
    p1, s1 = vt.refine_pose(scorer, targets[:1], init[:1], steps=STEPS, lr=LR)
    p0, s0 = vt.refine_pose(scorer, targets[0], tuple(init[0].tolist()), steps=STEPS, lr=LR)
    assert isinstance(s0, float) and s1.shape == (1,) and s1[0].item() == s0
    for k in NAMES:
        assert p0[k].shape == () and p1[k].shape == (1,)
        assert torch.equal(p1[k][0], p0[k]), k


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 31])
def test_batch_against_the_float64_reference(seed, prob, batched):
    scorer, init, targets, scene, features, settings = (
        prob if seed == 2 ** 31 + 31 else problem(seed))
    poses, sims = batched if seed == 2 ** 31 + 31 else vt.refine_pose(
        scorer, targets, init, steps=STEPS, lr=LR)
    for b in range(B):
        p, s, facts = ref_pose.refine(scene, features, init[b], targets[b].reshape(-1, C),
                                      settings, STEPS, LR)
        assert p.dtype == torch.float64 and len(facts) == STEPS
        assert abs(sims[b].item() - s.item()) <= SIM_TOL, (b, sims[b].item(), s.item())
        gap = (stacked(poses)[b].double() - p).abs().max().item()
        assert gap <= POSE_TOL, (b, gap)
        # the refinement moved every pose by more than its tolerance
        assert (p - init[b].double()).abs().max().item() > 100 * POSE_TOL


def _refine_events(prof):
    return [e.name for e in prof.events() if e.name.startswith("voge.refine")]


def test_spans_and_counters_with_tracing_on(prob):
    scorer, init, targets = prob[:3]
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.tracing():
        vt.refine_pose(scorer, targets, init, steps=STEPS, lr=LR)
        counts = trace.counts()
    names = _refine_events(prof)
    assert names.count("voge.refine") == 1
    assert names.count("voge.refine.pose") == STEPS and names.count("voge.refine.adam") == STEPS
    assert counts["refine.steps"] == STEPS and counts["refine.poses"] == B


def test_nothing_recorded_with_tracing_off(prob):
    scorer, init, targets = prob[:3]
    assert not trace.enabled()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vt.refine_pose(scorer, targets, init, steps=1, lr=LR)
    assert _refine_events(prof) == [] and trace.counts() == {}
