"""Pose refinement: ``refine_pose`` of a batch of images, each pose against
its own image's target feature map, ``steps`` Adam steps a call (NeMo's
render-and-compare after the hypothesis search).  No camera context: each
step builds the rays from the poses and differentiates through them; the
scene is frozen, so the backward takes K3's per-ray half and the merge's
weight gradient.

The scene carries seeded unit feature rows, as the scoring cell's.  Set-up
draws ``target_sets`` sets of ``batch`` true poses from the seed (distance
fixed; elevation, azimuth and in-plane angle uniform in the traffic's
ranges, in degrees) and renders the reference's feature map at each, plus
noise: one target map an image, held on the card.  It draws ``pose_sets``
sets of initial poses, set i offset from the true poses of target set i mod
``target_sets`` by uniform draws within +-``init_offset`` (distance; the
angles in degrees); each call refines the next set against its targets,
cycled.  The check draws ``check_calls`` of the window's calls and
``check_images`` of each call's images from the seed, and follows each of
those images through the call's steps in the reference: the medians of
their gaps, and the count of images off by more than a flip explains.

Traffic keys: ``batch``, ``pose_sets``, ``dist``, ``elev_deg``,
``azim_deg``, ``theta_deg`` (ranges), ``target_noise``, ``check_calls``,
``steps``, ``lr``, ``target_sets``, ``init_offset`` (half-widths by
``dist``, ``elev_deg``, ``azim_deg``, ``theta_deg``), ``check_images``.
"""
from __future__ import annotations

import math

import torch

from portbench.entries import Spans, reference_phase
from portbench.entries.score import cameras, draw_poses
from portbench.reference import calls, pose
from portbench.reference.render import REF
from portbench.scenes import generator, make

NAMES = ("dist", "elev", "azim", "theta")
# an image's gaps (pose, similarity) that no flip at the threshold explains:
# ~10x the widest single image the program reads, ~10x below an image left
# out of the loss or refined against another's target (a quarter of one
# Adam step of lr 0.02)
POSE_STRAY, SIM_STRAY = 5e-3, 5e-4


def offsets(g, n, half, device):
    """(n, 4) float64 uniform draws within +-``half`` (distance; angles in
    degrees, returned in radians)."""
    scale = torch.tensor([half["dist"]] + [math.radians(half[k])
                                           for k in ("elev_deg", "azim_deg", "theta_deg")],
                         dtype=torch.float64, device=device)
    return (2 * torch.rand((n, 4), generator=g, device=device, dtype=torch.float64) - 1) * scale


class Entry:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, spans: Spans):
        import voge_tpu_torch as vt

        tr = self.traffic = wl["traffic"]
        self.vt, self.seed, self.spans = vt, seed, spans
        g = generator(seed + 1, device)
        self.scene = s = make(cfg, seed, device)
        self.hw = tuple(cfg["image_size"])
        self.settings = dict(hw=self.hw, K=cfg["max_assign"], thr=cfg["thr_activation"])
        N, C = s["verts"].shape[0], cfg["feature_dim"]
        f = torch.randn((N, C), generator=g, device=device)
        self.features = f / torch.linalg.norm(f, dim=-1, keepdim=True)
        B = tr["batch"]
        true = [draw_poses(g, B, tr, device) for _ in range(tr["target_sets"])]

        @torch.no_grad()
        def targets():
            out = []
            for poses in true:
                R, T = cameras(poses)
                maps = torch.empty((B,) + self.hw + (C,), device=device)
                for b in range(B):
                    im = calls.feature_render(s, self.features, R[b], T[b], self.settings, REF)
                    noise = tr["target_noise"] * torch.randn(
                        im.img.shape, generator=g, device=device, dtype=im.img.dtype)
                    maps[b] = (im.img + noise).float().reshape(self.hw + (C,))
                out.append(maps)
            return out

        self.targets, self.reference_s = reference_phase(targets, device)
        self.inits = [(true[i % len(true)] + offsets(g, B, tr["init_offset"], device)).float()
                      for i in range(tr["pose_sets"])]
        self.scorer = vt.PoseHypothesisScorer(
            s["verts"], s["sigmas"], self.features, s["focal"][0], s["principal"][0],
            image_size=self.hw, max_assign=cfg["max_assign"],
            thr_activation=cfg["thr_activation"], max_point_per_bin=cfg.get("max_point_per_bin"),
            chunk=B)
        self.i = 0
        self.calls = []
        self.step()           # the warm-up: every shape of the window
        self.calls.clear()

    def _set(self, i):
        """(initial poses (B, 4), target maps (B, H, W, C)) of call ``i``."""
        k = i % len(self.inits)
        return self.inits[k], self.targets[k % len(self.targets)]

    def step(self):
        init, target = self._set(self.i)
        tr = self.traffic
        with self.spans("refine.call"):
            poses, sims = self.vt.refine_pose(self.scorer, target, init, steps=tr["steps"],
                                              lr=tr["lr"])
        self.calls.append((self.i, poses, sims))
        self.i += 1

    def state_line(self) -> str:
        return (f"calls in the window {len(self.calls)}, pose sets {len(self.inits)}, "
                f"target sets {len(self.targets)}")

    def release(self):
        self.scorer = None

    def _checked(self):
        """(``check_calls`` of the window's calls, ``check_images`` of a
        call's images), drawn from the seed."""
        tr = self.traffic
        order = torch.randperm(len(self.calls), generator=generator(self.seed + 2, "cpu"))
        images = torch.randperm(tr["batch"], generator=generator(self.seed + 3, "cpu"))
        return ([self.calls[j] for j in order[:tr["check_calls"]].tolist()],
                sorted(images[:tr["check_images"]].tolist()))

    def outputs(self):
        """[similarities (n,), poses (n, 4)] of each checked call's checked
        images, as ``follow`` gives them."""
        checked, images = self._checked()
        out = []
        for _, poses, sims in checked:
            out += [sims[images].double(),
                    torch.stack([poses[k] for k in NAMES], -1)[images].double()]
        return out

    def follow(self, prec):
        tr = self.traffic
        checked, images = self._checked()
        out, facts = [], []
        for i, _, _ in checked:
            init, target = self._set(i)
            got = [pose.refine(self.scene, self.features, init[b],
                               target[b].reshape(-1, target.shape[-1]), self.settings,
                               tr["steps"], tr["lr"], prec) for b in images]
            out += [torch.stack([s for _, s, _ in got]), torch.stack([p for p, _, _ in got])]
            facts += [f for _, _, fs in got for f in fs]
        return out, facts

    def compare(self, got, want) -> dict:
        """Each checked image's gaps: of the similarity the call returned,
        and of the refined pose, its widest coordinate.  ``sim_gap`` and
        ``pose_gap`` are their medians over the checked images: a pixel
        whose Gaussian sits at the activation threshold or at the K-th slot
        flips between float32 and float64, which moves that image's gradient
        a little, and Adam's normalised steps carry it into the pose; a few
        images in a hundred read gaps 10-100x the others', above the TF32
        control's narrowest widest gap.  A median passes while up to half
        the checked images are wrong, so ``stray_images`` counts the images
        that no such flip explains: a pose off by more than
        ``POSE_STRAY`` or a similarity by more than ``SIM_STRAY``.  An
        answer altered after the similarity (its gradient unchanged) moves
        the similarity alone."""
        sim = torch.cat([(a - b.double()).abs() for a, b in zip(got[0::2], want[0][0::2])])
        pose = torch.cat([(a - b.double()).abs().amax(-1)
                          for a, b in zip(got[1::2], want[0][1::2])])
        stray = ~(pose <= POSE_STRAY) | ~(sim <= SIM_STRAY)     # NaN is stray
        return dict(sim_gap=float(sim.median()), pose_gap=float(pose.median()),
                    stray_images=float(stray.sum()))

    def work(self, facts) -> list:
        """The renders of one call: each followed render stands for
        ``steps x batch`` over the renders followed.  No camera context and
        a frozen scene: the backward takes the rays' gradient alone; the
        features are merged by the attribute merge, whose backward takes the
        weights' gradient alone."""
        weight = self.traffic["steps"] * self.traffic["batch"] / max(1, len(facts))
        return [dict(f, weight=weight, d_select=0, bwd="rays", d_bwd=0, rays_grad=True,
                     merge_d=self.features.shape[1], dw=True, dattr=False) for f in facts]
