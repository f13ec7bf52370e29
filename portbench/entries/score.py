"""Pose scoring: ``PoseHypothesisScorer.score`` of a batch of pose
hypotheses against a target feature map, forward only (NeMo's initial pose
search).  The scene carries seeded unit feature rows; the target is the
reference's feature map of a seeded pose plus noise.  Each call scores the
next of ``pose_sets`` batches drawn from the seed (distance fixed;
elevation, azimuth and in-plane angle uniform in the traffic's ranges, in
degrees), cycled.  The check draws ``check_calls`` of the window's calls
from the seed and compares every score of them, by their mean gap.

Traffic keys: ``batch``, ``pose_sets``, ``dist``, ``elev_deg``,
``azim_deg``, ``theta_deg`` (ranges), ``target_noise``, ``check_calls``.
"""
from __future__ import annotations

import math

import torch

from portbench.entries import Spans, reference_phase
from portbench.reference import calls
from portbench.reference.cameras import look_at
from portbench.reference.render import REF
from portbench.scenes import generator, make


def draw_poses(g, n, tr, device):
    """(n, 4) float64 poses (distance, elevation, azimuth, theta; radians)
    from the traffic's ranges."""
    def uniform(lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)

    dist = torch.full((n,), float(tr["dist"]), dtype=torch.float64, device=device)
    angles = [uniform(tr[k]) * (math.pi / 180) for k in ("elev_deg", "azim_deg", "theta_deg")]
    return torch.stack([dist] + angles, -1)


def cameras(poses):
    """(R (n, 3, 3), T (n, 3)) float32 of (n, 4) poses."""
    R, T = look_at(*poses.T)
    return R.float(), T.float()


class Entry:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, spans: Spans):
        import voge_tpu_torch as vt

        tr = self.traffic = wl["traffic"]
        self.seed, self.spans = seed, spans
        g = generator(seed + 1, device)
        self.scene = s = make(cfg, seed, device)
        self.hw = tuple(cfg["image_size"])
        self.settings = dict(hw=self.hw, K=cfg["max_assign"], thr=cfg["thr_activation"])
        N, C = s["verts"].shape[0], cfg["feature_dim"]
        f = torch.randn((N, C), generator=g, device=device)
        self.features = f / torch.linalg.norm(f, dim=-1, keepdim=True)
        R, T = look_at(*draw_poses(g, 1, tr, device)[0, :, None])

        def target():
            im = calls.feature_render(s, self.features, R[0], T[0], self.settings, REF)
            noise = tr["target_noise"] * torch.randn(im.img.shape, generator=g, device=device,
                                                     dtype=im.img.dtype)
            return (im.img + noise).float().reshape(self.hw + (C,))

        self.target, self.reference_s = reference_phase(target, device)
        B = tr["batch"]
        self.cams = [cameras(draw_poses(g, B, tr, device)) for _ in range(tr["pose_sets"])]
        self.scorer = vt.PoseHypothesisScorer(
            s["verts"], s["sigmas"], self.features, s["focal"][0], s["principal"][0],
            image_size=self.hw, max_assign=cfg["max_assign"],
            thr_activation=cfg["thr_activation"], max_point_per_bin=cfg.get("max_point_per_bin"),
            chunk=B)
        self.i = 0
        self.calls = []
        self.step()           # the warm-up: every shape of the window
        self.calls.clear()

    def step(self):
        R, T = self.cams[self.i % len(self.cams)]
        with self.spans("score.score"):
            self.calls.append((self.i, self.scorer.score(R, T, self.target)))
        self.i += 1

    def state_line(self) -> str:
        return f"calls in the window {len(self.calls)}, pose sets {len(self.cams)}"

    def release(self):
        self.scorer = None

    def _checked(self):
        """``check_calls`` of the window's calls drawn from the seed."""
        order = torch.randperm(len(self.calls), generator=generator(self.seed + 2, "cpu"))
        return [self.calls[j] for j in order[:self.traffic["check_calls"]].tolist()]

    def outputs(self):
        return [s.double() for _, s in self._checked()]

    def follow(self, prec):
        out, facts = [], []
        for i, _ in self._checked():
            R, T = self.cams[i % len(self.cams)]
            s, f = calls.scores(self.scene, self.features, R, T,
                                self.target.reshape(-1, self.target.shape[-1]), self.settings, prec)
            out.append(s)
            facts += f
        return out, facts

    def compare(self, got, want) -> dict:
        """The mean over the checked scores of each one's gap to the
        reference's.  (The widest gap is set by a few pixels whose Gaussian
        sits at the activation threshold and flips between float32 and
        float64, and does not separate the program from TF32.)"""
        gaps = torch.cat([(a - b.double()).abs() for a, b in zip(got, want[0])])
        return dict(score_gap_mean=float(gaps.mean()))

    def work(self, facts) -> list:
        n_calls = max(1, len(facts) // self.traffic["batch"])
        return [dict(f, weight=1 / n_calls, d_select=0, bwd=None,
                     merge_d=self.features.shape[1], dw=False, dattr=False) for f in facts]
