"""The fitting step: ``render_pipeline(attrs=colours, cam_ctx=)`` over the
traffic's cameras -> image and silhouette MSE against a target ->
``backward`` -> ``torch.optim.SGD.step`` on the traffic's leaves.

Set-up builds one fitting object and drives it through its first
``FIRST_STEPS`` steps by the window's own call; their losses, the first
gradient (SGD's momentum buffer after one step) and each leaf's change
after them are what the reference follows.  The colours are seeded and
passed as ``attrs=``; the camera context is made once.  The
targets are the reference's render of the scene with new seeded colours,
plus seeded noise, one target a step in turn: the fit converges towards a
scene next to the start, so the work stays the same over the window.

Traffic keys: ``leaves`` (of verts, sigmas, colors), ``lr`` (by leaf),
``momentum``, ``target_noise``, ``targets`` (noisy copies, cycled),
``views`` (``n`` cameras at ``dist``, elevations and azimuths evenly over
``elev_deg`` / ``azim_deg``, with the configuration's intrinsics).
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from portbench.entries import Spans, reference_phase
from portbench.reference import calls
from portbench.reference.cameras import look_at
from portbench.reference.render import REF
from portbench.scenes import generator, make


# the steps the reference follows (two of the contract's three: the
# reference's render of 8 cameras a step is the check's dearest part)
FIRST_STEPS = 2
LEAVES = ("verts", "sigmas", "colors")


def loss_fn(img, sil, t_img, t_sil):
    """The loss the program's step minimises (the reference's ``fit_loss``)."""
    return ((img - t_img) ** 2).mean() + ((sil - t_sil) ** 2).mean()


class Entry:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, spans: Spans):
        import voge_tpu_torch as vt

        self.vt, self.spans = vt, spans
        tr = self.traffic = wl["traffic"]
        if not set(tr["leaves"]) <= set(LEAVES):
            raise ValueError(f"fit: leaves {tr['leaves']} outside {LEAVES}")
        g = generator(seed + 1, device)
        scene = make(cfg, seed, device)
        scene.update(views(tr["views"], scene, device))
        N = scene["verts"].shape[0]
        H, W = self.hw = tuple(cfg["image_size"])
        self.settings = dict(hw=self.hw, K=cfg["max_assign"], thr=cfg["thr_activation"])
        self.mppb = cfg.get("max_point_per_bin")
        scene["colors"] = torch.rand((N, 3), generator=g, device=device)
        # the targets: the reference's render of the scene with new colours, plus noise
        tgt = dict(scene, colors=torch.rand((N, 3), generator=g, device=device))

        def targets():
            with torch.no_grad():
                img, sil, _ = calls.fit_render({}, tgt, self.settings, REF)
            return [((img + tr["target_noise"] * torch.randn(img.shape, generator=g, device=device)
                      ).float().reshape(-1, H, W, 3),
                     (sil + tr["target_noise"] * torch.randn(sil.shape, generator=g, device=device)
                      ).float().reshape(-1, H, W))
                    for _ in range(tr["targets"])]

        self.targets, self.reference_s = reference_phase(targets, device)
        self.scene = scene
        self.leaves = {k: scene[k].detach().clone().requires_grad_(True) for k in tr["leaves"]}
        self.opt = torch.optim.SGD(
            [{"params": [self.leaves[k]], "lr": tr["lr"][k]} for k in tr["leaves"]],
            momentum=tr["momentum"])
        self.ctx = vt.precompute_camera_ctx(scene["R"], scene["T"], scene["focal"],
                                            scene["principal"], self.hw)
        self.i = 0
        self.valid = None
        # the first steps, by the window's own call
        start = {k: v.detach().clone() for k, v in self.leaves.items()}
        self.first_losses, self.first_step_s = [], []
        for s in range(FIRST_STEPS):
            t0 = time.perf_counter()
            self.first_losses.append(self.step())
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            self.first_step_s.append(time.perf_counter() - t0)
            if s == 0:
                # (a step that kept no state read as a zero gradient)
                self.first_grads = {
                    k: self.opt.state[v].get("momentum_buffer", torch.zeros_like(v)).clone()
                    for k, v in self.leaves.items()}
        self.first_change = {k: v.detach() - start[k] for k, v in self.leaves.items()}
        self.valid_at_start = self.valid

    def step(self):
        vt, s = self.vt, self.scene
        t_img, t_sil = self.targets[self.i % len(self.targets)]
        self.i += 1
        get = lambda k: self.leaves[k] if k in self.leaves else s[k]
        self.opt.zero_grad(set_to_none=True)
        with self.spans("fit.render"):
            frag = vt.render_pipeline(
                get("verts"), get("sigmas"), s["R"], s["T"], s["focal"], s["principal"],
                image_size=self.hw, max_assign=self.settings["K"],
                thr_activation=self.settings["thr"], max_point_per_bin=self.mppb,
                cam_ctx=self.ctx, attrs=get("colors"))
            loss = loss_fn(frag.attr_img, vt.get_silhouette(frag), t_img, t_sil)
        with self.spans("fit.backward"):
            loss.backward()
        with self.spans("fit.sgd"):
            self.opt.step()
        self.valid = frag.valid_num
        return loss.detach()

    def state_line(self) -> str:
        """Valid slots at the window's start and end (the work's size)."""
        return (f"valid slots: after the first steps {int(self.valid_at_start.sum())}, "
                f"at the window's end {int(self.valid.sum())}; the first steps took "
                + ", ".join(f"{t:.3f}" for t in self.first_step_s) + " s")

    def release(self):
        """Drop the program's state but what the check reads."""
        self.ctx = self.valid = self.opt = None
        self.leaves = {k: v.detach() for k, v in self.leaves.items()}

    def follow(self, prec):
        """(losses, first gradients, changes, the first render's counts) of
        the reference at ``prec`` over the same first steps."""
        tr = self.traffic
        targets = [(t[0].reshape(-1, 3), t[1].reshape(-1)) for t in self.targets]
        return calls.fit_follow(self.scene, self.settings, tr["leaves"], tr["lr"], tr["momentum"],
                                targets, FIRST_STEPS, prec)

    def outputs(self):
        """What the program produced in its first steps, as ``follow`` gives it."""
        return ([float(x) for x in self.first_losses], self.first_grads, self.first_change)

    def compare(self, got, want) -> dict:
        """The training numbers: each step's loss; the first gradient's norm
        and, after the first steps, the change's norm, each by the worst
        leaf, as the gap between the program's and the reference's norms
        over the larger of that leaf's and the median leaf's reference norm.
        The change leaves out the leaves whose reference gradient is under a
        thousandth of the median leaf's (they move by round-off alone)."""
        (l_got, g_got, c_got), (l_want, g_want, c_want) = got[:3], want[:3]
        norm = lambda d: {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}

        def worst(n_got, n_want, keys):
            med = statistics.median(n_want[k] for k in keys)
            return max(abs(n_got[k] - n_want[k]) / max(n_want[k], med) for k in keys)

        gw = norm(g_want)
        med_g = statistics.median(gw.values())
        moved = [k for k in gw if gw[k] >= 1e-3 * med_g]
        return dict(loss_gap=max(abs(a - b) / abs(b) for a, b in zip(l_got, l_want)),
                    grad_gap=worst(norm(g_got), gw, list(gw)),
                    change_gap=worst(norm(c_got), norm(c_want), moved))

    def work(self, facts) -> list:
        """The renders of one step (one a camera), with what each layer does
        to them.  On the compacted route the select merges the colours and
        the fine backward takes their gradient; with no coarse stage (the
        configuration's ``max_point_per_bin`` of -1: the global route) the
        attribute merge does both."""
        merge = self.mppb == -1
        return [dict(f, weight=1.0, d_select=0 if merge else 3, bwd="full",
                     d_bwd=0 if merge else 3, rays_grad=False, merge_d=3 if merge else 0,
                     dw=merge, dattr=merge and "colors" in self.traffic["leaves"])
                for f in facts]


def views(v: dict, scene: dict, device) -> dict:
    """``v["n"]`` cameras evenly over the given elevations and azimuths, with
    the configuration's intrinsics: (R, T, focal, principal)."""
    n = v["n"]
    lin = lambda lo_hi: torch.linspace(math.radians(lo_hi[0]), math.radians(lo_hi[1]), n,
                                       dtype=torch.float64, device=device)
    R, T = look_at(torch.full((n,), float(v["dist"]), dtype=torch.float64, device=device),
                   lin(v["elev_deg"]), lin(v["azim_deg"]))
    return dict(R=R.float(), T=T.float(), focal=scene["focal"].expand(n, 2).contiguous(),
                principal=scene["principal"].expand(n, 2).contiguous())
