"""Drive the voge_tpu_torch render, its fitting step and the no-coarse
ShapeFitting trainer on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases:
  1. the card (nvidia-smi name and power limit) and the kernel build from
     ``voge_tpu_torch/csrc``, one ``nvcc`` per source, all at once (build
     seconds, ptxas register / spill report);
  2. each kernel against its plain PyTorch version on the card, on a 1K
     scene at 128x128 and on the 10K-Gaussian headline at 256x256: K1
     exact; K2 at K = 5 and 20, with and without attributes; K3f; the fold,
     K3 (with and without attributes, with and without ray gradients) and
     K4b with cotangents from a seeded ``torch.Generator``; then, at the
     ShapeFitting shapes (5 views, 2,562 Gaussians, 128x128, K = 25), K2's
     global entry (with and without a random sub-bin bits plane, selections
     exact) and K3's global entry (with and without ray gradients, with the
     weight cotangent set and zero);
  3. the main paths, each with every launch counter set to 0 just before it
     and read just after:
     - the forward at the headline, through ``render_pipeline(attrs=)`` and
       ``GaussianRenderer`` + ``to_white_background`` (K1, K2, K3f);
     - the headline fitting step, ``render_pipeline(attrs=, cam_ctx=
       precompute_camera_ctx(...))`` -> ``bench.py``'s loss -> backward
       (K1, K2, K3): overflow 0, finite gradients, two backward runs equal
       to the bit, the loss and the gradients of verts, sigmas and colours
       against ``voge_tpu``'s golden files (tests/data) at the headline and
       at 1K 128x128;
     - the 1K quickstart through ``GaussianRenderer`` ->
       ``to_white_background`` -> mean-squared loss -> backward (K1, K2,
       K3, K3f, K4b), gradients against the plain path on the card;
     - the ShapeFitting step at full width (``bench.py:234-290``'s scene,
       views and targets, ``max_point_per_bin=-1``, silhouette + RGB loss
       through ``interpolate_attr``; K2 global, K3 global, K3f, K4b, and no
       K1): overflow 0, two backward runs equal to the bit, the loss and the
       gradients against ``voge_tpu``'s golden file; then three
       ``models.ShapeFitter`` steps (default optimizer), losses and
       parameters against the same file;
     then the 1K forward against its golden file and the quickstart bounds;
  4. CUDA-event timings of the headline forward and fitting step and of the
     ShapeFitting step on the kernel path and on the plain path, in turns,
     and of each kernel against its plain version; torch.profiler traces of
     five kernel-path steps of each give the device's busy share and the
     time by kernel.

Any failed check raises, so the exit code is nonzero.  The last line is
``{"ok": true, "device": {...}}``; the line before it a JSON line of the
kernels.  Without a CUDA device the script exits nonzero at once.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
GOLDEN = DATA / "voge_tpu_golden_1k_128.npz"
GOLDEN_GRAD = {"1k": DATA / "voge_tpu_golden_grad_1k_128.npz",
               "headline": DATA / "voge_tpu_golden_grad_10k_256.npz"}
GOLDEN_SF = DATA / "voge_tpu_golden_shapefit_128.npz"
SF_B, SF_HW, SF_K = 5, (128, 128), 25   # the ShapeFitting step (bench.py:234-290)
OUT_DIR = ROOT / "chiprun_out"
KERNELS = {  # name -> (library, source, replaced TPU kernel)
    "emit_keys": ("emit", "voge_tpu_torch/csrc/emit.cu",
                  "voge_tpu/ops/pallas_coarse.py:38"),
    "fine_select": ("fine_select", "voge_tpu_torch/csrc/fine_select.cu",
                    "voge_tpu/ops/pallas_fine2.py:89"),
    "attr_merge": ("attr_merge", "voge_tpu_torch/csrc/attr_merge.cu",
                   "voge_tpu/ops/pallas_attr.py:64"),
    "fold_weights": ("fold_weights", "voge_tpu_torch/csrc/fold_weights.cu",
                     "voge_tpu/ops/pallas_fine2.py:627"),
    "fine_bwd": ("fine_bwd", "voge_tpu_torch/csrc/fine_bwd.cu",
                 "voge_tpu/ops/pallas_bwd.py:573"),
    "attr_merge_bwd": ("attr_merge_bwd", "voge_tpu_torch/csrc/attr_merge_bwd.cu",
                       "voge_tpu/ops/pallas_attr.py:90"),
    "fine_select_global": ("fine_select", "voge_tpu_torch/csrc/fine_select.cu",
                           "voge_tpu/ops/pallas_fine2.py:803"),
    "fine_bwd_global": ("fine_bwd", "voge_tpu_torch/csrc/fine_bwd.cu",
                        "voge_tpu/ops/pallas_bwd.py:255"),
}
# tolerances (tests/test_parity_full.py:22-49): selections equal but for
# knife-edge pixels (< 0.1% flipped); len/act/dsd rtol 1e-5 atol 1e-5;
# weights and images atol 1e-4 on agreeing pixels (kernel vs plain, and the
# small-frame golden); 1.5e-3 is the f32 ceiling at the headline.
FLIP_MAX, LAD_TOL, W_TOL = 1e-3, 1e-5, 1e-4
# backward kernels against their plain versions: max |kernel - plain| <=
# 1e-4 max |plain| per tensor (f32 sums in another order).  Gradients
# against voge_tpu's golden files: normwise relative error <= 1e-3 per
# gradient and the loss to a relative 1e-5 (XLA's sum order, its erf
# against erff, knife-edge pixels).
GRAD_TOL, GOLD_GRAD_TOL, GOLD_LOSS_TOL = 1e-4, 1e-3, 1e-5
# ShapeFitter steps against the golden file: each loss to a relative 1e-5,
# and the parameters' displacement from the start to a normwise relative
# 1e-3 (each update is lr x the momentum trace of gradients held to 1e-3).


def need(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def scene(n, hw, focal, dev):
    """Cuboid scene of ``n`` requested Gaussians, camera (6, 10, 70)."""
    import voge_tpu_torch as vt

    g = vt.converter.Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), n,
                                         percentage=0.6, as_obj=True, device=dev)
    R, T = vt.look_at_view_transform(dist=6, elev=10, azim=70, device=dev)
    cams = (R, T, torch.tensor([[focal, focal]], device=dev),
            torch.tensor([[hw[1] / 2, hw[0] / 2]], device=dev))
    colors = ((g.verts.detach() + 1) / 3).contiguous()
    return g, cams, colors


def stage_inputs(g, cams, hw):
    """Rays and camera-centred (points, isigmas) as render_pipeline makes
    them."""
    from voge_tpu_torch.aggregation import expend_sigma
    from voge_tpu_torch.rays import camera_rays

    rays, origins = camera_rays(*cams, hw)
    verts = g.verts.detach()
    points = verts[None] - origins[:, None, :]
    isig = 2.0 * expend_sigma(g.sigmas.detach())[None].expand(1, -1, 3, 3)
    return rays, points, isig


def cuda_ms(fn, n):
    """Mean milliseconds of ``fn()`` over ``n`` back-to-back runs."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


@contextmanager
def plain_path():
    """Route a render and its backward through the plain versions on CUDA
    tensors."""
    from voge_tpu_torch.ops import coarse, cuda_attr, cuda_coarse, cuda_fine, cuda_fine_bwd, fine

    swaps = [(coarse, "emit_keys", cuda_coarse.emit_keys_plain),
             (fine, "fine_select", cuda_fine.fine_select_plain),
             (fine, "fine_bwd", cuda_fine_bwd.fine_bwd_plain),
             (fine, "fine_select_global", cuda_fine.fine_select_global_plain),
             (fine, "fine_bwd_global", cuda_fine_bwd.fine_bwd_global_plain),
             (cuda_attr, "attr_merge", cuda_attr.attr_merge_plain),
             (cuda_attr, "attr_merge_bwd", cuda_attr.attr_merge_bwd_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, fn in swaps:
            setattr(m, n, fn)
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def compare_select(got, want):
    """(flip fraction, max |w| / |img| error on agreeing pixels)."""
    agree = (got[0] == want[0]).all(-1)
    flips = 1.0 - agree.float().mean().item()
    need(flips < FLIP_MAX, f"select flips {flips}")
    for g, w in zip(got[1:4], want[1:4]):
        torch.testing.assert_close(g[agree], w[agree], rtol=LAD_TOL, atol=LAD_TOL)
    err = 0.0
    for g, w in zip(got[4:], want[4:]):
        if g is None:
            continue
        e = (g[agree] - w[agree]).abs().max().item()
        need(e <= W_TOL, f"select weights/image error {e}")
        err = max(err, e)
    return flips, err


def grad_err(got, want, what):
    """max |kernel - plain| / max |plain|, checked against GRAD_TOL."""
    scale = want.abs().max().item()
    need(scale > 0, f"{what}: plain result is all zero")
    e = (got - want).abs().max().item() / scale
    need(e <= GRAD_TOL, f"{what}: kernel vs plain {e:.3e}")
    return e


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def seeded(shape, dev, seed):
    return torch.randn(shape, device=dev, generator=torch.Generator(dev).manual_seed(seed))


def bench_loss(frag):
    """bench.py's loss: mean((attr_img - 0.5)^2) + mean(silhouette^2)."""
    import voge_tpu_torch as vt

    return ((frag.attr_img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()


def fitting_step(g, cams, colors, hw, ctx=None):
    """Loss and (verts, sigmas, colours) gradients of one fitting step."""
    import voge_tpu_torch as vt

    verts = g.verts.detach().requires_grad_(True)
    sigmas = g.sigmas.detach().requires_grad_(True)
    cols = colors.detach().requires_grad_(True)
    if ctx is None:
        ctx = vt.precompute_camera_ctx(*cams, hw, verts.shape[0], max_assign=20)
    frag = vt.render_pipeline(verts, sigmas, *cams, image_size=hw, max_assign=20,
                              cam_ctx=ctx, attrs=cols)
    loss = bench_loss(frag)
    return frag, loss, (verts, sigmas, cols)


def shapefit_scene(dev):
    """``bench.py:234-290``'s ShapeFitting scene through the port's own
    converters: ``ico_sphere(4)`` (2,562 Gaussians) through
    ``naive_vertices_converter(percentage=0.5)``, colours 0.5, five views at
    dist 2.7, elevations ``linspace(-10, 30, 5)``, azimuths ``linspace(-60,
    60, 5)``, focal 126 at 128x128; targets RGB 0.3 and silhouette 0.
    :return: (verts (N, 3), inverse sigmas (N,), colours (N, 3), (R, T,
        focal, principal), (target_rgb, target_sil))"""
    import voge_tpu_torch as vt

    v, f = vt.ico_sphere(4)
    verts, isig, _ = vt.naive_vertices_converter(v, f, percentage=0.5)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    R, T = vt.look_at_view_transform(dist=[2.7] * SF_B, elev=list(np.linspace(-10, 30, SF_B)),
                                     azim=list(np.linspace(-60, 60, SF_B)), device=dev)
    cams = (R, T, t(np.full((SF_B, 2), 126.0)), t(np.full((SF_B, 2), 64.0)))
    targets = (t(np.full((SF_B,) + SF_HW + (3,), 0.3)), t(np.zeros((SF_B,) + SF_HW)))
    return t(verts), t(isig), t(np.full((len(verts), 3), 0.5)), cams, targets


def shapefit_loss(verts, isig, colors, cams, targets):
    """The ShapeFitting loss ``mean((sil - t_sil)^2) + mean((rgb -
    t_rgb)^2)`` through ``render_pipeline(max_point_per_bin=-1)``,
    ``interpolate_attr`` and ``get_silhouette``; (fragments, loss)."""
    import voge_tpu_torch as vt

    frag = vt.render_pipeline(verts, isig, *cams, image_size=SF_HW, max_assign=SF_K,
                              max_point_per_bin=-1)
    rgb = vt.interpolate_attr(frag, colors)
    loss = ((vt.get_silhouette(frag) - targets[1]) ** 2).mean() + ((rgb - targets[0]) ** 2).mean()
    return frag, loss


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible; the port's checks run only on a GPU")
    sys.path.insert(0, str(ROOT))
    import voge_tpu_torch as vt
    from voge_tpu_torch import _build
    from voge_tpu_torch.ops import coarse, fine
    from voge_tpu_torch.ops.cuda_attr import (
        attr_merge, attr_merge_bwd, attr_merge_bwd_plain, attr_merge_plain,
    )
    from voge_tpu_torch.ops.cuda_coarse import emit_keys, emit_keys_plain
    from voge_tpu_torch.aggregation import expend_sigma
    from voge_tpu_torch.ops.cuda_fine import (
        fine_select, fine_select_global, fine_select_global_plain, fine_select_plain,
    )
    from voge_tpu_torch.ops.cuda_fine_bwd import (
        fine_bwd, fine_bwd_global, fine_bwd_global_plain, fine_bwd_plain, fold_weights,
        fold_weights_plain,
    )
    from voge_tpu_torch.rays import camera_rays

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    OUT_DIR.mkdir(exist_ok=True)
    details = {}
    launchers = {"emit_keys": emit_keys, "fine_select": fine_select,
                 "attr_merge": attr_merge, "fold_weights": fold_weights,
                 "fine_bwd": fine_bwd, "attr_merge_bwd": attr_merge_bwd,
                 "fine_select_global": fine_select_global,
                 "fine_bwd_global": fine_bwd_global}

    def zero_counts():
        for fn in launchers.values():
            fn.launches = 0

    def read_counts(path, required):
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in launchers.items()}
        print(f"main path {path}: launches {counts}")
        for k in required:
            need(counts[k] > 0, f"{k} was not launched on the main path {path}")
        return counts

    # ---- 1. card and build --------------------------------------------
    smi = smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    details["card"] = smi
    t0 = time.perf_counter()
    _build.load_all(dict.fromkeys(lib for lib, _, _ in KERNELS.values()))
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s wall, in parallel: " + ", ".join(
        f"{k} {v[0]:.1f} s" for k, v in _build.build_info.items()))
    ptxas = "\n".join(f"== {k}\n{v[1]}" for k, v in _build.build_info.items())
    (OUT_DIR / "ptxas.txt").write_text(ptxas)
    for line in ptxas.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    details["build_s"] = build_s

    # ---- 2. kernels against their plain versions ----------------------
    err = {k: 0.0 for k in KERNELS}
    shapes = {"small": (1000, (128, 128), 150.0), "headline": (10000, (256, 256), 300.0)}
    head = {}
    for tag, (n, hw, focal) in shapes.items():
        g, cams, colors = scene(n, hw, focal, dev)
        rays, points, isig = stage_inputs(g, cams, hw)
        P = points.shape[1]
        bs, _ = fine.production_bin_geometry(hw, 20, P, None, None)
        k1_args = (*cams, points, isig, 0.01, bs, hw,
                   *coarse.emission_geometry(P, hw, bs))
        got, want = emit_keys(*k1_args), emit_keys_plain(*k1_args)
        for a, b in zip(got, want):
            need(torch.equal(a, b), f"K1 {tag}: kernel and plain differ")
        print(f"K1 {tag}: P={P} keys and aux planes equal bit for bit")
        for K in (5, 20):
            c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
            need(int(c.overflow_c.sum()) == 0, f"{tag} overflow")
            table = fine.candidate_table(points, isig, c.pos_c)
            for attrs in (None, colors):
                args = (rays, table, c.bits_c, c.ids_c, c.counts_c,
                        c.thr_act, K, c.bin_size, 1.0, attrs)
                got, want = fine_select(*args), fine_select_plain(*args)
                flips, e = compare_select(got, want)
                err["fine_select"] = max(err["fine_select"], e)
                print(f"K2 {tag}: K={K} attrs={attrs is not None} M={table.shape[1]} "
                      f"flips={flips:.2e} max_err(w,img)={e:.3e}")
                if tag == "headline" and K == 20 and attrs is not None:
                    head["k2"] = args
                    head["k3"] = (got[0], got[4], colors)
            sel = got  # K, attrs = this K, colours
            g_cot = [seeded(sel[1].shape, dev, 10 + q) for q in range(4)]
            g_img = seeded(rays.shape, dev, 20)
            # the fold on its own
            f_args = (*sel[1:5], g_cot[3], 1.0)
            e = max(grad_err(a, b, f"fold {tag} K={K}")
                    for a, b in zip(fold_weights(*f_args), fold_weights_plain(*f_args)))
            err["fold_weights"] = max(err["fold_weights"], e)
            # K3 with / without attributes and ray gradients
            for with_attrs in (False, True):
                for want_rays in (False, True):
                    b_args = (rays, table, c.ids_c, c.counts_c, *sel[:5], *g_cot,
                              c.bin_size, 1.0, colors if with_attrs else None,
                              g_img if with_attrs else None, want_rays)
                    kb, pb = fine_bwd(*b_args), fine_bwd_plain(*b_args)
                    e = grad_err(kb[0], pb[0], f"K3 rows {tag} K={K}")
                    if want_rays:
                        e = max(e, grad_err(kb[1], pb[1], f"K3 rays {tag} K={K}"))
                    err["fine_bwd"] = max(err["fine_bwd"], e)
                    if tag == "headline" and K == 20 and with_attrs and not want_rays:
                        head["k3b"] = b_args
            print(f"fold/K3 {tag}: K={K} max_err/max|plain| fold {err['fold_weights']:.3e} "
                  f"K3 {err['fine_bwd']:.3e}")
            if tag == "headline" and K == 20:
                head["fold"] = f_args
        idx, w, attrs = head["k3"] if tag == "headline" else (got[0], got[4], colors)
        e = (attr_merge(idx, w, attrs) - attr_merge_plain(idx, w, attrs)).abs().max().item()
        need(e <= 1e-5, f"K3f {tag} error {e}")
        err["attr_merge"] = max(err["attr_merge"], e)
        g_att = seeded(idx.shape[:-1] + (3,), dev, 30)
        e = max(grad_err(a, b, f"K4b {tag}") for a, b in zip(
            attr_merge_bwd(idx, w, attrs, g_att), attr_merge_bwd_plain(idx, w, attrs, g_att)))
        err["attr_merge_bwd"] = max(err["attr_merge_bwd"], e)
        print(f"K3f {tag}: max_err={err['attr_merge']:.3e}; K4b max_err/max|plain|={e:.3e}")
        if tag == "headline":
            head.update(k1=k1_args, scene=(g, cams, colors), P=P,
                        k4b=(idx, w, attrs, g_att))
    torch.cuda.synchronize()

    # 2b. the global entries of K2 and K3 at the ShapeFitting shapes
    sf = shapefit_scene(dev)
    verts_sf, isig_sf, colors_sf, cams_sf, targets_sf = sf
    rays_sf, origins_sf = camera_rays(*cams_sf, SF_HW)
    P_sf = verts_sf.shape[0]
    points_sf = verts_sf[None] - origins_sf[:, None, :]
    isig3 = (2.0 * expend_sigma(isig_sf))[None].expand(SF_B, P_sf, 3, 3)
    table_sf = fine.feature_table(points_sf, isig3)
    bs_sf, mppb = fine.production_bin_geometry(SF_HW, SF_K, P_sf, None, -1)
    need(mppb == -1, "the ShapeFitting geometry has a coarse stage")
    thr_act = -math.log(0.01 + 1.0 / 1e10)
    nb_sf = SF_B * math.prod(coarse.supertile_grid(*SF_HW, bs_sf))
    bits_sf = torch.randint(0, 16, (nb_sf, P_sf), dtype=torch.int32, device=dev,
                            generator=torch.Generator(dev).manual_seed(40))
    for bits in (None, bits_sf):
        args = (rays_sf, table_sf, bits, thr_act, SF_K, bs_sf, 1.0)
        got, want = fine_select_global(*args), fine_select_global_plain(*args)
        need(torch.equal(got[0], want[0]), f"K2 global bits={bits is not None}: selections differ")
        _, e = compare_select(got, want)
        err["fine_select_global"] = max(err["fine_select_global"], e)
        print(f"K2 global shapefit: P={P_sf} supertiles={nb_sf} bs={bs_sf} "
              f"bits={'random' if bits is not None else 'none'} selections equal, "
              f"valid slots {int((got[0] >= 0).sum())}, max_err(w)={e:.3e}")
        if bits is None:
            sel_sf = got
            head["k2g"] = args
    g_sf = [seeded(sel_sf[1].shape, dev, 50 + q) for q in range(4)]
    # (g_len, g_act, g_dsd, g_w): all set, g_w zero, and the trainer's own
    # configuration (only g_w: the loss reads the weights alone)
    for cots in (g_sf, g_sf[:3] + [torch.zeros_like(g_sf[3])], [None, None, None, g_sf[3]]):
        for want_rays in (False, True):
            b_args = (rays_sf, table_sf, *sel_sf, *cots, 1.0, want_rays)
            kb, pb = fine_bwd_global(*b_args), fine_bwd_global_plain(*b_args)
            e = grad_err(kb[0], pb[0], "K3 global rows")
            if want_rays:
                e = max(e, grad_err(kb[1], pb[1], "K3 global rays"))
            else:
                need(kb[1] is None and pb[1] is None, "K3 global: unasked ray gradient")
            err["fine_bwd_global"] = max(err["fine_bwd_global"], e)
    head["k3g"] = (rays_sf, table_sf, *sel_sf, None, None, None, g_sf[3], 1.0, False)
    print(f"K3 global shapefit: max_err/max|plain| {err['fine_bwd_global']:.3e}")
    torch.cuda.synchronize()

    # ---- 3. the main paths --------------------------------------------
    g, cams, colors = head["scene"]
    R, T, focal, principal = cams
    hw = (256, 256)
    launches = {k: 0 for k in KERNELS}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # 3a. the headline forward (slice 1)
    zero_counts()
    frag = vt.render_pipeline(g.verts, g.sigmas, *cams, image_size=hw,
                              max_assign=20, attrs=colors)
    cam_obj = vt.PerspectiveCameras(focal_length=300.0, principal_point=((128.0, 128.0),),
                                    image_size=(hw,), device=dev)
    renderer = vt.GaussianRenderer(cam_obj, vt.GaussianRenderSettings(image_size=hw))
    frag2 = renderer(g, R=R, T=T)
    white = vt.to_white_background(frag2, colors)
    add(read_counts("forward", ("emit_keys", "fine_select", "attr_merge")))
    for f in (frag, frag2):
        need(vt.get_overflow_points(f) == 0, "headline overflow_points != 0")
        need(torch.isfinite(f.vert_weight).all().item(), "non-finite weights")
    need(frag.attr_img.shape == (1, 256, 256, 3) and white.shape == (1, 256, 256, 3), "shapes")
    need(torch.isfinite(frag.attr_img).all().item() and torch.isfinite(white).all().item(),
         "non-finite images")
    need(torch.equal(frag.vert_index, frag2.vert_index), "render paths disagree")
    fused_vs_merge = (frag.attr_img - vt.interpolate_attr(frag, colors)).abs().max().item()
    need(fused_vs_merge <= 1e-5, f"fused attr image vs merge {fused_vs_merge}")
    print(f"headline: P={head['P']} overflow=0 valid_px={(frag.valid_num > 0).float().mean().item():.4f} "
          f"weight_sum={frag.vert_weight.sum().item():.2f} fused_vs_merge={fused_vs_merge:.2e}")

    # 3b. the headline fitting step (slice 2), and the 1K one
    ctx = vt.precompute_camera_ctx(R, T, focal, principal, hw, g.verts.shape[0],
                                   max_assign=20)
    zero_counts()
    frag_s, loss, params = fitting_step(g, cams, colors, hw, ctx)
    grads = torch.autograd.grad(loss, params, retain_graph=True)
    grads2 = torch.autograd.grad(loss, params)
    add(read_counts("fitting step", ("emit_keys", "fine_select", "fine_bwd")))
    need(vt.get_overflow_points(frag_s) == 0, "fitting step overflow_points != 0")
    for name, a, b in zip(("verts", "sigmas", "colors"), grads, grads2):
        need(bool(torch.isfinite(a).all()), f"non-finite {name} gradient")
        need(torch.equal(a, b), f"{name} gradient differs between two backward runs")
    gold_err = {}
    for tag, (n, hw_g, focal_g) in (("1k", (1000, (128, 128), 150.0)),
                                    ("headline", (10000, (256, 256), 300.0))):
        gold = np.load(GOLDEN_GRAD[tag])
        if tag == "headline":
            lv, gr = loss.item(), grads
        else:
            g1, cams1, colors1 = scene(n, hw_g, focal_g, dev)
            f1, l1, p1 = fitting_step(g1, cams1, colors1, hw_g)
            need(vt.get_overflow_points(f1) == 0, "1K fitting step overflow")
            lv, gr = l1.item(), torch.autograd.grad(l1, p1)
        e = {"loss": abs(lv - float(gold["loss"])) / abs(float(gold["loss"]))}
        need(e["loss"] <= GOLD_LOSS_TOL, f"golden {tag} loss {lv} vs {float(gold['loss'])}")
        for name, x in zip(("verts", "sigmas", "colors"), gr):
            e[name] = rel(x.cpu().numpy(), gold["grad_" + name])
            need(e[name] <= GOLD_GRAD_TOL, f"golden {tag} grad {name} rel err {e[name]:.3e}")
        gold_err[tag] = e
        print(f"fitting step {tag} vs voge_tpu golden: loss {lv:.8f} rel err "
              + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
    details["golden_grad"] = gold_err

    # 3c. the 1K quickstart through GaussianRenderer -> white background
    q, qcams, qcolors = scene(1000, (256, 256), 300.0, dev)
    qcam = vt.PerspectiveCameras(focal_length=300.0, principal_point=((128.0, 128.0),),
                                 image_size=(hw,), device=dev)
    qrend = vt.GaussianRenderer(qcam, vt.GaussianRenderSettings(image_size=hw))
    target = torch.rand((1, 256, 256, 3), device=dev,
                        generator=torch.Generator(dev).manual_seed(7))

    def white_step():
        cols = qcolors.detach().requires_grad_(True)
        img = vt.to_white_background(qrend(q, R=qcams[0], T=qcams[1]), cols)
        return torch.autograd.grad(((img - target) ** 2).mean(), (q.verts, cols))

    zero_counts()
    wg = white_step()
    add(read_counts("white background", ("emit_keys", "fine_select", "fine_bwd",
                                          "attr_merge", "attr_merge_bwd")))
    with plain_path():
        wp = white_step()
    white_err = {n: grad_err(a, b, f"white-background grad {n}")
                 for n, a, b in zip(("verts", "colors"), wg, wp)}
    print(f"quickstart white background fwd+bwd, kernel vs plain path: {white_err}")
    details["white_background_grad_err"] = white_err

    gold = np.load(GOLDEN)
    g1, cams1, colors1 = scene(1000, (128, 128), 150.0, dev)
    f1 = vt.render_pipeline(g1.verts, g1.sigmas, *cams1, image_size=(128, 128),
                            max_assign=20, attrs=colors1)
    gi = torch.as_tensor(gold["vert_index"], device=dev)
    agree = (f1.vert_index == gi).all(-1)
    flips = 1.0 - agree.float().mean().item()
    need(flips < FLIP_MAX, f"golden flips {flips}")
    gerr = {}
    for name, val in (("vert_weight", f1.vert_weight), ("attr_img", f1.attr_img)):
        ref = torch.as_tensor(gold[name], device=dev)
        gerr[name] = (val[agree] - ref[agree]).abs().max().item()
        need(gerr[name] <= W_TOL, f"golden {name} error {gerr[name]}")
    need(vt.get_overflow_points(f1) == 0, "golden scene overflow")
    print(f"golden 1K 128x128: flips={flips:.2e} max_err={gerr}")
    details["golden"] = dict(flips=flips, **gerr)

    fq = vt.render_pipeline(q.verts, q.sigmas, *qcams, image_size=(256, 256), max_assign=20)
    wsum = fq.vert_weight.sum().item()
    sil = vt.get_silhouette(fq).mean().item()
    qimg = vt.to_white_background(fq, qcolors)
    need(25000 < wsum < 31000 and 0.25 < sil < 0.45, f"quickstart bounds {wsum} {sil}")
    need(qimg[0, 0, 0].min().item() > 0.999 and qimg[0, -1, -1].min().item() > 0.999,
         "quickstart corners not white")
    print(f"quickstart 1K 256x256: weight_sum={wsum:.2f} silhouette={sil:.4f}")
    details["quickstart"] = dict(weight_sum=wsum, silhouette=sil)

    # 3d. the ShapeFitting step (slice 3) and three ShapeFitter steps
    no_coarse = ("fine_select_global", "fine_bwd_global", "attr_merge", "attr_merge_bwd")

    def compacted_unused(counts, path):
        need(all(counts[k] == 0 for k in ("emit_keys", "fine_select", "fine_bwd")),
             f"{path}: the compacted path's kernels ran on the no-coarse path")

    gold = np.load(GOLDEN_SF)
    zero_counts()
    leaves = [x.clone().requires_grad_(True) for x in (verts_sf, isig_sf, colors_sf)]
    frag_sf, loss_sf = shapefit_loss(*leaves, cams_sf, targets_sf)
    gr = torch.autograd.grad(loss_sf, leaves, retain_graph=True)
    gr2 = torch.autograd.grad(loss_sf, leaves)
    counts = read_counts("shapefit step", no_coarse)
    compacted_unused(counts, "shapefit step")
    add(counts)
    need(vt.get_overflow_points(frag_sf) == 0, "shapefit overflow_points != 0")
    valid_sf = int((frag_sf.vert_index >= 0).sum())
    e = {"loss": abs(loss_sf.item() - float(gold["loss"])) / abs(float(gold["loss"]))}
    need(e["loss"] <= GOLD_LOSS_TOL, f"shapefit loss {loss_sf.item()} vs {float(gold['loss'])}")
    for name, a, b in zip(("verts", "sigmas", "colors"), gr, gr2):
        need(bool(torch.isfinite(a).all()), f"non-finite shapefit {name} gradient")
        need(torch.equal(a, b), f"shapefit {name} gradient differs between two backward runs")
        e[name] = rel(a.cpu().numpy(), gold["grad_" + name])
        need(e[name] <= GOLD_GRAD_TOL, f"shapefit grad {name} rel err {e[name]:.3e}")
    print(f"shapefit step vs voge_tpu golden: loss {loss_sf.item():.8f} valid slots {valid_sf} "
          "overflow 0, rel err " + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))

    def make_fitter():
        return vt.ShapeFitter({"verts": verts_sf, "colors": colors_sf}, {"sigmas": isig_sf},
                              image_size=SF_HW, focal=cams_sf[2][0], principal=cams_sf[3][0],
                              max_assign=SF_K, device=dev)

    zero_counts()
    fitter = make_fitter()
    fit_loss = [fitter.step(cams_sf[0], cams_sf[1], *targets_sf) for _ in range(3)]
    counts = read_counts("ShapeFitter steps", no_coarse)
    compacted_unused(counts, "ShapeFitter steps")
    add(counts)
    for i, (a, b) in enumerate(zip(fit_loss, gold["fit_loss"])):
        e[f"fit_loss_{i}"] = abs(a - float(b)) / abs(float(b))
        need(e[f"fit_loss_{i}"] <= GOLD_LOSS_TOL, f"ShapeFitter step {i} loss {a} vs {float(b)}")
    for name, x0 in (("verts", verts_sf), ("colors", colors_sf)):
        moved = (fitter.params[name].detach() - x0).cpu().numpy()
        k = f"fit_{name}"
        e[k] = rel(moved, gold[k] - x0.cpu().numpy())
        need(e[k] <= GOLD_GRAD_TOL, f"ShapeFitter {name} rel err {e[k]:.3e}")
    print(f"ShapeFitter 3 steps vs voge_tpu golden: losses {fit_loss}, rel err "
          + ", ".join(f"{k} {v:.3e}" for k, v in e.items() if k.startswith("fit")))
    details["golden_shapefit"] = dict(e, valid_slots=valid_sf)

    # ---- 4. timings -----------------------------------------------------
    inputs = [g.verts.detach() * (1.0 + 1e-5 * i) for i in range(24)]
    sig = g.sigmas.detach()

    def forward(v):
        return vt.render_pipeline(v, sig, *cams, image_size=hw, max_assign=20,
                                  attrs=colors).attr_img

    def fwd_bwd(v):
        v = v.detach().requires_grad_(True)
        s = sig.detach().requires_grad_(True)
        c = colors.detach().requires_grad_(True)
        frag = vt.render_pipeline(v, s, *cams, image_size=hw, max_assign=20,
                                  cam_ctx=ctx, attrs=c)
        return torch.autograd.grad(bench_loss(frag), (v, s, c))

    def timed(fn, vs):
        out = []
        for v in vs:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(v)
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return out

    for label, fn in (("forward", forward), ("fwd+bwd", fwd_bwd)):
        runs = {"kernel": [], "plain": []}
        for v in inputs[:2]:
            fn(v)
        with plain_path():
            fn(inputs[0])
        torch.cuda.synchronize()
        for order, path in enumerate(("plain", "kernel", "kernel", "plain")):
            part = inputs[4 + 10 * (order % 2): 14 + 10 * (order % 2)]
            if path == "plain":
                with plain_path():
                    runs[path] += timed(fn, part)
            else:
                runs[path] += timed(fn, part)
        stats = {}
        for path, ts in runs.items():
            med = statistics.median(ts)
            stats[path] = dict(median_ms=med, min_ms=min(ts), max_ms=max(ts),
                               spread=(max(ts) - min(ts)) / med, n=len(ts))
            print(f"headline {label} {path} path: median {med:.3f} ms, "
                  f"min {min(ts):.3f}, max {max(ts):.3f}, n={len(ts)}")
        details[label] = stats
    step_ms = details["fwd+bwd"]["kernel"]["median_ms"]

    # the ShapeFitting step, ShapeFitter.step on 5 views: each step moves the
    # parameters, so every timed step has distinct inputs
    sf_fitter = make_fitter()

    def sf_step(_):
        return sf_fitter.step(cams_sf[0], cams_sf[1], *targets_sf)

    runs = {"kernel": [], "plain": []}
    sf_step(0)
    with plain_path():
        sf_step(0)
    for path in ("plain", "kernel", "kernel", "plain"):
        if path == "plain":
            with plain_path():
                runs[path] += timed(sf_step, range(10))
        else:
            runs[path] += timed(sf_step, range(10))
    stats = {}
    for path, ts in runs.items():
        med = statistics.median(ts)
        stats[path] = dict(median_ms=med, min_ms=min(ts), max_ms=max(ts),
                           spread=(max(ts) - min(ts)) / med, n=len(ts))
        print(f"shapefit step {path} path: median {med:.3f} ms, "
              f"min {min(ts):.3f}, max {max(ts):.3f}, n={len(ts)}")
    details["shapefit_step"] = stats

    k2, k3 = head["k2"], head["k3"]
    per = {
        "emit_keys": (lambda: emit_keys(*head["k1"]), lambda: emit_keys_plain(*head["k1"])),
        "fine_select": (lambda: fine_select(*k2), lambda: fine_select_plain(*k2)),
        "attr_merge": (lambda: attr_merge(*k3), lambda: attr_merge_plain(*k3)),
        "fold_weights": (lambda: fold_weights(*head["fold"]),
                         lambda: fold_weights_plain(*head["fold"])),
        "fine_bwd": (lambda: fine_bwd(*head["k3b"]), lambda: fine_bwd_plain(*head["k3b"])),
        "attr_merge_bwd": (lambda: attr_merge_bwd(*head["k4b"]),
                           lambda: attr_merge_bwd_plain(*head["k4b"])),
        "fine_select_global": (lambda: fine_select_global(*head["k2g"]),
                               lambda: fine_select_global_plain(*head["k2g"])),
        "fine_bwd_global": (lambda: fine_bwd_global(*head["k3g"]),
                            lambda: fine_bwd_global_plain(*head["k3g"])),
    }
    kern = []
    for name, (kfn, pfn) in per.items():
        ms = cuda_ms(kfn, 50)
        plain_ms = cuda_ms(pfn, 5 if name.startswith(("fine_select", "fine_bwd")) else 20)
        print(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms")
        _, src, rep = KERNELS[name]
        kern.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=launches[name], max_abs_err=err[name],
                         ms=ms, plain_ms=plain_ms))
    details["kernels"] = kern

    from torch.profiler import ProfilerActivity, profile

    def profiled(tag, fn, args, untraced_ms, path):
        """Device time per step from a trace of five steps, over the
        untraced median wall: the device's busy share."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a in args:
                fn(a)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kinds = {ev.key: ev.self_device_time_total / 1e3 for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA}
        dev_ms = sum(kinds.values()) / len(args)
        busy = dev_ms / untraced_ms
        top = sorted(kinds.items(), key=lambda kv: -kv[1])[:10]
        print(f"profile {tag}: device {dev_ms:.3f} ms per step, busy share {busy:.3f} of the "
              f"untraced median (traced wall {wall_ms / len(args):.3f} ms); top over "
              f"{len(args)} steps: " + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))
        (OUT_DIR / path).write_text(
            prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        return dict(device_ms_per_step=dev_ms, device_busy_share=busy,
                    traced_wall_ms_per_step=wall_ms / len(args),
                    device_ms_by_kernel=kinds)

    details["profile"] = profiled("fitting step", fwd_bwd, inputs[:5], step_ms, "profile.txt")
    details["profile_shapefit"] = profiled(
        "shapefit step", sf_step, range(5), details["shapefit_step"]["kernel"]["median_ms"],
        "profile_shapefit.txt")

    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(f"nvidia-smi: {smi_line()}")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
