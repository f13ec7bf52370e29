"""Drive the voge_tpu_torch render, its fitting step, the no-coarse
ShapeFitting trainer, texture extraction, the two-stage public tracer, the
point-cloud renders (100,000 points forward; 300,000 points forward +
backward), pose scoring / refinement, the occlusion and B = 8 steps, the
dense route above K = 128, the sharded render over meshes of the card and
the demos on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases:
  1. the card (nvidia-smi name and power limit) and the kernel build from
     ``voge_tpu_torch/csrc``, one ``nvcc`` per source, all at once (build
     seconds, ptxas register / spill report; K2's registers, spills and
     shared memory per instantiation and its resident blocks by K; K3's
     per-slot kernel's, its per-Gaussian kernel's at each lane width and the
     fold's registers and spills);
  2. each kernel against its plain PyTorch version on the card, on a 1K
     scene at 128x128 and on the 10K-Gaussian headline at 256x256: K2 at
     K = 5 and 20, with and without attributes, and all three
     of its entries at K = 5, 8, 16, 20, 25, 32, 64, 80 and 128 on the 1K
     scene (selections, len, act, dsd equal bit for bit, with and without a
     random bits plane, two runs equal); K3f; the fold,
     K3 (per-Gaussian rows; with and without attributes, with and without
     ray gradients, on the compacted entry each ray's mean-gradient sums
     (the camera centres' gradient), two runs equal to the bit; wherever it sums the ray
     gradient, the per-ray half on the same arguments, the fold and any d_w
     fused in, equal to it to the bit) and K4b with cotangents from
     a seeded ``torch.Generator``; K3 and the fold also at K = 5, 40, 80 and
     128 on the 1K scene and on the headline scene seen by 8 cameras (the
     pose batch, ray gradients); then, at the
     ShapeFitting shapes (5 views, 2,562 Gaussians, 128x128, K = 25), K2's
     global entry (with and without a random sub-bin bits plane, selections
     exact; the share of (block, Gaussian) pairs its cone cull drops and the
     pairs that pass, here and at the 300,000-point cloud) and K3's global
     entry (with and without ray gradients, with the weight cotangent set,
     zero and absent: the skipped fold equal to the bit to a zero g_w); at
     the texture shapes (10,242
     Gaussians, 256x672, K = 80) the two halves of K4b alone, ``attr_scatter``
     (beside ``index_add_``) and ``attr_dw``, and K2's compacted entry on
     the texture render's rows (K = 80, with and without attributes,
     selections exact; timed and bounded there too); at the headline K2's
     per-bin-list entry on ``rasterize_coarse``'s lists (selections exact)
     and K3's global entry on its outputs (no weights: the fold skipped,
     equal to the bit to a zero g_w);
     K3f and ``attr_dw`` at d = 1, 3, 4, 5, 8, 33 x K = 1, 3, 20, 80, 128 on
     7 and 1,001 pixels (ids of -1 and ids beyond the table) and at the
     headline and texture shapes: against their plain versions, two runs
     equal to the bit;
     the two halves of the split global backward (``fine_bwd_gauss``,
     ``fine_bwd_rays``) at the ShapeFitting shapes and on the 300,000-point
     cloud (320x320, K = 20) with seeded cotangents: each half against its
     plain version, the fold's entry + the pair against K3's unified global
     entry on the same inputs (the same kernels: equal to the bit where the
     per-Gaussian kernel takes 32 lanes a Gaussian), two runs equal to the
     bit; K2's global entry
     there against its plain version on a 32x32 crop of the rays and against
     the coarse path's selections on the whole image, and the whole image
     equal to the bit to the same kernel walking every Gaussian (no cone
     cull); the grouping of slots by id (``slot_runs``, which rows 10 and
     11 and K3 take) against its plain version, torch.sort + searchsorted,
     on the slot ids of every main path (headline, ShapeFitting, texture,
     two-stage, pose B = 8, 300K: one to three radix passes) and on edge
     cases (every slot empty, one id in every slot, 1, 256, 257, 65,536 and
     65,537 ids): run starts and order equal bit for bit, two runs equal,
     timed beside the plain version; the coarse stage (K1 ``emit_rows``,
     the grouping, ``coarse_globals``, ``coarse_rows``) at the headline,
     quickstart, texture (its re-emission at the 3x3 window), 100K and pose
     B = 8 shapes: each kernel against its plain version at every window
     the render emitted with, the rows with and without the inverse map,
     and the whole stage (``compact_candidates`` and the inverse map)
     against its int64 route (one torch.sort of int64 keys, searchsorted,
     row slicing), bit for bit;
  3. the main paths, each with every launch counter set to 0 just before it
     and read just after (the two glue kernels of K2's global entry counted
     too: one launch each a launch of the entry; "K1" below stands for the
     coarse stage's three kernels and its grouping, none of which a path
     without a coarse stage launches):
     - the forward at the headline, through ``render_pipeline(attrs=)`` and
       ``GaussianRenderer`` + ``to_white_background`` (K1, K2, K3f), the
       renderer also with numpy ``R``, ``T`` beside cameras on the card;
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
     - texture extraction at full width (``bench.py:189-231``: render at
       K = 80 -> ``sample_features`` -> normalise -> ``to_white_background``;
       K1, K2 at K = 80, ``attr_scatter``, K3f, no plain version):
       overflow 0, texture, weight sums and image against ``voge_tpu``'s
       golden file; then one backward through the sampler alone
       (``attr_dw``, K3f) against the plain path, two runs equal to the bit;
     - the two-stage tracer at full width on the headline scene
       (``rasterize_coarse`` -> ``ray_tracing_fine``; K2's per-bin-list
       entry, K3's global entry with the cotangents of len, act and dsd and
       the ray gradient): no bin truncated, selections against the render
       path's, forward + backward of a seeded linear loss against the plain
       path, two backward runs equal to the bit;
     - the published-size point-cloud forward (``bench.py:108-137``: 100,000
       fixed-radius Gaussians, 320x320, K = 20, default coarse stage; K1,
       the key sort, K2's compacted entry, no plain version): overflow 0,
       selections against K2's global entry;
     - the 300,000-point step, past ``voge_tpu``'s branch point of 262,144
       (``render_pipeline(max_point_per_bin=-1)`` -> ``interpolate_attr`` ->
       ``bench.py``'s loss -> gradients of verts, sigmas, R and T; K2
       global, K3f, K4b's d_w half, K3's unified entry, where ``voge_tpu``
       takes the fold and the two halves): gradients against the same step
       on the fold's entry and the two halves, two backward runs equal to
       the bit;
     - a frozen-scene step on the same cloud (``ray_tracing`` on constant
       points, only the cameras need a gradient): one launch of the per-ray
       half with the fold fused in, no per-Gaussian half and no grouping of
       the slot ids;
     - pose estimation on ``bench.py:324-361``'s batched shape (the 10K
       cuboid, 8 cameras, 256x256, K = 20, features = colours):
       ``PoseHypothesisScorer.score`` of 8 hypotheses in one chunk and three
       ``refine_pose`` steps (K1, K2, K3f, K4b's d_w half, and, the scene
       being frozen, K3's per-ray half alone: no grouping outside the coarse
       stage, no per-Gaussian kernel), kernel path against plain path, and
       the steps equal to the bit to the same steps with K3 whole; one
       step's camera gradients (R, T and the four pose scalars) held to the
       plain path's and equal to the bit to K3 whole's;
     then the 1K forward against its golden file and the quickstart bounds;
     then (phases 3k-3n, each printing its seconds) the occlusion step at
     full width (``bench.py:140-186``: two cuboids, 6,778 Gaussians,
     400x400, K = 60, ``max_point_per_bin=1500``, ``interpolate_attr`` and
     the silhouette; K1, K2, K3, K3f, K4b): the capacity's ``m_min``
     branch taken with the floor as the larger term (a spy), overflow 0,
     two backward runs equal to the bit, the loss within 1e-5 and the
     gradients within 1e-3 of ``voge_tpu``'s golden file, the selections'
     digest (count and id sum a pixel) against it; the headline step at
     B = 8 (``bench.py:324-361``, forward + backward) held the same way to
     its golden file; the float64 oracle (``voge_tpu_torch.oracle``: the
     dense route in float64 on the card) at the headline, against which the kernels' float32 gradients
     and the headline golden file's are both measured; and K = 200 through
     the dense route (no K2 or K3 launch; K3f, K4b and the grouped scatter
     of its backward) on the 10K cuboid at 256x256 in both modes (thr 0.01
     with the coarse stage, thr 1e-8 without) against the float64 oracle
     on the card, and at 64x64 against ``voge_tpu``'s golden file (the
     sigma gradient against the oracle: the file's float32 one is ~1.5e-3
     off), with its peak memory; no render at K <= 128 takes that route;
     then (phases 3o-3q) ``parallel.render_pipeline_sharded`` at the
     headline (the 10K cuboid padded to a multiple of 4 with far-away
     Gaussians, the 8 cameras of ``bench.py:324-361``, 256x256, K = 20,
     colours through ``interpolate_attr_sharded``, ``bench.py``'s loss) on
     four meshes of the one card (data 2 with the scene replicated; (2, 2)
     all-gather; (2, 2) ring; (1, 4) all-gather) against the single-device
     step (overflow 0, ``vert_index`` flips, weights on agreeing pixels, the
     loss and the gradients of verts, sigmas and colours, two runs equal to
     the bit), each step timed beside the single-device one;
     ``ShapeFitter(mesh=)`` on (1, 2) and (5, 1) at the ShapeFitting shapes
     for three steps against the unsharded trainer, and
     ``interpolate_attr_sharded`` / ``sample_features_sharded`` (forward and
     backward) at the texture shapes with two cameras against the
     single-device helpers; and the eight demos of ``voge_tpu_torch.demo`` at
     their own sizes (the optimization demos cut to two steps), into a
     temporary directory: their PNGs, finite losses, the coarse stage's
     overflow 0 on every render that has one (a spy on
     ``ops.fine.compact_candidates``); ``extract_texture`` skips without the
     upstream car data;
  4. CUDA-event timings of the headline forward and fitting step, of the
     ShapeFitting step, of the texture chain (and its three stages, and K2
     there by K) and of the two-stage forward + backward on the
     kernel path and on the plain path, in turns (no earlier path's depth
     was cut to make room), of the point-cloud forward
     and the 300,000-point step (kernel path only: the plain global select
     is dense over rays x Gaussians and cannot exist at that size), of the
     fold + pair against the unified entry on the same cotangents at the
     300K cloud, the ShapeFitting and the two-stage shapes (the split
     question), of K3's three parts apart (the per-slot kernel, the grouping
     of the slot ids beside its plain version, the per-Gaussian kernel at
     the rule's lane width and at 4, 8, 16 and 32 lanes a Gaussian) at the
     300K, headline and ShapeFitting shapes, of rows 6 and 7 at the 300K
     cloud by lane width and by route (a frozen scene's backward fused
     against the fold's entry + the unfused per-ray launch, in turns), of pose
     scoring and a refinement step (and the step by backward route: the
     per-ray half against K3 whole, in turns, with device ms and launches a
     step), and of each kernel against its plain version and, where
     one PyTorch call computes the same function, that call, with its device
     ms and its host µs a call (enqueue time, no synchronisation); rows 3,
     12 and 10 (K3f, ``attr_dw``, K4b) at both the headline and the texture
     shapes, their device ms also with the inputs rotated through copies
     that together exceed the L2 twice (``past_l2``); each kernel's
     bound (the larger of its bytes over the card's memory rate and its
     operations over the card's FP32 rate, counted from this run's inputs;
     K2's global entry both with every pair tested and with the passing
     pairs alone, which is its bound; its cone tests are printed beside it);
     K2's compacted entry at the 100K cloud, the rows' gather, the global
     entry's glue, and the global entry with and without its cull in turns;
     torch.profiler traces of five kernel-path steps of each path give the
     device's busy share and the time by kernel, and of ten calls of each
     kernel its device time beside its CUDA-event time; the coarse stage
     alone (``compact_candidates``) at its five shapes, staged kernels
     against the int64 route in turns (CUDA-event ms; from a profile the
     device ms, kernel launches, memsets and host reads a call; each call's
     host reads also counted on the host by torch's sync debug mode, and
     required: one read a render, two at the texture shapes, which
     re-emit), and the headline
     step, the texture chain, the 100K forward and pose scoring on either
     route in turns; last, by ``voge_tpu_torch.timing`` with a profile of
     each, the occlusion step, the headline step at B = 1 and B = 8 (the
     per-frame ratio) and the K = 200 step in both modes.  Every step
     median comes from ``voge_tpu_torch.timing`` (a pair of CUDA events a
     call, one synchronisation at the end); the kernel table's times from
     ``cuda_ms`` (a mean over back-to-back calls).

Any failed check raises, so the exit code is nonzero.  The last line is
``{"ok": true, "device": {...}}``; the line before it a JSON line of the
kernels, and before that the card's nvidia-smi line.  Without a CUDA device the script exits nonzero at once.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
GOLDEN = DATA / "voge_tpu_golden_1k_128.npz"
GOLDEN_GRAD = {"1k": DATA / "voge_tpu_golden_grad_1k_128.npz",
               "headline": DATA / "voge_tpu_golden_grad_10k_256.npz"}
GOLDEN_SF = DATA / "voge_tpu_golden_shapefit_128.npz"
GOLDEN_TEX = DATA / "voge_tpu_golden_texture_256x672.npz"
SF_B, SF_HW, SF_K = 5, (128, 128), 25   # the ShapeFitting step (bench.py:234-290)
TEX_HW, TEX_K = (256, 672), 80          # texture extraction (bench.py:189-231)
CLOUD_HW, CLOUD_K = (320, 320), 20      # the point-cloud render (bench.py:108-137)
POSE_B, POSE_HW = 8, (256, 256)         # batched pose hypotheses (bench.py:324-361)
OUT_DIR = ROOT / "chiprun_out"
# the coarse stage's kernels, which no other path launches, and with the
# grouping its launchers (PERF.md row 1)
COARSE_KERNELS = ("emit_rows", "coarse_globals", "coarse_rows")
COARSE = COARSE_KERNELS + ("slot_runs",)
KERNELS = {  # name -> (library, source, replaced TPU kernel)
    # the coarse stage: K1 and the two kernels that, with slot_runs, replace
    # the XLA sort and row slicing around it (voge_tpu/ops/coarse.py:417-440)
    "emit_rows": ("emit", "voge_tpu_torch/csrc/emit.cu",
                  "voge_tpu/ops/pallas_coarse.py:38"),
    "coarse_globals": ("emit", "voge_tpu_torch/csrc/emit.cu",
                       "voge_tpu/ops/pallas_coarse.py:38"),
    "coarse_rows": ("emit", "voge_tpu_torch/csrc/emit.cu",
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
    "attr_scatter": ("attr_merge_bwd", "voge_tpu_torch/csrc/attr_merge_bwd.cu",
                     "voge_tpu/ops/pallas_attr.py:168"),
    "attr_dw": ("attr_merge_bwd", "voge_tpu_torch/csrc/attr_merge_bwd.cu",
                "voge_tpu/ops/pallas_attr.py:190"),
    "fine_select_bins": ("fine_select", "voge_tpu_torch/csrc/fine_select.cu",
                         "voge_tpu/ops/pallas_fine.py:64"),
    # the global backward's two halves: K3's kernels with the fold off (the
    # per-Gaussian half) and its per-slot kernel alone (the per-ray half)
    "fine_bwd_gauss": ("fine_bwd", "voge_tpu_torch/csrc/fine_bwd.cu",
                       "voge_tpu/ops/pallas_bwd.py:162"),
    "fine_bwd_rays": ("fine_bwd", "voge_tpu_torch/csrc/fine_bwd.cu",
                      "voge_tpu/ops/pallas_bwd.py:213"),
    # the grouping of slots by id that rows 10, 11 (and K3) take: part of the
    # port of the scatter kernel, whose one-hot match it replaces
    "slot_runs": ("slot_runs", "voge_tpu_torch/csrc/slot_runs.cu",
                  "voge_tpu/ops/pallas_attr.py:168"),
}
# The card's published peaks (H100 SXM): device memory 3.35 TB/s, FP32
# outside the tensor cores 67 TFLOP/s.  A kernel's bound is the larger of its
# bytes over the first and its operations over the second.
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12
# Operation counts behind the bounds, per unit of work (multiplies, adds,
# divisions and transcendental calls each counted once per result):
# a (ray, candidate) hit test of K2: msk 5, ksk 17, len 1, d 6, e 15, act 5;
PAIR_FLOPS = 49
# one (block, Gaussian) cone test of K2's global entry: |u.c| 6, u x c 9, its
# norm 6, the sine 4, the comparison 3 (this kernel's own overhead, printed
# beside its bound and never counted into it);
CULL_FLOPS = 28
# one (j, k) term of the erf compositing (difference, scale, erf, 3 more);
WEIGHT_FLOPS = 6
# one (j, k) term of the weight fold (erf, exp and ~16 multiply-adds);
FOLD_FLOPS = 18
# a slot's chain rule in K3 (g_mu, g_Lambda and g_ray around the residual),
# and its two sides alone (the split backward's halves);
SLOT_BWD_FLOPS = 150
SLOT_GAUSS_FLOPS, SLOT_RAY_FLOPS = 110, 40
# K1, per Gaussian: projection 15, the rotated 2x2 block 108, radii and
# window 40, plus ~5 per bin-axis test and ~10 per window cell;
EMIT_FLOPS = 163
# a global member's bits in one supertile (4 origins, 8 bounds, 12 tests).
GLOBAL_FLOPS = 24
# The coarse stage's launches a call (the profiler's kernels, memsets and
# device-to-host copies of one compact_candidates) are counted, not bounded.
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
# The fold's entry + the split pair against the unified global entry on the
# same inputs: normwise 1e-5 (one arithmetic, the folded cotangents rounded
# once more).  Pose: scores within 1e-5 and parameters after three Adam steps
# within 1e-4 of the plain path's.
PAIR_TOL, SCORE_TOL, POSE_TOL = 1e-5, 1e-5, 1e-4
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


def on_card(ev):
    """A profiler event on the device timeline: work on the card or a
    user-annotated range there."""
    return ev.device_type == torch.autograd.DeviceType.CUDA


def on_device(ev):
    """A profiler event of work on the card: a kernel, memset or copy, not a
    user-annotated range (an optimizer's step is traced as the span of its
    kernels on the device timeline, which counts them, and the gaps between
    them, twice).  Fails where the profiler does not mark such ranges, rather
    than count them."""
    if not on_card(ev):
        return False
    need(hasattr(ev, "is_user_annotation"), "the profiler's events do not mark "
         "user-annotated ranges: device totals would count them on top of their kernels")
    return not ev.is_user_annotation


def device_ms(fn, n):
    """Device milliseconds a call of ``fn`` (its kernels and memsets), from a
    torch.profiler trace of ``n`` calls: what the wrapper's host work hides
    when back-to-back calls outrun the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages() if on_device(ev)) / 1e3 / n


def device_breakdown(fn, n, path, top=8):
    """Device milliseconds a call of ``fn`` and its ``top`` heaviest device
    events (kernels, memsets, copies) by name, per call, from a
    torch.profiler trace of ``n`` calls; the trace's table goes to
    ``OUT_DIR / path``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kinds = {ev.key: ev.self_device_time_total / 1e3 / n for ev in events if on_device(ev)}
    (OUT_DIR / path).write_text(events.table(sort_by="self_device_time_total", row_limit=40))
    return sum(kinds.values()), dict(sorted(kinds.items(), key=lambda kv: -kv[1])[:top])


def launch_profile(fn, n):
    """Per call of ``fn``, from a torch.profiler trace of ``n`` calls: device
    ms, kernel launches, memsets, device-to-host copies (host reads) and
    host-to-device copies."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = dict(device_ms=0.0, kernels=0, memsets=0, host_reads=0, host_writes=0)
    for ev in prof.key_averages():
        if not on_device(ev):
            continue
        out["device_ms"] += ev.self_device_time_total / 1e3
        key = ev.key.lower()
        kind = ("host_reads" if "dtoh" in key else "host_writes" if "htod" in key
                else "memsets" if "memset" in key else "kernels" if "memcpy" not in key
                else None)
        if kind:
            out[kind] += ev.count
    return {k: v / n for k, v in out.items()}


def host_syncs(fn, n):
    """Host reads of device data in each of ``n`` calls of ``fn``: the
    synchronizing CUDA calls (a copy to the host, ``item``, ``tolist``)
    that torch's sync debug mode reports, counted on the host.  Exact for
    every call, where a profiler trace (:func:`launch_profile`) averages
    over its calls and may lose a copy's record."""
    fn()
    torch.cuda.synchronize()
    saved = torch.cuda.get_sync_debug_mode()
    counts = []
    try:
        torch.cuda.set_sync_debug_mode("warn")
        for _ in range(n):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
            counts.append(sum("synchronizing CUDA operation" in str(w.message)
                              for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode(saved)
    return counts


@contextmanager
def sorted_route():
    """The coarse stage by its int64 route (one torch.sort of int64 keys,
    searchsorted, row slicing: ``ops.coarse._emit_candidates_sorted``), the
    reference and the library comparator of its kernels."""
    from voge_tpu_torch.ops import coarse

    saved = coarse._emit_candidates
    coarse._emit_candidates = coarse._emit_candidates_sorted
    try:
        yield
    finally:
        coarse._emit_candidates = saved


@contextmanager
def plain_path():
    """Route a render and its backward through the plain versions on CUDA
    tensors."""
    from voge_tpu_torch import sampler
    from voge_tpu_torch.ops import coarse, cuda_attr, cuda_coarse, cuda_fine, cuda_fine_bwd, fine

    swaps = [(coarse, "emit_rows", cuda_coarse.emit_rows_plain),
             (coarse, "slot_runs", cuda_attr.slot_runs_plain),
             (coarse, "coarse_globals", cuda_coarse.coarse_globals_plain),
             (coarse, "coarse_rows", cuda_coarse.coarse_rows_plain),
             (fine, "fine_select_bins", cuda_fine.fine_select_bins_plain),
             (sampler, "attr_scatter", cuda_attr.attr_scatter_plain),
             (sampler, "attr_dw", cuda_attr.attr_dw_plain),
             (sampler, "attr_merge", cuda_attr.attr_merge_plain),
             (fine, "fine_select", cuda_fine.fine_select_plain),
             (fine, "fine_bwd", cuda_fine_bwd.fine_bwd_plain),
             (fine, "fine_select_global", cuda_fine.fine_select_global_plain),
             (fine, "fine_bwd_global", cuda_fine_bwd.fine_bwd_global_plain),
             (fine, "fine_bwd_rays", cuda_fine_bwd.fine_bwd_rays_plain),
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


@contextmanager
def no_plain_version():
    """Make every kernel's plain version, and the coarse stage's int64 route,
    raise: a main path inside it ran on the kernels alone."""
    from voge_tpu_torch.ops import coarse, cuda_attr, cuda_coarse, cuda_fine, cuda_fine_bwd

    def refuse(name):
        def fn(*_a, **_k):
            raise RuntimeError(f"chip_smoke: the plain version {name} ran on the main path")
        return fn

    saved = [(m, n, getattr(m, n)) for m in (cuda_attr, cuda_coarse, cuda_fine, cuda_fine_bwd)
             for n in dir(m) if n.endswith("_plain")]
    saved.append((coarse, "_emit_candidates_sorted", coarse._emit_candidates_sorted))
    try:
        for m, n, _ in saved:
            setattr(m, n, refuse(n))
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


def rel_t(got, want):
    """Normwise relative error of two tensors, in float64 on their device."""
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


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


def texture_scene(dev):
    """``bench.py:204-214``'s texture scene through the port's own
    converters: ``ico_sphere(5)`` (10,242 Gaussians) through
    ``naive_vertices_converter(percentage=0.5, max_sig_rate=2)``, one view at
    ``dist=3, elev=0.1, azim=0.6`` (radians), focal 1800, principal (336,
    128), and the random image of ``np.random.RandomState(0)``.
    :return: (verts (N, 3), inverse sigmas (N,), (R, T, focal, principal),
        image (1, 256, 672, 3))"""
    import voge_tpu_torch as vt

    v, f = vt.ico_sphere(5)
    verts, isig, _ = vt.naive_vertices_converter(v, f, percentage=0.5, max_sig_rate=2)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    R, T = vt.look_at_view_transform(dist=3, elev=0.1, azim=0.6, degrees=False, device=dev)
    cams = (R, T, t([[1800.0, 1800.0]]), t([[336.0, 128.0]]))
    image = t(np.random.RandomState(0).uniform(size=(1,) + TEX_HW + (3,)))
    return t(verts), t(isig), cams, image


def texture_chain(verts, isig, cams, image, ctx):
    """``bench.py:220-227``: render at K = 80, pull the image back onto the
    Gaussians, re-render with the sampled texture; (fragments, weight sums,
    texture, image)."""
    import voge_tpu_torch as vt

    frag = vt.render_pipeline(verts, isig, *cams, image_size=TEX_HW, max_assign=TEX_K,
                              cam_ctx=ctx)
    feat, wsum = vt.sample_features(frag, image, n_vert=verts.shape[0])
    texture = feat / (1e-8 + wsum[:, None])
    return frag, wsum, texture, vt.to_white_background(frag, texture)


def cloud_scene(n, dev):
    """``bench.py:117-123``'s point-cloud scene at ``n`` points:
    ``RandomState(0).uniform(-1, 1, (n, 3))`` through
    ``fixed_pointcloud_converter(radius=0.01)``, one view at ``dist=4,
    elev=20, azim=30``, focal 400, principal (160, 160).
    :return: (verts (n, 3), inverse sigmas (n,), (R, T, focal, principal))"""
    import voge_tpu_torch as vt

    pts = np.random.RandomState(0).uniform(-1, 1, size=(n, 3)).astype(np.float32)
    verts, isig, _ = vt.fixed_pointcloud_converter(pts, radius=0.01)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    R, T = vt.look_at_view_transform(dist=4, elev=20, azim=30, device=dev)
    return t(verts), t(isig), (R, T, t([[400.0, 400.0]]), t([[160.0, 160.0]]))


def cloud_step(verts, isig, cams, colors):
    """The no-coarse point-cloud step: ``render_pipeline(max_point_per_bin=
    -1)`` -> ``interpolate_attr`` -> ``bench.py``'s loss, with verts, sigmas,
    R and T as leaves; (fragments, loss, leaves)."""
    import voge_tpu_torch as vt

    leaves = [x.detach().clone().requires_grad_(True) for x in (verts, isig, cams[0], cams[1])]
    frag = vt.render_pipeline(leaves[0], leaves[1], leaves[2], leaves[3], cams[2], cams[3],
                              image_size=CLOUD_HW, max_assign=CLOUD_K, max_point_per_bin=-1)
    img = vt.interpolate_attr(frag, colors)
    loss = ((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
    return frag, loss, leaves


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(n_bytes, flops):
    """(the least milliseconds the card could take, what bounds it)."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def slot_counts(idx):
    """(valid slots, sum over pixels of valid^2) of selections (..., K)."""
    v = (idx >= 0).sum(-1).double()
    return v.sum().item(), (v * v).sum().item()


def tile_rays(H, W, th, tw, device):
    """(TH, TW) live rays of each th x tw tile of an H x W image."""
    hs = (torch.arange((H - 1) // th + 1, device=device) * th)
    ws = (torch.arange((W - 1) // tw + 1, device=device) * tw)
    return ((hs + th).clamp(max=H) - hs)[:, None] * ((ws + tw).clamp(max=W) - ws)[None, :]


def compacted_pairs(bits_c, counts_c, H, W, bs):
    """(ray, candidate) pairs K2's compacted entry tests: for every
    supertile and sub-bin, its live rays times its occupied rows whose bit
    is set."""
    nb, M = bits_c.shape
    live = tile_rays(H, W, bs, bs, bits_c.device).double()      # per bin
    BH, BW = live.shape
    BH2, BW2 = (BH + 1) // 2, (BW + 1) // 2
    pad = torch.zeros((2 * BH2, 2 * BW2), dtype=live.dtype, device=live.device)
    pad[:BH, :BW] = live
    occupied = torch.arange(M, device=bits_c.device)[None, :] < counts_c[:, None]
    total = 0.0
    for i in range(2):
        for j in range(2):
            rays_g = pad[i::2, j::2].reshape(-1).repeat(nb // (BH2 * BW2))
            rows_g = ((((bits_c >> (2 * i + j)) & 1) > 0) & occupied).sum(1).double()
            total += (rays_g * rows_g).sum().item()
    return total


def cull_stats(rays, table, thr_act, bin_size):
    """What K2's global entry (no bits plane) does on these inputs, counted
    with the plain versions of its glue: (blocks, (block, Gaussian) pairs,
    of them culled, (ray, Gaussian) pairs left for the hit test, of them
    passing ``act < thr_act``).  A culled pair never passes (the proof in
    ``csrc/fine_select.cu``), so the last count is every passing pair."""
    from voge_tpu_torch.ops import cuda_fine as cf

    B = rays.shape[0]
    P = table.shape[0] // B
    th, tw = cf.global_tile(False, bin_size)
    cones, rows = cf.block_cones(rays, th, tw), cf.cull_rows(table, thr_act)
    # the two glue kernels against their plain versions (float64 inside both;
    # float32 out): cones and unit means to 1e-6, q to a relative 1e-5
    cones_p, rows_p = cf.block_cones_plain(rays, th, tw), cf.cull_rows_plain(table, thr_act)
    e_cone = (cones - cones_p).abs().max().item()
    e_u = (rows[:, :3] - rows_p[:, :3]).abs().max().item()
    e_q = ((rows[:, 3] - rows_p[:, 3]).abs() / rows_p[:, 3].clamp(min=1e-30)).max().item()
    need(e_cone <= 1e-6 and e_u <= 1e-6 and e_q <= 1e-5
         and torch.equal(rows[:, 3] > 0, rows_p[:, 3] > 0),
         f"K2 global glue kernels vs plain: cones {e_cone}, u {e_u}, q {e_q}")
    blocks = cf._tiles(rays, th, tw, float("nan"))               # th * tw = 128 rays
    per_img = blocks.shape[0] // B
    culled = tested = passing = 0
    for b in range(B):
        tab_b, rows_b = table[b * P:(b + 1) * P], rows[b * P:(b + 1) * P]
        for s0 in range(b * per_img, (b + 1) * per_img, 32):
            s1 = min(s0 + 32, (b + 1) * per_img)
            mask = cf.cull_mask_plain(cones[s0:s1], rows_b)
            culled += int(mask.sum())
            blk, gauss = (~mask).nonzero(as_tuple=True)
            for q0 in range(0, blk.numel(), 1 << 16):
                r = blocks[s0:s1][blk[q0:q0 + (1 << 16)]]        # (n, 128, 3)
                f = tab_b[gauss[q0:q0 + (1 << 16)]][:, None, :]
                _, act, _ = cf.hit_plain(f, [r[..., i] for i in range(3)])
                tested += int(torch.isfinite(r[..., 0]).sum())
                passing += int((act < thr_act).sum())
    return dict(blocks=cones.shape[0], block_pairs=cones.shape[0] * P, culled=culled,
                culled_share=culled / (cones.shape[0] * P), tested_pairs=tested,
                passing_pairs=passing, glue_err=dict(cones=e_cone, u=e_u, q_rel=e_q),
                two_level=two_level_stats(rays, table, rows))


def print_two_level(tag, st):
    print(f"K2 global {tag} two-level cull: {st['level1_pairs']} (super-tile, Gaussian) pairs "
          f"at level 1 over {st['super_tiles']} super-tiles keep {st['kept_rows']} rows; level 2's "
          f"blocks examine {st['level2_rows']} rows and stage {st['staged_rows']}; its warps test "
          f"{st['warp_tested_pairs']} (ray, Gaussian) pairs; super-tile cones vs plain "
          f"{st['super_cone_err']:.2e}, level 1's masks equal to plain")


def two_level_stats(rays, table, rows):
    """What the two-level route of K2's global entry does on these inputs:
    (super-tile, Gaussian) pairs level 1 tests, the rows its masks keep, the
    rows level 2's 8 x 16 blocks examine (their super-tile's) and stage (kept
    by a warp's cone), and the (ray, Gaussian) pairs its warps test (their
    rays times the staged rows their own cone keeps); level 1's kernel held
    to its plain version, the super-tiles' cones to theirs."""
    from voge_tpu_torch.ops import cuda_fine as cf

    B, H, W, _ = rays.shape
    P, S = table.shape[0] // B, cf._SUPER
    cones, sup, (TH4, TW4) = cf.two_level_cones(rays)
    e_sup = (sup - cf.super_cones_plain(cones, B, TH4, TW4, 2 * S)).abs().max().item()
    mask = cf.cull_lists(rows, sup, B, P)
    need(e_sup <= 1e-6 and torch.equal(mask, cf.cull_lists_plain(rows, sup, B, P)),
         f"K2 global level 1 vs plain: super-tile cones {e_sup}, masks equal "
         f"{torch.equal(mask, cf.cull_lists_plain(rows, sup, B, P))}")
    kept = cf.mask_bits(mask, P)                                  # (B, nsup, P)
    STW = cf.super_grid(TH4, TW4, 2 * S)[1]
    live = tile_rays(H, W, 4, 8, rays.device)                     # (TH4, TW4)
    TH, TW = (TH4 + 1) // 2, (TW4 + 1) // 2
    examined = staged = tested = 0
    for b in range(B):
        rows_b = rows[b * P:(b + 1) * P]
        for ty in range(TH):
            wy = torch.arange(2 * ty, min(2 * ty + 2, TH4), device=rays.device)
            q = (wy[:, None] * TW4 + torch.arange(TW4, device=rays.device)[None]).reshape(-1)
            own = ~cf.cull_mask_plain(cones[b * TH4 * TW4 + q], rows_b)   # (warps, P)
            st = (ty // S) * STW + torch.arange(TW4, device=rays.device) // (2 * S)
            st = st.repeat(wy.numel())
            wk = own & kept[b, st]
            tested += int((wk.sum(1) * live[wy].reshape(-1)).sum())
            for tx in range(TW):
                cols = (q % TW4) // 2 == tx
                staged += int(wk[cols].any(0).sum())
                examined += int(kept[b, (ty // S) * STW + tx // S].sum())
    nsup = sup.shape[0]
    return dict(super_tiles=nsup, level1_pairs=nsup * P, kept_rows=int(kept.sum()),
                level2_rows=examined, staged_rows=staged, warp_tested_pairs=tested,
                super_cone_err=e_sup)


# ---- the attribute merge's kernels K3f and attr_dw (rows 3 and 12) ----
MERGE_TOL = 1e-5     # K3f against its plain version, absolute (values within [0, max |attrs|])
EDGE_D, EDGE_K, EDGE_PIX = (1, 3, 4, 5, 8, 33), (1, 3, 20, 80, 128), (7, 1001)
L2_BYTES = 50 << 20  # the H100's L2


def edge_slots(dev, n_pix, K, d, n_rows, seed):
    """Seeded slots: a fifth of the ids -1, a ninth at or beyond ``n_rows``;
    weights summing to at most 1 a pixel; attribute rows in [0, 1]; a
    per-pixel cotangent."""
    gen = torch.Generator(dev).manual_seed(seed)
    idx = torch.randint(-n_rows // 4, n_rows + n_rows // 8, (n_pix, K), device=dev,
                        generator=gen, dtype=torch.int32).clamp(min=-1)
    w = torch.rand((n_pix, K), device=dev, generator=gen) / K
    attrs = torch.rand((n_rows, d), device=dev, generator=gen)
    g = torch.randn((n_pix, d), device=dev, generator=gen)
    return idx, w, attrs, g


def hold_attr_pair(tag, idx, w, attrs, g):
    """K3f and attr_dw on one input against their plain versions (K3f within
    MERGE_TOL, ids beyond the table read as empty slots, as the kernel's
    contract has it; attr_dw within GRAD_TOL of the plain one's largest entry,
    exactly 0 where that is all 0) and two runs equal to the bit; (K3f error,
    attr_dw error)."""
    from voge_tpu_torch.ops.cuda_attr import attr_dw, attr_dw_plain, attr_merge, attr_merge_plain

    img, img2 = attr_merge(idx, w, attrs), attr_merge(idx, w, attrs)
    want = attr_merge_plain(torch.where(idx < attrs.shape[0], idx, -1), w, attrs)
    e_m = (img - want).abs().max().item()
    need(e_m <= MERGE_TOL, f"K3f {tag}: kernel vs plain {e_m:.3e}")
    need(torch.equal(img, img2), f"K3f {tag}: two runs differ")
    d_w, d_w2 = attr_dw(idx, attrs, g), attr_dw(idx, attrs, g)
    want_w = attr_dw_plain(idx, attrs, g)
    scale = want_w.abs().max().item()
    if scale > 0:
        e_d = (d_w - want_w).abs().max().item() / scale
        need(e_d <= GRAD_TOL, f"attr_dw {tag}: kernel vs plain {e_d:.3e}")
    else:
        e_d = 0.0
        need(not d_w.any(), f"attr_dw {tag}: nonzero where no slot is valid")
    need(torch.equal(d_w, d_w2), f"attr_dw {tag}: two runs differ")
    return e_m, e_d


def host_us(fn, n=200):
    """Microseconds of host time a call of ``fn``: ``n`` calls enqueued with
    no synchronisation between them (``time.perf_counter``); the card may
    still be running them when the clock stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def past_l2(fn, *args):
    """``fn`` over copies of ``args`` in turn, enough that together they
    exceed the L2 twice, so that a call finds its inputs in DRAM (back-to-back
    calls on one input small enough to stay in the L2 read it from there)."""
    n = max(1, -(-2 * L2_BYTES // nbytes(*(a for a in args if torch.is_tensor(a)))))
    sets = itertools.cycle([args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                                     for _ in range(n - 1)])
    return lambda: fn(*next(sets))


def merge_bound(idx, w, attrs):
    """K3f's bound: the ids read whole, the weights of the valid slots (no
    other weight is needed), the attribute rows, the image written; 2 d
    operations a valid slot."""
    n_rows, d = attrs.shape
    valid = int(((idx >= 0) & (idx < n_rows)).sum())
    return bound_ms(nbytes(idx, attrs) + valid * 4 + idx.numel() // idx.shape[-1] * d * 4,
                    valid * 2 * d)


def dw_bound(idx, attrs, g):
    """``attr_dw``'s bound: the ids read and d_w written whole, the attribute
    rows, and the g rows of the pixels that hold a valid slot (no other row
    is needed); 2 d operations a valid slot."""
    n_rows, d = attrs.shape
    ok = (idx >= 0) & (idx < n_rows)
    pixels = int(ok.any(-1).sum())
    return bound_ms(2 * nbytes(idx) + nbytes(attrs) + pixels * d * 4, int(ok.sum()) * 2 * d)


def attr_rows_at_shapes(shapes, plain):
    """Rows 3 (K3f), 12 (attr_dw) and 10 (K4b) at each of ``shapes`` (tag ->
    (merge args, dw args, K4b args)): CUDA-event ms, device ms on the same
    inputs call after call and with the inputs past the L2 (``past_l2``),
    host µs a call, the plain version's ms, and the bound by the kernels
    line's rules (``merge_bound``, ``dw_bound``; K4b's: its inputs read once
    and its outputs written once, 4 d operations a valid slot)."""
    from voge_tpu_torch.ops.cuda_attr import attr_dw, attr_merge, attr_merge_bwd

    out = {"attr_merge": {}, "attr_dw": {}, "attr_merge_bwd": {}}
    for tag, (m_args, d_args, b_args) in shapes.items():
        idx, attrs = m_args[0], m_args[2]
        b_valid, _ = slot_counts(b_args[0])
        rows = {
            "attr_merge": (attr_merge, m_args, merge_bound(*m_args)),
            "attr_dw": (attr_dw, d_args, dw_bound(*d_args)),
            "attr_merge_bwd": (attr_merge_bwd, b_args,
                               bound_ms(nbytes(*b_args) + nbytes(b_args[1], b_args[2]),
                                        b_valid * 4 * b_args[2].shape[1])),
        }
        for name, (kfn, args, (b_ms, b_by)) in rows.items():
            call = lambda: kfn(*args)
            r = dict(ms=cuda_ms(call, 50), device_ms=device_ms(call, 20),
                     device_ms_past_l2=device_ms(past_l2(kfn, *args), 20),
                     host_us=host_us(call), plain_ms=cuda_ms(plain[name](tag), 5),
                     bound_ms=b_ms, bound_by=b_by)
            out[name][tag] = r
            print(f"kernel {name} at the {tag} shapes (n_pix {idx.numel() // idx.shape[-1]}, "
                  f"K {idx.shape[-1]}, d {attrs.shape[1]}): {r['ms']:.5f} ms (device "
                  f"{r['device_ms']:.5f}, past the L2 {r['device_ms_past_l2']:.5f}, host "
                  f"{r['host_us']:.2f} us a call), plain {r['plain_ms']:.4f} ms, bound "
                  f"{b_ms:.5f} ms by {b_by} (share {b_ms / r['ms']:.4f} event, "
                  f"{b_ms / r['device_ms']:.4f} device, "
                  f"{b_ms / r['device_ms_past_l2']:.4f} device past the L2)")
    return out


# ---- the occlusion and B = 8 steps, the dense route (K > 128) ----
GOLDEN_OCC = DATA / "voge_tpu_golden_occlusion_400.npz"
GOLDEN_B8 = DATA / "voge_tpu_golden_batch8_256.npz"
GOLDEN_LK = DATA / "voge_tpu_golden_large_k_64.npz"
OCC_HW, OCC_K, OCC_MPPB = (400, 400), 60, 1500   # occlusion (bench.py:140-186)
OCC_COLORS = ([[0, 0.2, 1], [0, 0.2, 1], [0, 1, 0.2], [0, 1, 0.2], [0, 1, 1], [0, 1, 1]],
              [[1, 0.2, 0], [1, 0.2, 0], [1, 1, 0], [1, 1, 0], [0.2, 1, 0], [0.2, 1, 0]])
B8 = 8                                            # the headline at B = 8 (bench.py:324-361)
LK_K = 200                                        # the dense route: K above MAX_K
LK_MODES = {"coarse": (0.01, None), "no_coarse": (1e-8, -1)}   # mode -> (thr, max_point_per_bin)
# the dense route against the float64 oracle on the card: values within 1e-4
# on agreeing pixels, gradients within 1e-3 normwise (W_TOL, GOLD_GRAD_TOL)


def occlusion_scene(dev):
    """``bench.py:140-186``'s scene from the port's numpy ``cuboid_gauss``
    (6,778 Gaussians), its cameras and colours."""
    import voge_tpu_torch as vt

    cg = vt.converter.Cuboid.cuboid_gauss
    v0, s0, c0 = cg((-0.8, 0.8), (-0.4, 0.4), (-0.6, 0.6), 4000, colors=np.array(OCC_COLORS[0]),
                    percentage=0.7)
    v1, s1, c1 = cg((-1, 1), (-1, 1), (-0.3, 0.3), 3000, colors=np.array(OCC_COLORS[1]),
                    percentage=0.7)
    t = lambda x: torch.tensor(np.asarray(x).astype(np.float32), device=dev)
    verts = t(np.concatenate([v0 + np.array([[0.5, 0, 1]]), v1], 0))
    R, T = vt.look_at_view_transform(dist=5, elev=10, azim=20, device=dev)
    cams = (R, T, torch.tensor([[300.0, 300.0]], device=dev),
            torch.tensor([[200.0, 200.0]], device=dev))
    return verts, t(np.concatenate([s0, s1], 0)), t(np.concatenate([c0, c1], 0)), cams


def batch8_cams(dev, hw=(256, 256)):
    import voge_tpu_torch as vt

    R, T = vt.look_at_view_transform(dist=[6.0] * B8, elev=list(np.linspace(5, 25, B8)),
                                     azim=list(np.linspace(50, 90, B8)), device=dev)
    return (R, T, torch.full((B8, 2), 300.0, device=dev),
            torch.tensor([[hw[1] / 2, hw[0] / 2]] * B8, device=dev))


def digest_flips(idx, gold_valid, gold_ids):
    """Share of pixels whose selections' digest (count, sum of ids) differs
    from a golden file's."""
    valid = (idx >= 0).sum(-1)
    ids = torch.where(idx >= 0, idx, 0).long().sum(-1)
    gv = torch.as_tensor(gold_valid.astype(np.int64), device=idx.device).reshape(valid.shape)
    gi = torch.as_tensor(gold_ids.astype(np.int64), device=idx.device).reshape(ids.shape)
    return 1.0 - ((valid == gv) & (ids == gi)).float().mean().item()


def hold_golden(tag, loss, grads, gold, prefix="", oracle=None):
    """The loss within GOLD_LOSS_TOL and each gradient within GOLD_GRAD_TOL
    (normwise) of a golden file's; with ``oracle`` (float64 gradients on the
    card) the sigma gradient is held to the oracle instead, and its distance
    to the file printed (``voge_tpu``'s float32 sigma gradient is ~1.5e-3
    from its float64 value where |mu| ~ 6)."""
    e = {"loss": abs(loss - float(gold[prefix + "loss"])) / abs(float(gold[prefix + "loss"]))}
    need(e["loss"] <= GOLD_LOSS_TOL, f"{tag} loss {loss} vs golden {float(gold[prefix + 'loss'])}")
    for i, name in enumerate(("verts", "sigmas", "colors")):
        x = grads[i]
        need(bool(torch.isfinite(x).all()), f"{tag}: non-finite {name} gradient")
        e[name] = rel(x.cpu().numpy(), gold[f"{prefix}grad_{name}"])
        if oracle is not None and name == "sigmas":
            e["sigmas_oracle"] = rel_t(x, oracle[i])
            need(e["sigmas_oracle"] <= GOLD_GRAD_TOL,
                 f"{tag}: sigma gradient vs the float64 oracle {e['sigmas_oracle']:.3e}")
        else:
            need(e[name] <= GOLD_GRAD_TOL, f"{tag}: {name} gradient vs golden {e[name]:.3e}")
    return e


def dense_step(verts, sigmas, cams, colors, hw, mode, f64=False):
    """A K = 200 render in ``mode`` -> bench's loss -> its gradients
    (``f64``: the float64 oracle, ``voge_tpu_torch.oracle.render``)."""
    import voge_tpu_torch as vt

    thr, mppb = LK_MODES[mode]
    dt = torch.float64 if f64 else torch.float32
    v, s, c = (x.detach().to(dt).requires_grad_(True) for x in (verts, sigmas, colors))
    render = vt.oracle.render if f64 else vt.render_pipeline
    frag = render(v, s, *cams, image_size=hw, max_assign=LK_K,
                  thr_activation=thr, max_point_per_bin=mppb, attrs=c)
    sil = vt.get_silhouette(frag)
    loss = ((frag.attr_img - 0.5) ** 2).mean() + (sil ** 2).mean()
    return frag, sil, loss, torch.autograd.grad(loss, (v, s, c))


def cell_paths(dev, zero_counts, read_counts, add, details, head):
    """The occlusion step and the headline step at B = 8 at full width, the
    dense route at K = 200 and the float64 oracle (phases 3k-3n): each main
    path with the launch counters set to 0 just before it and read just
    after; returns what their timings take."""
    import voge_tpu_torch as vt
    from voge_tpu_torch.ops import dense_select, fine

    state = {}
    need(dense_select.calls == 0,
         "a render at K <= 128 took the dense route on the earlier main paths")

    # 3k. the occlusion step (bench.py:140-186): the m_min branch of the
    # capacity heuristic, K3 at K = 60, K3f / K4b through interpolate_attr
    t0 = time.perf_counter()
    verts_o, sig_o, col_o, cams_o = occlusion_scene(dev)
    ctx_o = vt.precompute_camera_ctx(*cams_o, OCC_HW, verts_o.shape[0], max_assign=OCC_K,
                                     max_point_per_bin=OCC_MPPB)
    picks = []
    pick = fine._pick_m_max

    def spy(*a):
        picks.append((a, pick(*a)))
        return picks[-1][1]

    def occ_step(v):
        leaves = [x.detach().requires_grad_(True) for x in (v, sig_o, col_o)]
        frag = vt.render_pipeline(leaves[0], leaves[1], *cams_o, image_size=OCC_HW,
                                  max_assign=OCC_K, max_point_per_bin=OCC_MPPB, cam_ctx=ctx_o)
        img = vt.interpolate_attr(frag, leaves[2])
        loss = ((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
        return frag, loss, leaves

    gold = np.load(GOLDEN_OCC)
    fine._pick_m_max = spy
    try:
        zero_counts()
        with no_plain_version():
            frag_o, loss_o, leaves = occ_step(verts_o)
            gr = torch.autograd.grad(loss_o, leaves, retain_graph=True)
            gr2 = torch.autograd.grad(loss_o, leaves)
        add(read_counts("occlusion step", (*COARSE, "fine_select", "fine_bwd", "attr_merge",
                                           "attr_merge_bwd")))
    finally:
        fine._pick_m_max = pick
    (P_pad, bins, cc, m_min), m_out = picks[0]
    heuristic = -(-max(256, 8 * P_pad // bins) // cc) * cc
    need(len(picks) == 1 and m_min == 4 * OCC_MPPB and m_out > heuristic,
         f"occlusion: the capacity's m_min branch was not the larger term: {picks}")
    need(verts_o.shape[0] == 6778 and vt.get_overflow_points(frag_o) == 0 == int(gold["overflow"]),
         "occlusion: overflow_points != 0 or not 6,778 Gaussians")
    for a, b in zip(gr, gr2):
        need(torch.equal(a, b), "occlusion: the gradients differ between two backward runs")
    flips = digest_flips(frag_o.vert_index, gold["valid_num"], gold["id_sum"])
    need(flips < FLIP_MAX, f"occlusion: selections' digest differs on {flips} of the pixels")
    hist = torch.bincount(frag_o.valid_num.reshape(-1), minlength=OCC_K + 1).cpu().numpy()
    e = hold_golden("occlusion", loss_o.item(), gr, gold)
    print(f"phase 3k occlusion step (N={verts_o.shape[0]}, {OCC_HW[0]}x{OCC_HW[1]}, K={OCC_K}, "
          f"max_point_per_bin={OCC_MPPB}): overflow 0, m_min branch (floor {m_min}, rows of "
          f"{m_out} against the heuristic's {heuristic}), pixels at K {int(hist[-1])} (golden "
          f"{int(gold['valid_hist'][-1])}), digest flips {flips:.2e}, two backward runs equal, vs "
          "voge_tpu golden: " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
          + f"; {time.perf_counter() - t0:.1f} s")
    details["occlusion"] = dict(e, flips=flips, m_min=m_min, rows=m_out, heuristic=heuristic,
                                pixels_at_k=int(hist[-1]))
    state["occlusion"] = lambda v: torch.autograd.grad(*occ_step(v)[1:])
    state["occ_verts"] = verts_o

    # 3l. the headline step at B = 8 (bench.py:324-361): K1, K2, K3 with B > 1
    t0 = time.perf_counter()
    g, _, colors = head["scene"]
    cams8 = batch8_cams(dev)
    ctx8 = vt.precompute_camera_ctx(*cams8, (256, 256), g.verts.shape[0], max_assign=20)

    def b8_step(v):
        leaves = [x.detach().requires_grad_(True) for x in (v, g.sigmas, colors)]
        frag = vt.render_pipeline(leaves[0], leaves[1], *cams8, image_size=(256, 256),
                                  max_assign=20, cam_ctx=ctx8, attrs=leaves[2])
        return frag, bench_loss(frag), leaves

    gold = np.load(GOLDEN_B8)
    zero_counts()
    with no_plain_version():
        frag8, loss8, leaves = b8_step(g.verts)
        gr = torch.autograd.grad(loss8, leaves, retain_graph=True)
        gr2 = torch.autograd.grad(loss8, leaves)
    add(read_counts("B = 8 step", (*COARSE, "fine_select", "fine_bwd")))
    need(frag8.vert_index.shape[0] == B8 and vt.get_overflow_points(frag8) == 0,
         "B = 8: overflow_points != 0")
    for a, b in zip(gr, gr2):
        need(torch.equal(a, b), "B = 8: the gradients differ between two backward runs")
    flips = digest_flips(frag8.vert_index, gold["valid_num"], gold["id_sum"])
    need(flips < FLIP_MAX, f"B = 8: selections' digest differs on {flips} of the pixels")
    e = hold_golden("B = 8 step", loss8.item(), gr, gold)
    print(f"phase 3l headline step at B = {B8} (P={g.verts.shape[0]}, 256x256, K=20): overflow 0, "
          f"digest flips {flips:.2e}, two backward runs equal, vs voge_tpu golden: "
          + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
          + f"; {time.perf_counter() - t0:.1f} s")
    details["batch8"] = dict(e, flips=flips)
    state["b8"] = lambda v: torch.autograd.grad(*b8_step(v)[1:])

    # 3m. the float64 oracle at the headline: the dense route in float64 on
    # the card, against the kernels' float32 step and the golden file
    t0 = time.perf_counter()
    _, cams, _ = head["scene"]
    fr32, l32, p32 = fitting_step(g, cams, colors, (256, 256))
    g32 = torch.autograd.grad(l32, p32)
    v, s, c = (x.detach().double().requires_grad_(True) for x in (g.verts, g.sigmas, colors))
    fr64 = vt.oracle.render(v, s, *cams, image_size=(256, 256), max_assign=20, attrs=c)
    l64 = bench_loss(fr64)
    g64 = torch.autograd.grad(l64, (v, s, c))
    gold = np.load(GOLDEN_GRAD["headline"])
    agree = (fr64.vert_index == fr32.vert_index).all(-1)
    flips = 1.0 - agree.float().mean().item()
    need(flips < FLIP_MAX and vt.get_overflow_points(fr64) == 0,
         f"headline: the float64 oracle's selections differ on {flips} of the pixels")
    e = {"loss_port": abs(l32.item() - l64.item()) / l64.item(),
         "loss_golden": abs(float(gold["loss"]) - l64.item()) / l64.item()}
    for i, name in enumerate(("verts", "sigmas", "colors")):
        e[f"{name}_port"] = rel_t(g32[i], g64[i])
        e[f"{name}_golden"] = rel(gold[f"grad_{name}"], g64[i].cpu().numpy())
        need(e[f"{name}_port"] <= GOLD_GRAD_TOL, f"headline {name}: port vs oracle "
             f"{e[f'{name}_port']:.3e}")
    print(f"phase 3m float64 oracle at the headline (the dense route in float64 on the card): "
          f"selections flip on {flips:.2e} of the pixels against the kernels; normwise error "
          "against it, port (float32 kernels) / voge_tpu golden file: " + ", ".join(
              f"{n} {e[n + '_port']:.4e} / {e[n + '_golden']:.4e}"
              for n in ("loss", "verts", "sigmas", "colors"))
          + f"; {time.perf_counter() - t0:.1f} s")
    details["oracle_headline"] = dict(e, flips=flips)

    # 3n. K = 200: the dense route (voge_tpu's XLA select) at 256x256 in both
    # modes against the float64 oracle on the card, and at 64x64 against
    # voge_tpu's golden file
    gold = np.load(GOLDEN_LK)
    state["dense"] = {}
    for hw, focal in (((256, 256), 300.0), ((64, 64), 75.0)):
        gk, camk, colk = scene(10000, hw, focal, dev)
        for mode in LK_MODES:
            t0 = time.perf_counter()
            zero_counts()
            dense_select.calls = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with no_plain_version():
                frag, sil, loss, grads = dense_step(gk.verts, gk.sigmas, camk, colk, hw, mode)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            counts = read_counts(f"K = {LK_K} {mode} {hw[0]}x{hw[1]}",
                                 ("attr_merge", "attr_merge_bwd", "attr_scatter", "slot_runs"))
            add(counts)
            need(dense_select.calls == 1 and all(
                counts[k] == 0 for k in ("fine_select", "fine_select_global", "fine_bwd",
                                         "fine_bwd_global", *COARSE_KERNELS)),
                 f"K = {LK_K} {mode}: the route was not the dense one alone")
            need(vt.get_overflow_points(frag) == 0, f"K = {LK_K} {mode}: overflow_points != 0")
            past = int((frag.valid_num > 128).sum())
            o_frag, o_sil, o_loss, o_grads = dense_step(gk.verts, gk.sigmas, camk, colk, hw, mode,
                                                        f64=True)
            agree = (frag.vert_index == o_frag.vert_index).all(-1)
            flips = 1.0 - agree.float().mean().item()
            need(flips < FLIP_MAX, f"K = {LK_K} {mode}: {flips} of the pixels flip against the oracle")
            e = {"flips_oracle": flips}
            for name, a, b in (("w", frag.vert_weight, o_frag.vert_weight),
                               ("img", frag.attr_img, o_frag.attr_img), ("sil", sil, o_sil)):
                e[name] = (a.double()[agree] - b[agree]).abs().max().item()
                need(e[name] <= W_TOL, f"K = {LK_K} {mode}: {name} vs oracle {e[name]:.3e}")
            for i, name in enumerate(("verts", "sigmas", "colors")):
                e[f"grad_{name}"] = rel_t(grads[i], o_grads[i])
                need(e[f"grad_{name}"] <= GOLD_GRAD_TOL,
                     f"K = {LK_K} {mode}: grad {name} vs oracle {e[f'grad_{name}']:.3e}")
            if hw == (64, 64):
                pre = f"{mode}_"
                need(past == int((gold[pre + "valid_num"] > 128).sum()) > 0,
                     f"K = {LK_K} {mode}: pixels past 128 hits differ from the golden file")
                gflips = digest_flips(frag.vert_index, gold[pre + "valid_num"], gold[pre + "id_sum"])
                need(gflips < FLIP_MAX, f"K = {LK_K} {mode}: digest flips {gflips} against golden")
                same = torch.as_tensor(
                    (gold[pre + "valid_num"] == frag.valid_num[0].cpu().numpy()), device=dev)
                for name, a in (("attr_img", frag.attr_img[0]), ("silhouette", sil[0])):
                    ref = torch.as_tensor(gold[pre + name], device=dev)
                    e[f"golden_{name}"] = (a - ref)[same].abs().max().item()
                    need(e[f"golden_{name}"] <= W_TOL, f"K = {LK_K} {mode}: {name} vs golden")
                e.update({f"golden_{k}": v for k, v in hold_golden(
                    f"K = {LK_K} {mode}", loss.item(), grads, gold, pre, o_grads).items()})
                e["golden_flips"] = gflips
            else:
                state["dense"][mode] = (gk, camk, colk)
            print(f"phase 3n K = {LK_K} {mode} {hw[0]}x{hw[1]}: route dense (one dense select, "
                  f"no K2 / K3 launch), pixels past 128 hits {past}, peak memory {peak:.2f} GiB "
                  "above the inputs, vs the float64 oracle on the card"
                  + (" and voge_tpu's golden file" if hw == (64, 64) else "") + ": "
                  + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
                  + f"; {time.perf_counter() - t0:.1f} s")
            details[f"dense_{mode}_{hw[0]}"] = dict(e, past_128=past, peak_gib=peak)
    dense_select.calls = 0
    return state


# ---- the sharded render, ShapeFitter(mesh=), the demos ----
# (mesh shape, model axis, ring): the replicated scene, the all-gather merge on
# two shapes, the ring; every shard on the one card (a mesh may name a device
# more than once)
SHARD_MESHES = {"dp_2x1": ((2, 1), None, False), "gather_2x2": ((2, 2), "model", False),
                "ring_2x2": ((2, 2), "model", True), "gather_1x4": ((1, 4), "model", False)}
# ShapeFitter(mesh=) against the unsharded trainer: each loss within
# GOLD_LOSS_TOL relative, the parameters within FIT_TOL after three steps
FIT_TOL = 1e-4
DEMO_ITERS = 2      # the optimization demos' depth, cut from 400 / 200 / 320


def shard_paths(dev, zero_counts, read_counts, add, details, head):
    """Phases 3o-3q: the sharded render at the headline on four meshes of
    the one card, ``ShapeFitter(mesh=)`` at the ShapeFitting shapes, the
    replicated-scene helpers at the texture shapes, and the eight demos at
    their own sizes; each main path with the launch counters set to 0 just
    before it and read just after."""
    import contextlib
    import importlib
    import io
    import tempfile

    import voge_tpu_torch as vt
    from voge_tpu_torch import timing
    from voge_tpu_torch.ops import fine
    from voge_tpu_torch.parallel import (
        interpolate_attr_sharded, make_mesh, render_pipeline_sharded, sample_features_sharded,
    )

    # 3o. the sharded render at the headline: the 10K cuboid padded to a
    # multiple of 4 with far-away Gaussians, bench.py:324-361's 8 cameras,
    # colours through interpolate_attr, bench.py's loss
    t0 = time.perf_counter()
    g, _, colors = head["scene"]
    n = g.verts.shape[0]
    n_pad = -(-n // 4) * 4
    pad = lambda x, v: torch.cat([x.detach(), torch.full((n_pad - n,) + x.shape[1:], v,
                                                         device=dev)])
    verts, sigmas, cols = pad(g.verts, 100.0), pad(g.sigmas, 1.0), pad(colors, 0.5)
    cams8 = batch8_cams(dev)
    kw = dict(image_size=(256, 256), max_assign=20)

    def step(v, mesh=None, model_axis="model", ring=False):
        leaves = [x.detach().requires_grad_(True) for x in (v, sigmas, cols)]
        if mesh is None:
            frag = vt.render_pipeline(leaves[0], leaves[1], *cams8, **kw)
            img = vt.interpolate_attr(frag, leaves[2])
        else:
            frag = render_pipeline_sharded(leaves[0], leaves[1], *cams8, mesh=mesh,
                                           model_axis=model_axis, ring=ring, **kw)
            img = interpolate_attr_sharded(frag, leaves[2], mesh)
        loss = ((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
        return frag, loss, torch.autograd.grad(loss, leaves)

    def stats(fn, tag):
        st = timing.measure_stats(fn, args_fn=lambda i: (verts * (1.0 + 1e-5 * i),), n=10,
                                  warmup=1, device=dev)
        total, top = device_breakdown(lambda: fn(verts), 3, f"profile_sharded_{tag}.txt")
        return dict(median_ms=st["median"] * 1e3, spread=st["spread"],
                    iqr_spread=st["iqr_spread"], device_ms=total, device_ms_by_kernel=top)

    f1, l1, g1 = step(verts)
    need(vt.get_overflow_points(f1) == 0, "sharded headline: the single-device overflow != 0")
    out = {"single": stats(lambda v: step(v), "single")}
    for tag, (shape, axis, ring) in SHARD_MESHES.items():
        mesh = make_mesh(("data", "model"), shape, devices=[dev] * (shape[0] * shape[1]))
        zero_counts()
        with no_plain_version():
            fs, ls, gs = step(verts, mesh, axis, ring)
            _, ls2, gs2 = step(verts, mesh, axis, ring)
        add(read_counts(f"sharded headline {tag}", (*COARSE, "fine_select", "fine_bwd",
                                                    "attr_merge", "attr_merge_bwd")))
        need(all(torch.equal(a, b) for a, b in zip(gs, gs2)) and torch.equal(ls, ls2),
             f"sharded {tag}: two runs differ")
        agree = (fs.vert_index == f1.vert_index).all(-1)
        flips = 1.0 - agree.float().mean().item()
        need(flips < FLIP_MAX, f"sharded {tag}: vert_index flips on {flips} of the pixels")
        e = {"flips": flips, "w": (fs.vert_weight - f1.vert_weight)[agree].abs().max().item(),
             "loss": abs(ls.item() - l1.item()) / l1.item()}
        need(e["w"] <= W_TOL, f"sharded {tag}: weights {e['w']:.3e}")
        need(e["loss"] <= GOLD_LOSS_TOL, f"sharded {tag}: loss {e['loss']:.3e}")
        for name, a, b in zip(("verts", "sigmas", "colors"), gs, g1):
            e[name] = rel_t(a, b)
            need(e[name] <= GOLD_GRAD_TOL, f"sharded {tag}: {name} gradient {e[name]:.3e}")
        e["overflow"] = vt.get_overflow_points(fs)
        out[tag] = dict(stats(lambda v, m=mesh, a=axis, r=ring: step(v, m, a, r), tag), checks=e)
        print(f"phase 3o sharded headline {tag} (mesh {shape} on one card, "
              f"{'ring' if ring else 'replicated scene' if axis is None else 'all-gather'}; "
              f"P={n_pad} padded from {n}, B=8, 256x256, K=20): against the single-device "
              "step " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
              + f"; two runs equal; median {out[tag]['median_ms']:.3f} ms (spread "
              f"{out[tag]['spread']:.3f}), device {out[tag]['device_ms']:.3f} ms, single device "
              f"{out['single']['median_ms']:.3f} ms (device {out['single']['device_ms']:.3f})")
    for tag, st in out.items():
        print(f"phase 3o device ms by kernel, {tag} (a step, of {st['device_ms']:.3f}): "
              + "; ".join(f"{k[:60]} {v:.3f}" for k, v in st["device_ms_by_kernel"].items()))
    details["sharded_headline"] = out
    print(f"phase 3o: {time.perf_counter() - t0:.1f} s")

    # 3p. ShapeFitter(mesh=) at the ShapeFitting shapes (no coarse stage),
    # three steps against the unsharded trainer
    t0 = time.perf_counter()
    verts_s, isig_s, col_s, cams_s, targets = shapefit_scene(dev)

    def fit(mesh=None):
        f = vt.ShapeFitter({"verts": verts_s, "colors": col_s}, {"sigmas": isig_s},
                           image_size=SF_HW, focal=cams_s[2][0], principal=cams_s[3][0],
                           max_assign=SF_K, mesh=mesh, device=None if mesh else dev)
        return f, [f.step(cams_s[0], cams_s[1], *targets) for _ in range(3)]

    ref, ref_losses = fit()
    fits = {}
    for shape in ((1, 2), (5, 1)):
        zero_counts()
        with no_plain_version():
            f, losses = fit(make_mesh(("data", "model"), shape, devices=[dev] * (shape[0] * shape[1])))
        add(read_counts(f"ShapeFitter(mesh={shape})", ("fine_select_global", "fine_bwd_global",
                                                         "attr_merge", "attr_merge_bwd")))
        e = {"loss": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
             "params": max((f.params[k] - ref.params[k]).abs().max().item() for k in f.params)}
        need(e["loss"] <= GOLD_LOSS_TOL and e["params"] <= FIT_TOL,
             f"ShapeFitter(mesh={shape}) against the unsharded trainer: {e}")
        fits[str(shape)] = dict(e, losses=losses)
        print(f"phase 3p ShapeFitter(mesh={shape}) (2,562 Gaussians, 5 views, 128x128, K=25, "
              f"no coarse stage): three steps, losses {losses} against {ref_losses}; loss "
              f"{e['loss']:.3e}, parameters {e['params']:.3e}")

    # the replicated-scene helpers at the texture shapes, two cameras
    verts_t, isig_t, cams_t, _ = texture_scene(dev)
    R2, T2 = vt.look_at_view_transform(dist=[3.0, 3.0], elev=[0.1, 0.1],
                                       azim=[0.6, 0.6 - math.pi / 6], degrees=False, device=dev)
    cams_t = (R2, T2, cams_t[2].expand(2, 2), cams_t[3].expand(2, 2))
    N_t = verts_t.shape[0]
    image = torch.as_tensor(np.random.RandomState(0).uniform(size=(2,) + TEX_HW + (3,))
                            .astype(np.float32), device=dev)
    cols_t = ((verts_t + 1) / 2).contiguous()
    cot = seeded((2 * N_t, 3), dev, 31)
    mesh = make_mesh(("data", "model"), (2, 1), devices=[dev, dev])

    def texture_pair(sharded):
        v, im = verts_t.detach().requires_grad_(True), image.detach().requires_grad_(True)
        kt = dict(image_size=TEX_HW, max_assign=TEX_K)
        if sharded:
            frag = render_pipeline_sharded(v, isig_t, *cams_t, mesh=mesh, model_axis=None, **kt)
            img = interpolate_attr_sharded(frag, cols_t, mesh)
            feat, wsum = sample_features_sharded(frag, im, 2 * N_t, mesh)
        else:
            frag = vt.render_pipeline(v, isig_t, *cams_t, **kt)
            img = vt.interpolate_attr(frag, cols_t)
            feat, wsum = vt.sample_features(frag, im, n_vert=2 * N_t)
        grads = torch.autograd.grad((feat * cot).sum() + wsum.sum(), (v, im))
        return frag, img, feat, wsum, grads

    t1 = texture_pair(False)
    zero_counts()
    with no_plain_version():
        ts = texture_pair(True)
    add(read_counts("sharded texture helpers", (*COARSE, "fine_select", "attr_merge",
                                                 "attr_scatter", "attr_dw", "fine_bwd")))
    need(vt.get_overflow_points(ts[0]) == 0 == vt.get_overflow_points(t1[0]),
         "sharded texture helpers: overflow_points != 0")
    agree = (ts[0].vert_index == t1[0].vert_index).all(-1)
    e = {"flips": 1.0 - agree.float().mean().item(),
         "img": (ts[1] - t1[1])[agree].abs().max().item()}
    for name, a, b in (("feat", ts[2], t1[2]), ("wsum", ts[3], t1[3]), ("grad_image", ts[4][1], t1[4][1])):
        e[name] = (a - b).abs().max().item() / b.abs().max().item()
    e["grad_verts"] = rel_t(ts[4][0], t1[4][0])
    need(e["flips"] < FLIP_MAX and all(e[k] <= W_TOL for k in ("img", "feat", "wsum", "grad_image"))
         and e["grad_verts"] <= GOLD_GRAD_TOL, f"sharded texture helpers against single device: {e}")
    print("phase 3p interpolate_attr_sharded / sample_features_sharded (texture scene, 10,242 "
          "Gaussians, two cameras, 256x672, K=80, mesh (2, 1), scene replicated) against the "
          "single-device helpers: " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
          + f"; overflow 0; phase 3p {time.perf_counter() - t0:.1f} s")
    details["sharded_fitter"] = fits
    details["sharded_texture"] = e

    # 3q. the demos on the card at their own sizes; the optimization demos
    # cut to DEMO_ITERS steps; the coarse stage's overflow read by a spy
    it = dict(iters=DEMO_ITERS)
    demos = {  # name -> (kwargs, PNGs, coarse stage, kernels required)
        "render_cuboid": ({}, ["cuboid"], True, (*COARSE, "fine_select", "attr_merge")),
        "render_bunny": ({}, ["bunny"], True, (*COARSE, "fine_select", "attr_merge")),
        "render_pointclouds": ({}, ["pointcloud"], True, (*COARSE, "fine_select", "attr_merge")),
        "light_diffusion": ({}, [f"light_diffusion_{i}" for i in range(3)], True,
                            (*COARSE, "fine_select", "attr_merge")),
        "shape_fitting": (it, ["shape_fitting_result", "shape_fitting_target"], False,
                          ("fine_select_global", "fine_bwd_global", "attr_merge",
                           "attr_merge_bwd")),
        # constant colours / face ids: K4b's d_w half alone (attr_dw)
        "reason_occlusion": (it, ["reason_occ_after", "reason_occ_before", "reason_occ_target"],
                             True, (*COARSE, "fine_select", "fine_bwd", "attr_merge", "attr_dw")),
        "efficient_cuboid": (it, ["efficient_cuboid"], True,
                             (*COARSE, "fine_select", "fine_select_global", "fine_bwd_global",
                              "attr_merge", "attr_dw")),
        "extract_texture": ({}, ["extract_texture_rerender"], True,
                            (*COARSE, "fine_select", "attr_scatter", "attr_merge")),
    }
    seen = []
    real = fine.compact_candidates

    def spy(*a, **k):
        c = real(*a, **k)
        seen.append(c.overflow_c.sum())
        return c

    demo_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (dkw, pngs, coarse, required) in demos.items():
            mod = importlib.import_module(f"voge_tpu_torch.demo.{name}")
            out_dir = Path(tmp) / name
            seen.clear()
            buf = io.StringIO()
            zero_counts()
            t0 = time.perf_counter()
            fine.compact_candidates = spy
            try:
                with contextlib.redirect_stdout(buf), no_plain_version():
                    ret = mod.main(device=dev, out_dir=out_dir, **dkw)
                torch.cuda.synchronize()
            finally:
                fine.compact_candidates = real
            secs = time.perf_counter() - t0
            if name == "extract_texture" and "skipped: no reference car data" in buf.getvalue():
                need(ret is None and not out_dir.exists(), "extract_texture: skipped but wrote")
                print("phase 3q demo extract_texture: skipped: no reference car data")
                demo_s[name] = None
                continue
            add(read_counts(f"demo {name}", required))
            got = sorted(p.stem for p in out_dir.glob("*.png"))
            need(got == sorted(pngs), f"demo {name}: wrote {got}, not {pngs}")
            need(ret is None or math.isfinite(ret), f"demo {name}: returned {ret}")
            ovf = [int(x) for x in seen]
            need(bool(ovf) == coarse and not any(ovf),
                 f"demo {name}: the coarse stage's overflow per render {ovf}")
            demo_s[name] = dict(seconds=secs, returned=ret, coarse_renders=len(ovf))
            print(f"phase 3q demo {name}" + (f" ({DEMO_ITERS} steps, cut)" if dkw else "")
                  + f": {secs:.2f} s, PNGs {got}, returned {ret}, coarse-stage renders "
                  f"{len(ovf)} with overflow 0")
    details["demos"] = demo_s


def cell_timings(dev, state, head, profiled, details):
    """Medians and spreads of the new cells by ``voge_tpu_torch.timing``
    (distinct inputs, a pair of CUDA events a call), their device time and
    the device's busy share from a profile of five steps."""
    import voge_tpu_torch as vt
    from voge_tpu_torch import timing

    t0 = time.perf_counter()
    g, cams, colors = head["scene"]
    ctx = vt.precompute_camera_ctx(*cams, (256, 256), g.verts.shape[0], max_assign=20)

    def b1_step(v):
        leaves = [x.detach().requires_grad_(True) for x in (v, g.sigmas, colors)]
        frag = vt.render_pipeline(leaves[0], leaves[1], *cams, image_size=(256, 256),
                                  max_assign=20, cam_ctx=ctx, attrs=leaves[2])
        return torch.autograd.grad(bench_loss(frag), leaves)

    verts_o = state["occ_verts"]
    dense = state["dense"]

    def dense_fn(mode):
        gk, camk, colk = dense[mode]
        return lambda v: dense_step(v, gk.sigmas, camk, colk, (256, 256), mode)[3]

    dense_verts = lambda mode: (lambda i: (dense[mode][0].verts * (1.0 + 1e-5 * i),))

    cells = {"occlusion_step": (state["occlusion"], lambda i: (verts_o * (1.0 + 1e-4 * i),), 10),
             "headline_step_b1": (b1_step, lambda i: (g.verts * (1.0 + 1e-5 * i),), 20),
             "headline_step_b8": (state["b8"], lambda i: (g.verts * (1.0 + 1e-5 * i),), 10),
             "dense_k200_coarse_step": (dense_fn("coarse"), dense_verts("coarse"), 5),
             "dense_k200_no_coarse_step": (dense_fn("no_coarse"), dense_verts("no_coarse"), 3)}
    out = {}
    for name, (fn, args_fn, n) in cells.items():
        st = timing.measure_stats(fn, args_fn=args_fn, n=n, warmup=1, device=dev)
        ms = st["median"] * 1e3
        prof = profiled(name, fn, [args_fn(100 + i)[0] for i in range(3 if n < 10 else 5)], ms,
                        f"profile_{name}.txt")
        out[name] = dict(median_ms=ms, spread=st["spread"], iqr_spread=st["iqr_spread"],
                         min_ms=min(st["estimates"]) * 1e3, max_ms=max(st["estimates"]) * 1e3,
                         n=n, device_ms=prof["device_ms_per_step"],
                         busy_share=prof["device_busy_share"])
        print(f"{name} (timing.py): median {ms:.3f} ms, spread {st['spread']:.3f}, iqr spread "
              f"{st['iqr_spread']:.3f}, n={n}; device {prof['device_ms_per_step']:.3f} ms, busy "
              f"{prof['device_busy_share']:.3f}")
    ratio = out["headline_step_b8"]["median_ms"] / B8 / out["headline_step_b1"]["median_ms"]
    print(f"headline step per frame, B = 8 over B = 1: {ratio:.3f} "
          f"({out['headline_step_b8']['median_ms'] / B8:.3f} ms a frame against "
          f"{out['headline_step_b1']['median_ms']:.3f}); {time.perf_counter() - t0:.1f} s")
    details["cell_timings"] = dict(out, b8_per_frame_ratio=ratio)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible; the port's checks run only on a GPU")
    sys.path.insert(0, str(ROOT))
    import voge_tpu_torch as vt
    from voge_tpu_torch import _build, timing, trace
    from voge_tpu_torch.ops import coarse, fine
    from voge_tpu_torch.ops.cuda_attr import (
        attr_dw, attr_dw_plain, attr_merge, attr_merge_bwd, attr_merge_bwd_plain,
        attr_merge_plain, attr_scatter, attr_scatter_plain, slot_runs, slot_runs_plain,
    )
    from voge_tpu_torch.ops.cuda_coarse import (
        coarse_globals, coarse_globals_plain, coarse_rows, coarse_rows_plain, emit_rows,
        emit_rows_plain,
    )
    from voge_tpu_torch.aggregation import expend_sigma
    from voge_tpu_torch.ops.cuda_fine import (
        fine_select, fine_select_bins, fine_select_bins_plain, fine_select_global,
        fine_select_global_plain, fine_select_plain,
    )
    from voge_tpu_torch.ops import cuda_fine, cuda_fine_bwd
    from voge_tpu_torch.ops.cuda_fine_bwd import (
        fine_bwd, fine_bwd_gauss, fine_bwd_gauss_plain, fine_bwd_global, fine_bwd_global_plain,
        fine_bwd_plain, fine_bwd_rays, fine_bwd_rays_plain, fold_weights, fold_weights_plain,
        group_width,
    )
    from voge_tpu_torch.rays import camera_rays

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    OUT_DIR.mkdir(exist_ok=True)
    details = {}
    # the kernel wrappers' launches, counted by the port's tracing
    # (``launch.<name>``) between zero_counts() and read_counts(), which
    # turn it on and off again so that no timing runs with it on
    launchers = ("emit_rows", "coarse_globals", "coarse_rows", "fine_select", "attr_merge",
                 "fold_weights", "fine_bwd", "attr_merge_bwd", "fine_select_global",
                 "fine_bwd_global", "attr_scatter", "attr_dw", "fine_select_bins",
                 "fine_bwd_gauss", "fine_bwd_rays", "slot_runs")

    # the two small kernels behind K2's global entry (its cone cull's glue):
    # counted like the entries, and held to one launch each a launch of it
    glue_launchers = ("cull_rows", "block_cones")

    def launched(name):
        return trace.counts().get(f"launch.{name}", 0)

    def zero_counts():
        trace.reset()
        trace.enable()

    def read_counts(path, required):
        torch.cuda.synchronize()
        counts = {k: launched(k) for k in launchers}
        glue = {k: launched(k) for k in glue_launchers}
        trace.disable()
        print(f"main path {path}: launches {counts}; K2 global's glue {glue}")
        for k in required:
            need(counts[k] > 0, f"{k} was not launched on the main path {path}")
        need(all(v == counts["fine_select_global"] for v in glue.values()),
             f"main path {path}: K2's global entry ran without its cone cull")
        return counts

    # ---- 1. card and build --------------------------------------------
    smi = smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    details["card"] = smi
    libs = dict.fromkeys(lib for lib, _, _ in KERNELS.values())
    for lib in libs:    # built in this run, so that its time and ptxas report are this run's
        (_build.BUILD_DIR / f"lib{lib}.so").unlink(missing_ok=True)
    t0 = time.perf_counter()
    _build.load_all(libs)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s wall, in parallel: " + ", ".join(
        f"{k} {v[0]:.1f} s" for k, v in _build.build_info.items()))
    ptxas = "\n".join(f"== {k}\n{v[1]}" for k, v in _build.build_info.items())
    (OUT_DIR / "ptxas.txt").write_text(ptxas)
    for line in ptxas.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    details["build_s"] = build_s
    # K2's three instantiations (compacted 0, global 1, lists 2): one code path
    # at every K, the top-K in K KB of dynamic shared memory beside 18.6 KB of
    # staging, so the resident blocks an SM follow from K and the registers
    k2_ptxas = _build.build_info["fine_select"][1].splitlines()
    details["ptxas_k2"] = {}
    k2_regs = 0
    for mode, tag in ((0, "compacted"), (1, "global"), (2, "lists")):
        at = next(i for i, line in enumerate(k2_ptxas)
                  if f"fine_select_kernelILi{mode}E" in line and "Compiling" in line)
        report = " ".join(x.strip() for x in k2_ptxas[at + 2:at + 4])
        print(f"ptxas K2 {tag}: {report}")
        details["ptxas_k2"][tag] = report
        k2_regs = max(k2_regs, int(re.search(r"Used (\d+) registers", report).group(1)))
    k2_smem = lambda K: 256 * 64 + K * 128 * 8 + 256 * 8 + 128
    k2_blocks = lambda K: min(16, 65536 // (k2_regs * 128), 232448 // (k2_smem(K) + 1024))
    print(f"K2 dynamic shared memory and resident blocks of 128 threads an SM (of 227 KB, 1 KB "
          f"a block reserved; of 65,536 registers at {k2_regs} a thread): " + ", ".join(
              f"K={K} {k2_smem(K)} B -> {k2_blocks(K)}" for K in (5, 20, 25, 32, 64, 80, 128)))
    details["k2_blocks_an_sm"] = {K: k2_blocks(K) for K in (5, 20, 25, 32, 64, 80, 128)}
    # K3's two kernels (the per-Gaussian one at each lane width) and the
    # fold: one code path at every K (no K bucket)
    details["ptxas_k3"] = {}
    for lib, kname in (("fine_bwd", "fine_bwd_slots_kernel"),
                       *(("fine_bwd", f"fine_bwd_runs_kernelILi{G}E") for G in (4, 8, 16, 32)),
                       ("fold_weights", "fold_kernel")):
        lines = _build.build_info[lib][1].splitlines()
        at = next(i for i, line in enumerate(lines) if kname in line and "Compiling" in line)
        report = " ".join(x.strip() for x in lines[at + 2:at + 4])
        print(f"ptxas K3 {kname}: {report}")
        details["ptxas_k3"][kname] = report

    # ---- 2. kernels against their plain versions ----------------------
    err = {k: 0.0 for k in KERNELS}

    def hold_k3(tag, name, b_args):
        """K3's entry ``name`` against its plain version (each output within
        GRAD_TOL of the plain one's largest entry) and two runs equal to the
        bit; on the compacted entry also with the per-ray mean-gradient sums
        (``return_mu``: the camera centres' gradient) held the same way, the
        other outputs equal to the bit to the call without them.  Where it
        sums the ray gradient, the per-ray half on the same arguments (one
        launch, the fold and any d_w fused in: a frozen scene's backward),
        with and without the mean sums, equal to the entry to the bit and
        held to its plain version."""
        kfn, pfn = ((fine_bwd, fine_bwd_plain) if name == "fine_bwd"
                    else (fine_bwd_global, fine_bwd_global_plain))
        same = lambda a, b: (a is None and b is None) or torch.equal(a, b)
        kb, again, pb = kfn(*b_args), kfn(*b_args), pfn(*b_args)
        need(kb[0].shape == pb[0].shape == (b_args[1].shape[0], kb[0].shape[1]),
             f"K3 {tag}: not one row per Gaussian")
        e = grad_err(kb[0], pb[0], f"K3 rows {tag}")
        need(torch.equal(kb[0], again[0]), f"K3 {tag}: two runs differ")
        k_mu = None
        if name == "fine_bwd":
            km, km2 = kfn(*b_args, return_mu=True), kfn(*b_args, return_mu=True)
            need(same(km[0], kb[0]) and same(km[1], kb[1]),
                 f"K3 {tag}: the mean sums change the rows or the ray gradient")
            need(torch.equal(km[2], km2[2]), f"K3 {tag}: two runs of g_mu differ")
            e = max(e, grad_err(km[2], pfn(*b_args, return_mu=True)[2], f"K3 g_mu {tag}"))
            k_mu = km[2]
        if b_args[-1]:
            e = max(e, grad_err(kb[1], pb[1], f"K3 rays {tag}"))
            need(torch.equal(kb[1], again[1]), f"K3 {tag}: two runs differ")
            rays, table, idx, length, act, dsd, w, gl, ga, gd, gw, ow = b_args[:12]
            extra = dict(attrs=b_args[12], g_img=b_args[13]) if name == "fine_bwd" else {}
            halves = (rays, table, idx, length, dsd, gl, ga, gd)
            kw = dict(act=act, w=w, g_w=gw, agg_ow=ow, **extra)
            fr = fine_bwd_rays(*halves, **kw)
            fr_m, fr_mu = fine_bwd_rays(*halves, **kw, return_mu=True)
            need(torch.equal(fr, kb[1]) and torch.equal(fr_m, kb[1]),
                 f"K3 {tag}: the per-ray half differs from the entry")
            need(k_mu is None or torch.equal(fr_mu, k_mu),
                 f"K3 {tag}: the per-ray half's g_mu differs from the entry's")
            pr, pr_mu = fine_bwd_rays_plain(*halves, **kw, return_mu=True)
            err["fine_bwd_rays"] = max(err["fine_bwd_rays"],
                                       grad_err(fr, pr, f"fine_bwd_rays fused {tag}"),
                                       grad_err(fr_mu, pr_mu, f"fine_bwd_rays g_mu {tag}"))
        else:
            need(kb[1] is None and pb[1] is None, f"K3 {tag}: unasked ray gradient")
        err[name] = max(err[name], e)
        return kb
    shapes = {"small": (1000, (128, 128), 150.0), "headline": (10000, (256, 256), 300.0)}
    head = {}
    for tag, (n, hw, focal) in shapes.items():
        g, cams, colors = scene(n, hw, focal, dev)
        rays, points, isig = stage_inputs(g, cams, hw)
        P = points.shape[1]
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
            feats = fine.feature_table(points, isig)
            for with_attrs in (False, True):
                for want_rays in (False, True):
                    b_args = (rays, feats, *sel[:5], *g_cot, 1.0,
                              colors if with_attrs else None,
                              g_img if with_attrs else None, want_rays)
                    hold_k3(f"{tag} K={K} attrs={with_attrs} rays={want_rays}", "fine_bwd",
                            b_args)
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
            head.update(scene=(g, cams, colors), P=P, k4b=(idx, w, attrs, g_att))
    torch.cuda.synchronize()

    # 2a. every entry of K2 at every K the kernel takes (one code path, the
    # top-K in shared memory), on the 1K scene at 128x128: selections and
    # len / act / dsd equal to the plain versions bit for bit
    g1, cams1, colors1 = scene(1000, (128, 128), 150.0, dev)
    rays1, points1, isig1 = stage_inputs(g1, cams1, (128, 128))
    table1 = fine.feature_table(points1, isig1)
    thr_act = -math.log(0.01 + 1.0 / 1e10)
    bs1, mppb1 = coarse.coarse_bin_config((128, 128), 20, points1.shape[1])
    bp1 = vt.ops.rasterize_coarse(*cams1, points1, isig1, (128, 128), 0.01, bs1, mppb1)
    bits1 = torch.randint(0, 16, (math.prod(coarse.supertile_grid(128, 128, bs1)),
                                  points1.shape[1]), dtype=torch.int32, device=dev,
                          generator=torch.Generator(dev).manual_seed(41))
    for K in (5, 8, 16, 20, 25, 32, 64, 80, 128):
        c = fine.compact_candidates(*cams1, points1, isig1, (128, 128), 0.01, K)
        tab = fine.candidate_table(points1, isig1, c.pos_c)
        pairs = [("fine_select", fine_select, fine_select_plain,
                  (rays1, tab, c.bits_c, c.ids_c, c.counts_c, c.thr_act, K, c.bin_size, 1.0,
                   colors1)),
                 ("fine_select_global", fine_select_global, fine_select_global_plain,
                  (rays1, table1, None, thr_act, K, bs1, 1.0)),
                 ("fine_select_global", fine_select_global, fine_select_global_plain,
                  (rays1, table1, bits1, thr_act, K, bs1, 1.0)),
                 ("fine_select_bins", fine_select_bins, fine_select_bins_plain,
                  (rays1, table1, bp1, thr_act, K, bs1))]
        for name, kfn, pfn, args in pairs:
            got, want = kfn(*args), pfn(*args)
            need(all(torch.equal(a, b) for a, b in zip(got[:4], want[:4])),
                 f"{name} K={K}: selections or len / act / dsd differ from the plain version")
            need(all(torch.equal(a, b) for a, b in zip(got[:4], kfn(*args)[:4])),
                 f"{name} K={K}: two runs differ")
            for a, b in zip(got[4:], want[4:]):
                e = (a - b).abs().max().item()
                need(e <= W_TOL, f"{name} K={K}: weights / image error {e}")
                err[name] = max(err[name], e)
    print("K2 every entry at K = 5, 8, 16, 20, 25, 32, 64, 80, 128 on the 1K scene: selections, "
          "len, act, dsd equal to the plain versions bit for bit; two runs equal")

    # K3 (compacted entry, attributes, with and without rays) and the fold on
    # small frames at K = 5, 40, 80, 128: one code path at every K
    colors1b = colors1.contiguous()
    for K in (5, 40, 80, 128):
        c = fine.compact_candidates(*cams1, points1, isig1, (128, 128), 0.01, K)
        tab = fine.candidate_table(points1, isig1, c.pos_c)
        sel = fine_select(rays1, tab, c.bits_c, c.ids_c, c.counts_c, c.thr_act, K, c.bin_size,
                          1.0, colors1b)
        g_cot = [seeded(sel[1].shape, dev, 100 + q) for q in range(4)]
        g_img = seeded(rays1.shape, dev, 104)
        for want_rays in (False, True):
            hold_k3(f"1K K={K} rays={want_rays}", "fine_bwd",
                    (rays1, table1, *sel[:5], *g_cot, 1.0, colors1b, g_img, want_rays))
        f_args = (*sel[1:5], g_cot[3], 1.0)
        err["fold_weights"] = max(err["fold_weights"], *(
            grad_err(a, b, f"fold 1K K={K}")
            for a, b in zip(fold_weights(*f_args), fold_weights_plain(*f_args))))
    # the headline scene seen by the pose batch's 8 cameras (K = 20, rays)
    g_b, _, colors_b = head["scene"]
    Rb, Tb = vt.look_at_view_transform(dist=[6.0] * POSE_B, elev=list(np.linspace(5, 25, POSE_B)),
                                       azim=list(np.linspace(50, 90, POSE_B)), device=dev)
    cams_b = (Rb, Tb, torch.tensor([[300.0, 300.0]] * POSE_B, device=dev),
              torch.tensor([[128.0, 128.0]] * POSE_B, device=dev))
    rays_b, origins_b = camera_rays(*cams_b, POSE_HW)
    points_b = g_b.verts.detach()[None] - origins_b[:, None, :]
    isig_b = 2.0 * expend_sigma(g_b.sigmas.detach())[None].expand(POSE_B, -1, 3, 3)
    c = fine.compact_candidates(*cams_b, points_b, isig_b, POSE_HW, 0.01, 20)
    attrs_b = colors_b.repeat(POSE_B, 1).contiguous()
    sel = fine_select(rays_b, fine.candidate_table(points_b, isig_b, c.pos_c), c.bits_c, c.ids_c,
                      c.counts_c, c.thr_act, 20, c.bin_size, 1.0, attrs_b)
    g_cot = [seeded(sel[1].shape, dev, 110 + q) for q in range(4)]
    for with_attrs in (False, True):
        hold_k3(f"pose batch B={POSE_B} attrs={with_attrs}", "fine_bwd",
                (rays_b, fine.feature_table(points_b, isig_b), *sel[:5], *g_cot, 1.0,
                 attrs_b if with_attrs else None,
                 seeded(rays_b.shape, dev, 114) if with_attrs else None, True))
    head["pose_ids"] = (sel[0], rays_b.shape[0] * head["P"])
    print(f"K3 / fold at K = 5, 40, 80, 128 on the 1K scene and at B = {POSE_B} on the headline "
          f"scene: max_err/max|plain| K3 {err['fine_bwd']:.3e} fold {err['fold_weights']:.3e}; "
          "two runs equal to the bit")
    del sel, g_cot

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

    cull_sf = cull_stats(rays_sf, table_sf, thr_act, bs_sf)
    print(f"K2 global shapefit cull: {cull_sf['culled']} of {cull_sf['block_pairs']} (block, "
          f"Gaussian) pairs culled ({cull_sf['culled_share']:.4f}) over {cull_sf['blocks']} "
          f"blocks; {cull_sf['tested_pairs']} (ray, Gaussian) pairs left to test, "
          f"{cull_sf['passing_pairs']} pass; glue kernels vs plain {cull_sf['glue_err']}")
    print_two_level("shapefit", cull_sf["two_level"])
    details["cull_shapefit"] = cull_sf
    g_sf = [seeded(sel_sf[1].shape, dev, 50 + q) for q in range(4)]
    # (g_len, g_act, g_dsd, g_w): all set, g_w zero, and the trainer's own
    # configuration (only g_w: the loss reads the weights alone)
    zero_gw = {}
    for kind, cots in (("all", g_sf), ("zero g_w", g_sf[:3] + [torch.zeros_like(g_sf[3])]),
                       ("no g_w", g_sf[:3] + [None]), ("only g_w", [None, None, None, g_sf[3]])):
        for want_rays in (False, True):
            out = hold_k3(f"global shapefit {kind} rays={want_rays}", "fine_bwd_global",
                          (rays_sf, table_sf, *sel_sf, *cots, 1.0, want_rays))
            if kind == "zero g_w":
                zero_gw[want_rays] = out
            elif kind == "no g_w":   # the fold skipped: the same bits as a zero g_w
                need(all(a is None and b is None or torch.equal(a, b)
                         for a, b in zip(out, zero_gw[want_rays])),
                     "K3 global shapefit: the skipped fold differs from a zero g_w")
    head["k3g"] = (rays_sf, table_sf, *sel_sf, None, None, None, g_sf[3], 1.0, False)
    print(f"K3 global shapefit: max_err/max|plain| {err['fine_bwd_global']:.3e}; two runs equal "
          "to the bit; the skipped fold (no g_w) equal to the bit to a zero g_w")
    torch.cuda.synchronize()

    # 2c. the two halves of K4b alone and K2's compacted entry at the texture
    # shapes, and K2's per-bin-list entry on the headline's lists
    verts_tx, isig_tx, cams_tx, image_tx = texture_scene(dev)
    N_tx = verts_tx.shape[0]
    ctx_tx = vt.precompute_camera_ctx(*cams_tx, TEX_HW, N_tx, max_assign=TEX_K)
    frag_tx = vt.render_pipeline(verts_tx, isig_tx, *cams_tx, image_size=TEX_HW,
                                 max_assign=TEX_K, cam_ctx=ctx_tx)
    idx_tx, w_tx = frag_tx.vert_index, frag_tx.vert_weight
    aug_tx = torch.cat([image_tx, torch.ones_like(image_tx[..., :1])], dim=-1).contiguous()
    head["scatter"] = (idx_tx, w_tx, aug_tx, N_tx)
    e = grad_err(attr_scatter(*head["scatter"]), attr_scatter_plain(*head["scatter"]),
                 "attr_scatter texture")
    err["attr_scatter"] = e
    g_aug = seeded((N_tx, 4), dev, 60)
    head["dw"] = (idx_tx, g_aug, aug_tx)
    err["attr_dw"] = grad_err(attr_dw(*head["dw"]), attr_dw_plain(*head["dw"]), "attr_dw texture")
    print(f"attr_scatter / attr_dw texture: {idx_tx.numel()} slots, {int((idx_tx >= 0).sum())} "
          f"valid on {int((attr_scatter(*head['scatter'])[:, -1] > 0).sum())} of {N_tx} Gaussians, "
          f"max_err/max|plain| {err['attr_scatter']:.3e} / {err['attr_dw']:.3e}")
    for d in (8, 11):   # wider rows: one and two channel passes of the scatter
        g_d = seeded(idx_tx.shape[:3] + (d,), dev, 61)
        a_d = seeded((N_tx, d), dev, 62)
        err["attr_scatter"] = max(err["attr_scatter"], grad_err(
            attr_scatter(idx_tx, w_tx, g_d, N_tx), attr_scatter_plain(idx_tx, w_tx, g_d, N_tx),
            f"attr_scatter d={d}"))
        err["attr_dw"] = max(err["attr_dw"], grad_err(
            attr_dw(idx_tx, a_d, g_d), attr_dw_plain(idx_tx, a_d, g_d), f"attr_dw d={d}"))

    # K3f and attr_dw at their edge shapes and at both main shapes: against
    # their plain versions and two runs to the bit
    for d in EDGE_D:
        for K in EDGE_K:
            for n_pix in EDGE_PIX:
                e_m, e_d = hold_attr_pair(f"edge d={d} K={K} pixels={n_pix}",
                                          *edge_slots(dev, n_pix, K, d, 300, 70 + d + K + n_pix))
                err["attr_merge"], err["attr_dw"] = (max(err["attr_merge"], e_m),
                                                     max(err["attr_dw"], e_d))
    idx_h, w_h, colors_h = head["k3"]
    g_h = head["k4b"][3]
    for tag, args in (("headline", (idx_h, w_h, colors_h, g_h)),
                      ("texture", (idx_tx, w_tx, g_aug, aug_tx))):
        e_m, e_d = hold_attr_pair(tag, *args)
        err["attr_merge"], err["attr_dw"] = max(err["attr_merge"], e_m), max(err["attr_dw"], e_d)
    print(f"K3f / attr_dw at d {EDGE_D} x K {EDGE_K} x pixels {EDGE_PIX} (ids of -1 and beyond "
          f"the table), the headline and the texture shapes: max_err {err['attr_merge']:.3e} / "
          f"max_err/max|plain| {err['attr_dw']:.3e}; two runs equal")
    head["attr_shapes"] = {
        "headline": ((idx_h, w_h, colors_h), (idx_h, colors_h, g_h), (idx_h, w_h, colors_h, g_h)),
        "texture": ((idx_tx, w_tx, g_aug), head["dw"], (idx_tx, w_tx, g_aug, aug_tx)),
    }

    # K2's compacted entry on the texture render's own inputs: K = 80,
    # 44 supertiles of 64 x 64 rays
    rays_tx, origins_tx = camera_rays(*cams_tx, TEX_HW)
    points_tx = verts_tx[None] - origins_tx[:, None, :]
    isg_tx = 2.0 * expend_sigma(isig_tx)[None]
    c_tx = fine.compact_candidates(*cams_tx, points_tx, isg_tx, TEX_HW, 0.01, TEX_K)
    need(int(c_tx.overflow_c.sum()) == 0, "texture coarse stage overflow")
    tab_tx = fine.candidate_table(points_tx, isg_tx, c_tx.pos_c)
    colors_tx = torch.rand((N_tx, 3), device=dev, generator=torch.Generator(dev).manual_seed(65))
    for attrs in (None, colors_tx):
        args = (rays_tx, tab_tx, c_tx.bits_c, c_tx.ids_c, c_tx.counts_c, c_tx.thr_act, TEX_K,
                c_tx.bin_size, 1.0, attrs)
        got, want = fine_select(*args), fine_select_plain(*args)
        need(torch.equal(got[0], want[0]), f"K2 texture attrs={attrs is not None}: selections differ")
        _, e = compare_select(got, want)
        err["fine_select"] = max(err["fine_select"], e)
        print(f"K2 texture: K={TEX_K} attrs={attrs is not None} supertiles={tab_tx.shape[0]} "
              f"M={tab_tx.shape[1]} densest row {int(c_tx.counts_c.max())} selections equal, "
              f"most per ray {int((got[0] >= 0).sum(-1).max())}, max_err(w,img)={e:.3e}")
        if attrs is None:
            need(torch.equal(got[0], idx_tx), "K2 texture: not the render's selections")
            head["k2tx"] = args

    g_h, cams_h, _ = head["scene"]
    rays_h, points_h, isig_h = stage_inputs(g_h, cams_h, (256, 256))
    bs_h, mppb_h = coarse.coarse_bin_config((256, 256), 20, head["P"])
    bp_h, cnt_h = vt.ops.rasterize_coarse(*cams_h, points_h, isig_h, (256, 256), 0.01, bs_h,
                                          mppb_h, return_counts=True)
    densest_h = int(cnt_h.max())
    if densest_h > mppb_h:      # raise the cap so that no bin truncates
        mppb_h = densest_h
        bp_h = vt.ops.rasterize_coarse(*cams_h, points_h, isig_h, (256, 256), 0.01, bs_h, mppb_h)
    table_h = fine.feature_table(points_h, isig_h)
    for K in (5, 20, 80):
        args = (rays_h, table_h, bp_h, thr_act, K, bs_h)
        got, want = fine_select_bins(*args), fine_select_bins_plain(*args)
        need(torch.equal(got[0], want[0]), f"K2 bins K={K}: selections differ")
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=LAD_TOL, atol=LAD_TOL)
            err["fine_select_bins"] = max(err["fine_select_bins"], (a - b).abs().max().item())
        if K == 20:
            head["k2b"] = args
    print(f"K2 bins headline: {bp_h.shape[1]}x{bp_h.shape[2]} bins of {bs_h} px, lists of "
          f"{bp_h.shape[3]} (densest bin {densest_h}, memberships {int(cnt_h.sum())}), "
          f"selections equal at K = 5, 20, 80, max_err(len, act, dsd)={err['fine_select_bins']:.3e}")
    # K3's global entry on the per-bin-list select's outputs (no weights: the
    # fold is skipped, and w is absent), and the same call with a zero w and
    # a zero g_w (a fold of G = 0): equal to the bit
    sel_bins = fine_select_bins(*head["k2b"])
    cots_b = [seeded(sel_bins[1].shape, dev, 120 + q) for q in range(3)]
    skipped = hold_k3("two-stage (no weights)", "fine_bwd_global",
                      (rays_h, table_h, *sel_bins, None, *cots_b, None, 1.0, True))
    zero = torch.zeros_like(sel_bins[1])
    need(all(torch.equal(a, b) for a, b in zip(
        skipped, fine_bwd_global(rays_h, table_h, *sel_bins, zero, *cots_b, zero, 1.0, True))),
        "K3 two-stage: the skipped fold differs from a zero g_w")
    print(f"K3 global two-stage (no weights): max_err/max|plain| {err['fine_bwd_global']:.3e}; the "
          "skipped fold equal to the bit to a zero w and g_w")
    torch.cuda.synchronize()


    # 2d. the two halves of the split global backward at the ShapeFitting
    # shapes and on the 300,000-point cloud; K2's global entry there
    def hold_halves(tag, rays, table, sel, cots):
        """Each half against its plain version, the fold's entry + the pair
        against the unified entry (the same kernels: equal to the bit where
        the per-Gaussian kernel takes 32 lanes at either; within PAIR_TOL
        elsewhere), two runs equal to the bit; the halves' inputs with only
        g_w set (what a render's loss gives them)."""
        idx, length, act, dsd, w = sel
        kept, pair, same = None, 0.0, True
        warp = group_width(idx.numel(), table.shape[0]) == 32
        for kind, (gl, ga, gd, gw) in (("all", cots), ("no g_w", (*cots[:3], None)),
                                       ("only g_w", (None, None, None, cots[3]))):
            u_rows, u_rays = fine_bwd_global(rays, table, *sel, gl, ga, gd, gw, 1.0, True)
            g3 = [gl, ga, gd]
            if gw is not None:
                folded = fold_weights(length, act, dsd, w, gw, 1.0)
                g3 = [d if g is None else g + d for g, d in zip(g3, folded)]
            kept = (rays, table, idx, length, dsd, *g3)
            rows, g_rays = fine_bwd_gauss(*kept), fine_bwd_rays(*kept)
            need(torch.equal(rows, fine_bwd_gauss(*kept)) and torch.equal(g_rays, fine_bwd_rays(*kept)),
                 f"split halves {tag} {kind}: two runs differ")
            err["fine_bwd_gauss"] = max(err["fine_bwd_gauss"], grad_err(
                rows, fine_bwd_gauss_plain(*kept), f"fine_bwd_gauss {tag} {kind}"))
            err["fine_bwd_rays"] = max(err["fine_bwd_rays"], grad_err(
                g_rays, fine_bwd_rays_plain(*kept), f"fine_bwd_rays {tag} {kind}"))
            e = max(rel_t(rows, u_rows), rel_t(g_rays, u_rays))
            need(e <= PAIR_TOL, f"fold + pair vs unified entry {tag} {kind}: {e:.3e}")
            equal = torch.equal(rows, u_rows) and torch.equal(g_rays, u_rays)
            need(equal or not warp, f"fold + pair vs unified entry {tag} {kind}: not equal "
                                    "to the bit at 32 lanes a Gaussian")
            pair, same = max(pair, e), same and equal
        ok = (idx >= 0) & (idx < table.shape[0])
        print(f"split halves {tag}: {int(ok.sum())} valid slots of {idx.numel()} on "
              f"{torch.unique(idx[ok]).numel()} of {table.shape[0]} Gaussians, "
              f"{group_width(idx.numel(), table.shape[0])} lanes a Gaussian; max_err/max|plain| "
              f"gauss {err['fine_bwd_gauss']:.3e} rays {err['fine_bwd_rays']:.3e}; fold + pair vs "
              f"the unified entry (normwise) {pair:.3e}, equal to the bit: {same}; two runs "
              "equal to the bit")
        return kept, pair

    def fold_then_pair(rays, table, idx, length, act, dsd, w, g_len, g_act, g_dsd, g_w,
                       agg_ow, want_rays=True):
        """The global backward as the fold's entry and the two halves, with
        the unified entry's arguments and results."""
        g3 = [g_len, g_act, g_dsd]
        if g_w is not None:
            g3 = [d if g is None else g + d
                  for g, d in zip(g3, fold_weights(length, act, dsd, w, g_w, agg_ow))]
        halves = (rays, table, idx, length, dsd, *g3)
        return fine_bwd_gauss(*halves), fine_bwd_rays(*halves) if want_rays else None

    _, pair_sf = hold_halves("shapefit", rays_sf, table_sf, sel_sf, g_sf)
    verts_c, isig_c, cams_c = cloud_scene(300_000, dev)
    P_c = verts_c.shape[0]
    rays_c, origins_c = camera_rays(*cams_c, CLOUD_HW)
    points_c = verts_c[None] - origins_c[:, None, :]
    isg_c = (2.0 * expend_sigma(isig_c))[None]
    table_cl = fine.feature_table(points_c, isg_c)
    bs_c, mppb_c = fine.production_bin_geometry(CLOUD_HW, CLOUD_K, P_c, None, -1)
    need(mppb_c == -1, "the 300K geometry has a coarse stage")
    head["k2c"] = (rays_c, table_cl, None, thr_act, CLOUD_K, bs_c, 1.0)
    sel_c = fine_select_global(*head["k2c"])
    y0 = x0 = 160   # a 32x32 window of the rays against all 300,000 Gaussians
    crop = rays_c[:, y0:y0 + 32, x0:x0 + 32].contiguous()
    got = fine_select_global(crop, table_cl, None, thr_act, CLOUD_K, bs_c, 1.0)
    need(all(torch.equal(a, b[:, y0:y0 + 32, x0:x0 + 32]) for a, b in zip(got, sel_c)),
         "K2 global 300K: the crop's selections are not the whole image's")
    # the plain version in 8x8 tiles (its dense arrays are rays x Gaussians);
    # with every Gaussian a member everywhere the tiling changes no result
    want = fine_select_global_plain(crop, table_cl, None, thr_act, CLOUD_K, 4, 1.0)
    need(torch.equal(got[0], want[0]), "K2 global 300K crop: selections differ from the plain version")
    _, e = compare_select(got, want)
    err["fine_select_global"] = max(err["fine_select_global"], e)
    sel_r, ovf_c = fine.ray_tracing(cams_c, points_c, isg_c, rays_c, CLOUD_HW, 0.01, CLOUD_K)
    need(int(ovf_c) == 0, "300K coarse path overflow")
    agree = (sel_r[0] == sel_c[0]).all(-1)
    flips_c = 1.0 - agree.float().mean().item()
    need(flips_c < FLIP_MAX, f"K2 global 300K vs the coarse path: {flips_c} of the pixels differ")
    for a, b in zip(sel_c[1:4], sel_r[1:4]):
        torch.testing.assert_close(a[agree], b[agree], rtol=LAD_TOL, atol=LAD_TOL)
    print(f"K2 global 300K: P={P_c} bs={bs_c} valid slots {int((sel_c[0] >= 0).sum())} of "
          f"{sel_c[0].numel()}; 32x32 crop equal to the plain version (max_err(w)={e:.3e}); "
          f"vs the coarse path (K1, sort, K2 compacted; overflow 0) flips={flips_c:.2e}")
    need(all(torch.equal(a, b) for a, b in zip(sel_c, fine_select_global(*head["k2c"]))),
         "K2 global 300K: two runs differ")
    # the whole image, which the dense plain version cannot reach: the same
    # kernel walking every Gaussian (no cull) gives the same bits
    need(all(torch.equal(a, b)
             for a, b in zip(sel_c, fine_select_global(*head["k2c"], _cull=False))),
         "K2 global 300K: the cull changed a result")
    cull_c = cull_stats(rays_c, table_cl, thr_act, bs_c)
    print(f"K2 global 300K cull: {cull_c['culled']} of {cull_c['block_pairs']} (block, Gaussian) "
          f"pairs culled ({cull_c['culled_share']:.5f}) over {cull_c['blocks']} blocks; "
          f"{cull_c['tested_pairs']} (ray, Gaussian) pairs left to test of "
          f"{rays_c.numel() // 3 * P_c}, {cull_c['passing_pairs']} pass; the whole image equal to "
          f"the bit with the cull off")
    print_two_level("300K", cull_c["two_level"])
    details["cull_300k"] = cull_c
    # the benchmark cell's four cameras over the 300K cloud: the two-level
    # route (as the rule picks it there), equal to the bit with the cull off
    R4, T4 = vt.look_at_view_transform(dist=[4.0] * 4, elev=[10.0, 16.7, 23.3, 30.0],
                                       azim=[20.0, 30.0, 40.0, 50.0], device=dev)
    cams4 = (R4, T4, cams_c[2].expand(4, 2), cams_c[3].expand(4, 2))
    rays4, origins4 = camera_rays(*cams4, CLOUD_HW)
    table4 = fine.feature_table(verts_c[None] - origins4[:, None, :], isg_c.expand(4, -1, 3, 3))
    args4 = (rays4, table4, None, thr_act, CLOUD_K, bs_c, 1.0)
    with trace.tracing():
        sel4 = fine_select_global(*args4)
        lists = launched("cull_lists")
    need(lists == 1, "K2 global 300K B=4: the two-level route did not run")
    need(all(torch.equal(a, b) for a, b in zip(sel4, fine_select_global(*args4, _cull=False))),
         "K2 global 300K B=4: the two-level cull changed a result")
    print(f"K2 global 300K B=4 (the cell's cameras): two-level route, valid slots "
          f"{int((sel4[0] >= 0).sum())}; the whole images equal to the bit with the cull off")
    del sel4, table4, rays4
    g_c = [seeded(sel_c[1].shape, dev, 90 + q) for q in range(4)]
    head["halves"], pair_c = hold_halves("cloud 300K", rays_c, table_cl, sel_c, g_c)
    head["k3c"] = (rays_c, table_cl, *sel_c, None, None, None, g_c[3], 1.0, True)
    details["split_pair_vs_unified"] = dict(shapefit=pair_sf, cloud_300k=pair_c)
    details["cloud_300k"] = dict(flips_vs_coarse=flips_c, valid_slots=int((sel_c[0] >= 0).sum()))
    del want, got, sel_r
    torch.cuda.synchronize()

    # 2e. the grouping of slots by id (rows 10 and 11, K3) against its plain
    # version, torch.sort + searchsorted: starts and the valid prefix of order
    # equal to the bit, on the slot ids of every main path and on edge cases
    passes = _build.load("slot_runs").voge_slot_runs_passes
    passes.argtypes, passes.restype = [ctypes.c_longlong], ctypes.c_int

    def hold_runs(tag, idx, n_rows):
        order, starts = slot_runs(idx, n_rows)
        p_order, p_starts = slot_runs_plain(idx, n_rows)
        again = slot_runs(idx, n_rows)
        v = int(p_starts[-1])
        need(torch.equal(starts, p_starts) and torch.equal(order[:v], p_order[:v]),
             f"slot_runs {tag}: not the plain version's grouping")
        need(torch.equal(again[1], starts) and torch.equal(again[0][:v], order[:v]),
             f"slot_runs {tag}: two runs differ")
        return dict(slots=idx.numel(), valid=v, n_rows=n_rows, passes=passes(n_rows))

    runs_ids = {"headline": (head["k3"][0], head["P"]),
                "shapefit": (sel_sf[0], table_sf.shape[0]),
                "texture": (idx_tx, N_tx),
                "two_stage": (sel_bins[0], table_h.shape[0]),
                "pose_b8": head["pose_ids"],
                "cloud_300k": (sel_c[0], P_c)}
    gen = torch.Generator(dev).manual_seed(70)
    rand_ids = lambda n, hi: torch.randint(-(hi // 3) - 1, hi + 3, (n,), dtype=torch.int32,
                                           device=dev, generator=gen).clamp(min=-1)
    edge = {"all_empty": (torch.full((1 << 20,), -1, dtype=torch.int32, device=dev), 1000),
            "one_id": (torch.full((1 << 20,), 5, dtype=torch.int32, device=dev), 10),
            **{f"n_rows={n}": (rand_ids(1 << 20, n), n) for n in (1, 256, 257, 65536, 65537)}}
    grouping = {}
    for tag, (ids, n_rows) in {**runs_ids, **edge}.items():
        grouping[tag] = hold_runs(tag, ids, n_rows)
        if tag in runs_ids:
            grouping[tag].update(ms=cuda_ms(lambda: slot_runs(ids, n_rows), 20),
                                 plain_ms=cuda_ms(lambda: slot_runs_plain(ids, n_rows), 20))
        print(f"slot_runs {tag}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else
                                               f"{k} {v}" for k, v in grouping[tag].items()))
    print("slot_runs on every main path's ids and the edge cases: starts and order equal to the "
          "plain version's bit for bit; two runs equal")
    details["slot_runs"] = grouping    # integers, held equal: err["slot_runs"] stays 0
    torch.cuda.synchronize()

    # 2f. the coarse stage (K1, the grouping, the globals and rows kernels) at
    # every main path's shapes: each kernel against its plain version and the
    # whole stage against the int64 route, bit for bit
    verts_p, isig_p, cams_p = cloud_scene(100_000, dev)
    P_p = verts_p.shape[0]
    _, origins_p = camera_rays(*cams_p, CLOUD_HW)
    points_p = verts_p[None] - origins_p[:, None, :]
    isg_p = (2.0 * expend_sigma(isig_p))[None]
    g_q, cams_q, _ = scene(1000, (256, 256), 300.0, dev)
    _, points_q, isig_q = stage_inputs(g_q, cams_q, (256, 256))
    coarse_cells = {"headline": (cams_h, points_h, isig_h, (256, 256), 20),
                    "quickstart": (cams_q, points_q, isig_q, (256, 256), 20),
                    "texture": (cams_tx, points_tx, isg_tx, TEX_HW, TEX_K),
                    "cloud_100k": (cams_p, points_p, isg_p, CLOUD_HW, CLOUD_K),
                    "pose_b8": (cams_b, points_b, isig_b, POSE_HW, 20)}

    def hold_coarse(tag, cams, points, isig, hw, K):
        """The stage through ``compact_candidates`` (and with the inverse
        map) against the int64 route; then each kernel against its plain
        version at every window the render emitted with, the rows at the
        render's width."""
        B, P = points.shape[:2]
        c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
        with sorted_route():
            ref = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
        need(all(torch.equal(a, b) for a, b in zip(c[:5], ref[:5])),
             f"coarse stage {tag}: not the int64 route's rows")
        need(int(c.overflow_c.sum()) == 0, f"coarse stage {tag}: overflow")
        bs = c.bin_size
        kw = dict(row_align=fine._pick_cand_chunk(P), return_dst=True)
        d_new = coarse.emit_supertile_candidates(*cams, points, isig, hw, 0.01, bs, 0, **kw)
        with sorted_route():
            d_ref = coarse.emit_supertile_candidates(*cams, points, isig, hw, 0.01, bs, 0, **kw)
        need(all(torch.equal(a, b) for a, b in zip(d_new[:5], c[:5]))
             and all(torch.equal(a, b) for a, b in zip(d_new[5], d_ref[5])),
             f"coarse stage {tag}: the inverse map is not the int64 route's")
        nst, BH2, BW2, S, win0 = coarse.emission_geometry(P, hw, bs)
        win = math.isqrt(d_new[5][0].shape[-1])
        M = c.pos_c.shape[1]
        for w in sorted({win0, win}):
            k1 = (*cams, points, isig, 0.01, bs, hw, nst, BH2, BW2, w)
            em = emit_rows(*k1)
            need(all(torch.equal(a, b) for a, b in zip(em, emit_rows_plain(*k1))),
                 f"K1 {tag} win {w}: kernel and plain differ")
            rid, bits, planes, over, info = em
            order, starts = slot_runs(rid, B * nst)
            info_p = info.clone()
            g_args = (over, planes, starts, info, min(64, P), nst, BW2, bs, hw)
            glob = coarse_globals(*g_args)
            want = coarse_globals_plain(*g_args[:3], info_p, *g_args[4:])
            need(all(torch.equal(a, b) for a, b in zip(glob, want)) and torch.equal(info, info_p),
                 f"coarse_globals {tag} win {w}: kernel and plain differ")
            r_args = (order, starts, bits, glob[0], glob[2], glob[3], M, nst)
            for with_dst in (False, True):
                rows = coarse_rows(*r_args, with_dst)
                need(all(torch.equal(a, b)
                         for a, b in zip(rows, coarse_rows_plain(*r_args, with_dst))),
                     f"coarse_rows {tag} win {w} dst={with_dst}: kernel and plain differ")
        need(all(torch.equal(a, b) for a, b in zip(rows[:5], c[:5])),
             f"coarse_rows {tag}: not the stage's rows")
        densest, dropped, wider = info.tolist()
        # bounds on this cell's inputs (the render's final emission): bytes of
        # each input read once and each output written once, operations as
        # counted at the top; the stage reads the Gaussians and cameras and
        # writes the rows and counts
        n_valid, n_glob = int(starts[-1]), int(glob[1].sum())
        in_bytes = nbytes(points, isig) + B * 13 * 4
        emit_ops = B * P * (EMIT_FLOPS + 10 * win + 10 * win * win)
        glob_ops = n_glob * nst * GLOBAL_FLOPS
        bounds = dict(
            emit_rows=bound_ms(in_bytes + nbytes(*em), emit_ops),
            coarse_globals=bound_ms(nbytes(over, starts, info, *glob) + 16 * n_glob, glob_ops),
            coarse_rows=bound_ms(5 * n_valid + nbytes(starts, *glob, *rows[:5]), 0.0),
            stage=bound_ms(in_bytes + nbytes(*c[:5]), emit_ops + glob_ops))
        # the int64 keys the route sorts (local cells, then global members)
        idx = torch.arange(P, device=dev)[:, None]
        big = B * nst * S * 16
        gpos, g_valid, bits_g, _ = glob
        kg = ((torch.arange(B * nst, device=dev).reshape(B, 1, nst) * S + gpos.long()[..., None])
              * 16 + bits_g.long())
        keys = torch.cat([torch.where(rid >= 0, (rid.long() * S + idx) * 16 + bits.long(),
                                      big).reshape(-1),
                          torch.where((bits_g != 0) & g_valid[..., None], kg, big).reshape(-1)])
        out = dict(B=B, P=P, bin_size=bs, windows=sorted({win0, win}), rows=B * nst, width=M,
                   densest=densest, memberships=int(c.counts_c.sum()),
                   globals=int(g_valid.sum()), dropped_first=win != win0,
                   stage_bound_ms=bounds["stage"][0], stage_bound_by=bounds["stage"][1])
        print(f"coarse stage {tag}: " + ", ".join(f"{k} {v}" for k, v in out.items())
              + "; K1, the globals and rows kernels equal to their plain versions, the rows "
              "and the inverse map equal to the int64 route's, bit for bit")
        edges = torch.arange(B * nst + 1, device=dev) * (S * 16)
        need(torch.equal(torch.searchsorted(torch.sort(keys)[0], edges).diff(),
                         c.counts_c.long()), f"coarse stage {tag}: the int64 keys' runs")
        out.update(k1=k1, glob=g_args, rows_args=r_args, c=c, keys=keys, edges=edges,
                   bounds=bounds)
        return out

    coarse_held = {tag: hold_coarse(tag, *cell) for tag, cell in coarse_cells.items()}
    need(coarse_held["texture"]["dropped_first"]
         and not any(v["dropped_first"] for k, v in coarse_held.items() if k != "texture"),
         "the texture scene alone re-emits")
    head["coarse"] = coarse_held["headline"]
    details["coarse_stage"] = {tag: {k: v for k, v in h.items()
                                     if k not in ("k1", "glob", "rows_args", "c", "keys", "edges",
                                                  "bounds")}
                               for tag, h in coarse_held.items()}
    torch.cuda.synchronize()

    # ---- 3. the main paths --------------------------------------------
    from voge_tpu_torch.ops import dense_select
    dense_select.calls = 0     # no render at K <= 128 takes the dense route
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
    # camera kwargs as the reference demos pass them: arrays off the card
    frag_np = renderer(g, R=R.cpu().numpy().astype(np.float64), T=T.cpu().numpy())
    need(frag_np.vert_index.is_cuda and torch.equal(frag_np.vert_index, frag2.vert_index)
         and torch.equal(frag_np.vert_weight, frag2.vert_weight),
         "GaussianRenderer with numpy R, T differs from the call with card tensors")
    add(read_counts("forward", (*COARSE, "fine_select", "attr_merge")))
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
    add(read_counts("fitting step", (*COARSE, "fine_select", "fine_bwd")))
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
    # the closest to its gate: the golden file's own float32 chain rule (9.0e-4
    # with K3's per-row sums gathered back; ROADMAP section 3)
    print(f"headline sigma gradient vs its golden file: {gold_err['headline']['sigmas']:.4e} "
          f"(gate {GOLD_GRAD_TOL:.0e})")

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
    add(read_counts("white background", (*COARSE, "fine_select", "fine_bwd",
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
    no_coarse = ("fine_select_global", "fine_bwd_global", "attr_merge", "attr_merge_bwd",
                 "slot_runs")

    def compacted_unused(counts, path):
        need(all(counts[k] == 0 for k in (*COARSE_KERNELS, "fine_select", "fine_bwd")),
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

    # 3e. texture extraction at full width (slice 4)
    gold = np.load(GOLDEN_TEX)
    zero_counts()
    with no_plain_version():
        frag_t, wsum_t, tex_t, img_t = texture_chain(verts_tx, isig_tx, cams_tx, image_tx, ctx_tx)
    counts = read_counts("texture extraction",
                         (*COARSE, "fine_select", "attr_scatter", "attr_merge"))
    add(counts)
    need(vt.get_overflow_points(frag_t) == 0, "texture overflow_points != 0")
    need(img_t.shape == (1,) + TEX_HW + (3,) and bool(torch.isfinite(img_t).all())
         and bool(torch.isfinite(tex_t).all()), "texture image / texture not finite")
    same = (frag_t.valid_num[0].cpu().numpy() == gold["valid_num"])
    stride = TEX_HW[0] // gold["image"].shape[0]
    e = {"valid_num_flips": float(1.0 - same.mean()),
         "wsum": float(np.abs(wsum_t.cpu().numpy() - gold["wsum"]).max() / gold["wsum"].max()),
         "texture": float(np.abs(tex_t.cpu().numpy() - gold["texture"]).max()),
         "image": float(np.abs(img_t[0, ::stride, ::stride].cpu().numpy()
                               - gold["image"])[same[::stride, ::stride]].max(initial=0.0)),
         "weight_sum": float(np.abs(
             frag_t.vert_weight.sum(-1)[0, ::stride, ::stride].cpu().numpy()
             - gold["weight_sum"])[same[::stride, ::stride]].max(initial=0.0))}
    need(e["valid_num_flips"] < FLIP_MAX, f"texture selections: {e['valid_num_flips']} flipped")
    for k in ("wsum", "texture", "image", "weight_sum"):
        need(e[k] <= W_TOL, f"texture {k} vs voge_tpu golden: {e[k]:.3e}")
    valid_t = int((frag_t.vert_index >= 0).sum())
    print(f"texture extraction vs voge_tpu golden: N={N_tx} {TEX_HW[0]}x{TEX_HW[1]} K={TEX_K} "
          f"overflow 0, valid slots {valid_t} (golden {int(gold['valid_num'].sum())}), "
          f"most per pixel {int(frag_t.valid_num.max())}, "
          + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
    details["golden_texture"] = dict(e, valid_slots=valid_t)

    # one backward through the sampler alone: weights and image as leaves
    cf, cw = seeded((N_tx, 3), dev, 63), seeded((N_tx,), dev, 64)

    def sampler_grads():
        w = frag_t.vert_weight.detach().clone().requires_grad_(True)
        img = image_tx.clone().requires_grad_(True)
        fr = vt.Fragments(w, frag_t.vert_index, frag_t.valid_num, frag_t.vert_hit_length)
        feat, wsum = vt.sample_features(fr, img, n_vert=N_tx)
        loss = (feat * cf).sum() + (wsum * cw).sum()
        first = torch.autograd.grad(loss, (w, img), retain_graph=True)
        return first, torch.autograd.grad(loss, (w, img))

    zero_counts()
    with no_plain_version():
        sg, sg2 = sampler_grads()
    add(read_counts("sampler backward", ("attr_scatter", "attr_dw", "attr_merge", "slot_runs")))
    with plain_path():
        sp, _ = sampler_grads()
    samp_err = {}
    for name, a, b, c in zip(("weights", "image"), sg, sg2, sp):
        need(torch.equal(a, b), f"sampler {name} gradient differs between two backward runs")
        samp_err[name] = grad_err(a, c, f"sampler grad {name}")
    print(f"sampler backward, kernel vs plain path: {samp_err}, two runs equal to the bit")
    details["sampler_grad_err"] = samp_err

    # 3f. the two-stage tracer at full width on the headline scene (slice 4)
    mus_h, isg_h = points_h.reshape(-1, 3), isig_h.reshape(-1, 3, 3)
    cots_h = [seeded(rays_h.shape[:3] + (20,), dev, 80 + q) for q in range(3)]

    def two_stage(points, want_grads=True):
        """``rasterize_coarse`` -> ``ray_tracing_fine`` -> a seeded linear
        loss on (len, act, dsd) -> gradients of mus, isigmas and rays."""
        bp = vt.ops.rasterize_coarse(*cams_h, points, isig_h, (256, 256), 0.01, bs_h, mppb_h)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (points.reshape(-1, 3), isg_h, rays_h)]
        sel = vt.ops.ray_tracing_fine(*leaves, bp, 0.01, bs_h, 20)
        if not want_grads:
            return sel, None
        v = sel[1] * cots_h[0] + sel[2] * cots_h[1] + sel[3] * cots_h[2]
        loss = torch.where(sel[0] >= 0, v, torch.zeros_like(v)).sum()
        return sel, torch.autograd.grad(loss, leaves)

    zero_counts()
    with no_plain_version():
        sel_2, gr_2 = two_stage(points_h)
        _, gr_2b = two_stage(points_h)
    counts = read_counts("two-stage tracer", ("fine_select_bins", "fine_bwd_global", "slot_runs"))
    need(all(counts[k] == 0 for k in (*COARSE_KERNELS, "fine_select", "fine_select_global")),
         "two-stage tracer: another path's select ran")
    add(counts)
    need(int(cnt_h.max()) <= mppb_h, "two-stage tracer: a bin was truncated")
    sel_r, ovf_r = fine.ray_tracing(cams_h, points_h, isig_h, rays_h, (256, 256), 0.01, 20)
    need(int(ovf_r) == 0, "headline render overflow")
    agree = (sel_2[0] == sel_r[0]).all(-1)
    flips = 1.0 - agree.float().mean().item()
    need(flips < FLIP_MAX, f"two-stage vs render path: {flips} of the pixels differ")
    for a, b in zip(sel_2[1:], sel_r[1:4]):
        torch.testing.assert_close(a[agree], b[agree], rtol=LAD_TOL, atol=LAD_TOL)
    with plain_path():
        sel_p, gr_p = two_stage(points_h)
    need(torch.equal(sel_2[0], sel_p[0]), "two-stage: kernel and plain selections differ")
    two_err = {}
    for name, a, b, c in zip(("mus", "isigmas", "rays"), gr_2, gr_2b, gr_p):
        need(bool(torch.isfinite(a).all()), f"two-stage: non-finite {name} gradient")
        need(torch.equal(a, b), f"two-stage {name} gradient differs between two backward runs")
        two_err[name] = grad_err(a, c, f"two-stage grad {name}")
    print(f"two-stage tracer headline: lists of {mppb_h}, densest bin {densest_h}, no bin "
          f"truncated; vs the render path flips={flips:.2e}; fwd+bwd kernel vs plain path "
          f"{two_err}, two runs equal to the bit")
    details["two_stage"] = dict(flips=flips, grad_err=two_err, densest_bin=densest_h,
                                list_length=mppb_h)


    # 3g. the published-size point-cloud forward (slice 5): 100,000 points
    ctx_p = vt.precompute_camera_ctx(*cams_p, CLOUD_HW, P_p, max_assign=CLOUD_K)

    def cloud_forward(v):
        return vt.render_pipeline(v, isig_p, *cams_p, image_size=CLOUD_HW, max_assign=CLOUD_K,
                                  cam_ctx=ctx_p)

    zero_counts()
    with no_plain_version():
        frag_p = cloud_forward(verts_p)
    counts = read_counts("point cloud 100K forward", (*COARSE, "fine_select"))
    need(counts["fine_select_global"] == 0, "point cloud forward: the global select ran")
    add(counts)
    need(vt.get_overflow_points(frag_p) == 0, "point cloud 100K overflow_points != 0")
    need(frag_p.vert_weight.shape == (1,) + CLOUD_HW + (CLOUD_K,)
         and bool(torch.isfinite(frag_p.vert_weight).all()), "point cloud 100K weights")
    need(torch.equal(ctx_p.origins, origins_p), "point cloud 100K: the camera context's origins")
    bs_p, _ = fine.production_bin_geometry(CLOUD_HW, CLOUD_K, P_p, None, None)
    sel_g = fine_select_global(ctx_p.rays, fine.feature_table(points_p, isg_p), None, thr_act,
                               CLOUD_K, bs_p, 1.0)
    agree = (frag_p.vert_index == sel_g[0]).all(-1)
    flips_p = 1.0 - agree.float().mean().item()
    need(flips_p < FLIP_MAX, f"point cloud 100K vs the global select: {flips_p} flipped")
    e = (frag_p.vert_weight[agree] - sel_g[4][agree]).abs().max().item()
    need(e <= W_TOL, f"point cloud 100K weights vs the global select: {e}")
    c_p = fine.compact_candidates(*cams_p, points_p, isg_p, CLOUD_HW, 0.01, CLOUD_K)
    print(f"point cloud 100K forward: overflow 0, valid px "
          f"{(frag_p.valid_num > 0).float().mean().item():.4f}, valid slots "
          f"{int((frag_p.vert_index >= 0).sum())}, rows of {c_p.pos_c.shape[1]} in "
          f"{c_p.pos_c.shape[0]} supertiles (densest {int(c_p.counts_c.max())}, memberships "
          f"{int(c_p.counts_c.sum())}); the coarse stage exact (2f); vs K2 global flips={flips_p:.2e} "
          f"max_err(w)={e:.3e}")
    details["cloud_100k"] = dict(flips_vs_global=flips_p, weight_err=e,
                                 row_width=c_p.pos_c.shape[1], densest=int(c_p.counts_c.max()),
                                 memberships=int(c_p.counts_c.sum()))
    del sel_g, c_p

    # 3h. the 300,000-point step (slice 5): past voge_tpu's branch point,
    # K3's unified entry (the card has no VMEM limit; PERF.md section 6)
    colors_c = ((verts_c + 1) / 2).contiguous()
    # (the colours are constants, so the merge's backward is its d_w half alone)
    zero_counts()
    with no_plain_version():
        frag_c, loss_c, leaves_c = cloud_step(verts_c, isig_c, cams_c, colors_c)
        gr = torch.autograd.grad(loss_c, leaves_c, retain_graph=True)
        gr2 = torch.autograd.grad(loss_c, leaves_c)
    counts = read_counts("point cloud 300K step", ("fine_select_global", "attr_merge", "attr_dw",
                                                   "fine_bwd_global", "slot_runs"))
    need(all(counts[k] == 0 for k in ("fold_weights", "fine_bwd_gauss", "fine_bwd_rays")),
         "300K step: the split backward ran")
    compacted_unused(counts, "point cloud 300K step")
    add(counts)
    need(vt.get_overflow_points(frag_c) == 0, "300K step overflow_points != 0")
    need(torch.equal(frag_c.vert_index, sel_c[0]), "300K step: not the selections held above")
    unified = fine.fine_bwd_global
    fine.fine_bwd_global = fold_then_pair       # the same step on the split backward
    try:
        with trace.tracing():
            _, loss_u, leaves_u = cloud_step(verts_c, isig_c, cams_c, colors_c)
            gu = torch.autograd.grad(loss_u, leaves_u)
        need(launched("fine_bwd_gauss") == 1, "the split pair did not run")
    finally:
        fine.fine_bwd_global = unified
    cloud_err = {}
    for name, a, b, c in zip(("verts", "sigmas", "R", "T"), gr, gr2, gu):
        need(bool(torch.isfinite(a).all()), f"300K step: non-finite {name} gradient")
        need(torch.equal(a, b), f"300K step: {name} gradient differs between two backward runs")
        cloud_err[name] = rel_t(a, c)
        need(cloud_err[name] <= PAIR_TOL, f"300K step grad {name} vs the fold + pair "
                                          f"{cloud_err[name]:.3e}")
    same = all(torch.equal(a, c) for a, c in zip(gr, gu))
    print(f"point cloud 300K step: loss {loss_c.item():.8f}, gradients on "
          f"{int((gr[0].abs().sum(-1) > 0).sum())} of {P_c} Gaussians, vs the fold + pair "
          f"(normwise) {cloud_err}, equal to the bit: {same}; two runs equal to the bit")
    details["cloud_300k"].update(loss=loss_c.item(), grad_vs_fold_pair=cloud_err,
                                 equal_to_fold_pair=same)

    # 3i. a frozen scene on the same cloud: only the cameras need a gradient
    cw_c = seeded(sel_c[4].shape, dev, 95)

    def frozen_step(frozen):
        Rl, Tl = (x.detach().clone().requires_grad_(True) for x in cams_c[:2])
        r, o = camera_rays(Rl, Tl, cams_c[2], cams_c[3], CLOUD_HW)
        pts = (verts_c[None] - o[:, None, :]).detach().requires_grad_(not frozen)
        sel, _ = fine.ray_tracing((Rl, Tl, cams_c[2], cams_c[3]), pts, isg_c, r, CLOUD_HW, 0.01,
                                  CLOUD_K, max_points_per_bin=-1)
        loss = (sel[4].sum(-1).clamp(max=1.0) ** 2).mean() + (sel[4] * cw_c).mean()
        return torch.autograd.grad(loss, (Rl, r))     # (T moves the origins, not the rays)

    zero_counts()
    with no_plain_version():
        fz = frozen_step(True)
    counts = read_counts("frozen scene", ("fine_select_global", "fine_bwd_rays"))
    need(counts["fine_bwd_rays"] == 1 and counts["fold_weights"] == 0,
         "frozen scene: the backward was not one launch of the per-ray half")
    need(counts["fine_bwd_gauss"] == 0 and counts["fine_bwd_global"] == 0
         and counts["slot_runs"] == 0, "frozen scene: a per-Gaussian pass or a grouping ran")
    add(counts)
    with trace.tracing():
        full = frozen_step(False)
    need(launched("slot_runs") == 1, "the full step's per-Gaussian pass did not group the slots")
    need(all(bool(torch.isfinite(x).all()) for x in fz), "frozen scene: non-finite gradient")
    need(torch.equal(fz[1], full[1]), "frozen scene: the ray gradient is not the full step's")
    print(f"frozen scene 300K: one launch of the per-ray half (the fold fused in), no grouping; "
          f"|g_R| {fz[0].norm().item():.4e} |g_rays| {fz[1].norm().item():.4e}; ray gradient "
          "equal to the full backward's")

    # 3j. pose scoring and refinement on the batched shape (slice 5)
    Rh, Th = vt.look_at_view_transform(dist=[6.0] * POSE_B, elev=list(np.linspace(5, 25, POSE_B)),
                                       azim=list(np.linspace(50, 90, POSE_B)), device=dev)
    scorer = vt.PoseHypothesisScorer(g.verts.detach(), g.sigmas.detach(), colors, focal=300.0,
                                     principal=(128.0, 128.0), image_size=POSE_HW, max_assign=20,
                                     chunk=POSE_B, device=dev)
    with torch.no_grad():
        target_pose = scorer.render_features(Rh[3:4], Th[3:4])[0][0]
        frag_h = vt.render_pipeline(scorer.verts, scorer.sigmas, Rh, Th,
                                    scorer.focal.expand(POSE_B, 2),
                                    scorer.principal.expand(POSE_B, 2), image_size=POSE_HW,
                                    max_assign=20)
    need(vt.get_overflow_points(frag_h) == 0, "pose batch overflow_points != 0")
    init_pose = (6.0, math.radians(12.0), math.radians(64.0), 0.0)

    def pose_run():
        scores = scorer.score(Rh, Th, target_pose)
        params, sim = vt.refine_pose(scorer, target_pose, init_pose, steps=3, lr=0.01)
        return scores, torch.stack([params[k] for k in ("dist", "elev", "azim", "theta")]), sim

    zero_counts()
    with no_plain_version():
        sc_k, pose_k, sim_k = pose_run()
    # (the features are constants, so the merge's backward is its d_w half
    # alone; the scene is frozen, so K3's backward is its per-ray half alone,
    # once a refinement step, and the only grouping is the coarse stage's)
    counts = read_counts("pose", (*COARSE, "fine_select", "fine_bwd_rays", "attr_merge",
                                  "attr_dw"))
    need(counts["fine_bwd"] == 0 and counts["fine_bwd_gauss"] == 0
         and counts["fine_bwd_rays"] == 3, "pose refinement: K3's per-Gaussian pass ran")
    need(counts["slot_runs"] == counts["emit_rows"],
         "pose refinement: a grouping ran outside the coarse stage")
    add(counts)
    # the same three steps with K3 whole (the scene's verts made to need a
    # gradient, which is then unused): the same bits
    scorer.verts.requires_grad_(True)
    try:
        with trace.tracing():
            _, pose_f, sim_f = pose_run()
        need(launched("fine_bwd") == 3, "pose refinement: K3 did not run whole")
    finally:
        scorer.verts.requires_grad_(False)
    need(torch.equal(pose_k, pose_f) and sim_k == sim_f,
         "pose refinement: the per-ray route differs from K3 whole")
    with plain_path():
        sc_p, pose_p, sim_p = pose_run()
    e_sc = (sc_k - sc_p).abs().max().item()
    e_po = (pose_k - pose_p).abs().max().item()
    need(sc_k.shape == (POSE_B,) and int(sc_k.argmax()) == 3, f"pose scores {sc_k.tolist()}")
    need(e_sc <= SCORE_TOL, f"pose scores kernel vs plain path {e_sc:.3e}")
    need(e_po <= POSE_TOL and abs(sim_k - sim_p) <= SCORE_TOL,
         f"pose refinement kernel vs plain path {e_po:.3e}")
    print(f"pose B={POSE_B}: overflow 0, scores {[round(x, 5) for x in sc_k.tolist()]} (true "
          f"hypothesis 3), kernel vs plain path scores {e_sc:.3e}, parameters after 3 steps "
          f"{e_po:.3e} ({[round(x, 5) for x in pose_k.tolist()]}), similarity {sim_k:.6f}; "
          "the per-ray route and K3 whole equal to the bit")

    def pose_grads():
        """One refinement step's gradients from ``init_pose``: the camera's
        (R, T), then the four pose scalars' through ``pose_matrices``."""
        params = [torch.tensor(v, dtype=torch.float32, device=dev, requires_grad=True)
                  for v in init_pose]
        R, T = vt.models.pose_matrices(*(p[None] for p in params))
        R_l, T_l = R.detach().requires_grad_(True), T.detach().requires_grad_(True)
        pred, _ = scorer.render_features(R_l, T_l)
        loss = -vt.models.feature_similarity(pred, target_pose[None])[0]
        g_R, g_T = torch.autograd.grad(loss, (R_l, T_l))
        g_p = torch.autograd.grad((R * g_R).sum() + (T * g_T).sum(), params)
        return g_R, g_T, torch.stack(g_p)

    # the camera's gradients of one step: held to the plain path (each within
    # GRAD_TOL of its largest entry), and equal to the bit to K3 whole
    with no_plain_version():
        gr_k = pose_grads()
    scorer.verts.requires_grad_(True)
    try:
        gr_f = pose_grads()
    finally:
        scorer.verts.requires_grad_(False)
    need(all(torch.equal(a, b) for a, b in zip(gr_k, gr_f)),
         "pose refinement: the camera gradients of the per-ray route differ from K3 whole")
    with plain_path():
        gr_p = pose_grads()
    pose_grad_err = {n: grad_err(a, b, f"pose refinement camera gradient {n}")
                     for n, a, b in zip(("R", "T", "pose"), gr_k, gr_p)}
    print(f"pose refinement, one step's camera gradients kernel vs plain path: {pose_grad_err}; "
          "the per-ray route equal to the bit to K3 whole")
    details["pose"] = dict(scores=sc_k.tolist(), score_err=e_sc, pose_err=e_po,
                           pose=pose_k.tolist(), similarity=sim_k, grad_err=pose_grad_err)

    cells_state = cell_paths(dev, zero_counts, read_counts, add, details, head)
    shard_paths(dev, zero_counts, read_counts, add, details, head)

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
        """Milliseconds of each call ``fn(v)`` over the inputs ``vs``, by
        ``voge_tpu_torch.timing`` (a pair of CUDA events a call, one
        synchronisation after the last)."""
        vs = list(vs)
        st = timing.measure_stats(fn, args_list=[(v,) for v in vs], n=len(vs), warmup=0,
                                  device=dev)
        return [t * 1e3 for t in st["estimates"]]

    def in_turns(label, fn, batches):
        """Time ``fn`` on the plain, kernel, kernel and plain path, one batch
        of inputs each, after a warm-up of both; the stats by path."""
        runs = {"kernel": [], "plain": []}
        fn(batches[1][0])
        with plain_path():
            fn(batches[0][0])
        torch.cuda.synchronize()
        for path, part in zip(("plain", "kernel", "kernel", "plain"), batches):
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
            print(f"{label} {path} path: median {med:.3f} ms, "
                  f"min {min(ts):.3f}, max {max(ts):.3f}, n={len(ts)}")
        return stats

    halves = [inputs[4:14], inputs[14:24], inputs[4:14], inputs[14:24]]
    for label, fn in (("forward", forward), ("fwd+bwd", fwd_bwd)):
        details[label] = in_turns(f"headline {label}", fn, halves)
    step_ms = details["fwd+bwd"]["kernel"]["median_ms"]

    # the ShapeFitting step, ShapeFitter.step on 5 views: each step moves the
    # parameters, so every timed step has distinct inputs
    sf_fitter = make_fitter()

    def sf_step(_):
        return sf_fitter.step(cams_sf[0], cams_sf[1], *targets_sf)

    details["shapefit_step"] = in_turns("shapefit step", sf_step, [range(10)] * 4)

    # texture extraction: the whole chain, then its three stages (kernel path)
    tex_inputs = [verts_tx * (1.0 + 1e-4 * i) for i in range(24)]

    def tex_chain(v):
        return texture_chain(v, isig_tx, cams_tx, image_tx, ctx_tx)[3]

    tex_halves = [tex_inputs[4:14], tex_inputs[14:24], tex_inputs[4:14], tex_inputs[14:24]]
    details["texture"] = in_turns("texture extraction", tex_chain, tex_halves)
    stage_ms = {"render": [], "sample": [], "re-render": []}
    for v in tex_inputs[4:24]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        fr = vt.render_pipeline(v, isig_tx, *cams_tx, image_size=TEX_HW, max_assign=TEX_K,
                                cam_ctx=ctx_tx)
        ev[1].record()
        feat, wsum = vt.sample_features(fr, image_tx, n_vert=N_tx)
        ev[2].record()
        vt.to_white_background(fr, feat / (1e-8 + wsum[:, None]))
        ev[3].record()
        torch.cuda.synchronize()
        for q, k in enumerate(stage_ms):
            stage_ms[k].append(ev[q].elapsed_time(ev[q + 1]))
    details["texture_stages"] = {k: dict(median_ms=statistics.median(ts), min_ms=min(ts),
                                         max_ms=max(ts), n=len(ts))
                                 for k, ts in stage_ms.items()}
    print("texture extraction stages, kernel path: " + ", ".join(
        f"{k} median {v['median_ms']:.3f} ms (min {v['min_ms']:.3f}, max {v['max_ms']:.3f})"
        for k, v in details["texture_stages"].items()))

    # K2 at the texture shapes by K: the compacted entry (with the
    # erf weights) and the per-bin-list entry on 32-px lists (without)
    table_tx = fine.feature_table(points_tx, isg_tx)
    bp_tx = vt.ops.rasterize_coarse(*cams_tx, points_tx, isg_tx, TEX_HW, 0.01, 32, 64)
    sweep = {}
    for K in (20, 32, 64, 80, 128):
        c = fine.compact_candidates(*cams_tx, points_tx, isg_tx, TEX_HW, 0.01, K)
        tab_c = fine.candidate_table(points_tx, isg_tx, c.pos_c)
        sweep[K] = dict(
            compacted_ms=cuda_ms(lambda: fine_select(
                rays_tx, tab_c, c.bits_c, c.ids_c, c.counts_c, c.thr_act, K, c.bin_size,
                1.0, None), 5),
            bins_ms=cuda_ms(lambda: fine_select_bins(rays_tx, table_tx, bp_tx, c.thr_act, K, 32),
                            5))
    print("K2 at the texture shapes by K (compacted entry with weights / per-bin-list entry "
          "without): " + ", ".join(f"K={K} {v['compacted_ms']:.3f} / {v['bins_ms']:.3f} ms"
                                   for K, v in sweep.items()))
    details["k2_texture_by_k"] = sweep

    # the two-stage tracer, forward + backward, both stages
    two_inputs = [points_h * (1.0 + 1e-5 * i) for i in range(24)]
    two_halves = [two_inputs[4:14], two_inputs[14:24], two_inputs[4:14], two_inputs[14:24]]
    details["two_stage_step"] = in_turns("two-stage fwd+bwd", two_stage, two_halves)
    fwd2 = [t for t in timed(lambda pts: two_stage(pts, False), two_inputs[4:24])]
    details["two_stage_forward_ms"] = dict(median_ms=statistics.median(fwd2), min_ms=min(fwd2),
                                           max_ms=max(fwd2), n=len(fwd2))
    print(f"two-stage forward kernel path: median {statistics.median(fwd2):.3f} ms, "
          f"min {min(fwd2):.3f}, max {max(fwd2):.3f}, n={len(fwd2)}")


    # the point-cloud forward (inputs as bench.py perturbs them) and the
    # 300,000-point step, kernel path only: the plain global select is dense
    # over rays x Gaussians and cannot exist at 3.1e10 pairs
    def stats(ts):
        return dict(median_ms=statistics.median(ts), min_ms=min(ts), max_ms=max(ts), n=len(ts))

    def cloud300(i, backward=True):
        frag, loss, leaves = cloud_step(verts_c * (1.0 + 1e-5 * i), isig_c, cams_c, colors_c)
        return torch.autograd.grad(loss, leaves) if backward else frag

    cloud_forward(verts_p)
    cloud300(0)
    torch.cuda.synchronize()
    details["cloud_100k_forward"] = stats(timed(cloud_forward,
                                                [verts_p * (1.0 + 1e-4 * i) for i in range(10)]))
    details["cloud_300k_step"] = stats(timed(cloud300, range(1, 6)))
    details["cloud_300k_forward"] = stats(timed(lambda i: cloud300(i, False), range(1, 6)))
    for k in ("cloud_100k_forward", "cloud_300k_forward", "cloud_300k_step"):
        v = details[k]
        print(f"{k} kernel path: median {v['median_ms']:.3f} ms, min {v['min_ms']:.3f}, "
              f"max {v['max_ms']:.3f}, n={v['n']}")

    # the fold's entry + the pair against the unified entry on the same
    # 300,000-Gaussian cotangents (the step's: only g_w set, ray gradient
    # wanted), in turns; and the per-Gaussian half when every run is empty
    k3c = head["k3c"]

    def pair_vs_unified(k3, n):
        ts = [cuda_ms(fn, n) for fn in (lambda: fold_then_pair(*k3), lambda: fine_bwd_global(*k3),
                                        lambda: fine_bwd_global(*k3), lambda: fold_then_pair(*k3))]
        return dict(pair=[ts[0], ts[3]], unified=ts[1:3])

    turns = pair_vs_unified(k3c, 10)
    # the same question below the branch point: the ShapeFitting step's
    # backward (only g_w, no ray gradient) and the two-stage tracer's (g_len,
    # g_act, g_dsd, the ray gradient, no weights)
    sel_two = [x.detach() for x in sel_2]
    k3two = (rays_h, table_h, *sel_two, None, *cots_h, None, 1.0, True)
    below = {"shapefit": pair_vs_unified(head["k3g"], 20),
             "two_stage": pair_vs_unified(k3two, 20)}
    split_bits = {}
    for tag, k3 in (("cloud_300k", k3c), ("shapefit", head["k3g"]), ("two_stage", k3two)):
        pair_out, uni_out = fold_then_pair(*k3), fine_bwd_global(*k3)
        for a, b in zip(pair_out, uni_out):
            need((a is None and b is None) or rel_t(a, b) <= PAIR_TOL,
                 f"fold + pair vs the unified entry at the {tag} shapes")
        split_bits[tag] = all((a is None and b is None) or torch.equal(a, b)
                              for a, b in zip(pair_out, uni_out))
    print(f"fold + pair against the unified entry, equal to the bit: {split_bits}")
    details["split_equal_to_the_bit"] = split_bits
    halves_c = head["halves"]
    empty_idx = torch.full_like(halves_c[2], -1)
    gauss_ms = dict(real=cuda_ms(lambda: fine_bwd_gauss(*halves_c), 20),
                    all_empty=cuda_ms(lambda: fine_bwd_gauss(*halves_c[:2], empty_idx,
                                                             *halves_c[3:]), 20),
                    grouping=cuda_ms(lambda: slot_runs(halves_c[2], P_c), 20),
                    grouping_plain=cuda_ms(lambda: slot_runs_plain(halves_c[2], P_c), 20))
    details["split_vs_unified_300k_ms"] = dict(turns, fold=cuda_ms(lambda: fold_weights(
        *k3c[3:7], k3c[10], 1.0), 20), **gauss_ms)
    details["split_vs_unified_below_ms"] = below
    for tag, v in below.items():
        print(f"{tag} backward on the same cotangents: fold + pair {v['pair'][0]:.4f} / "
              f"{v['pair'][1]:.4f} ms, unified entry {v['unified'][0]:.4f} / "
              f"{v['unified'][1]:.4f} ms")
    print(f"300K backward on the same cotangents: fold + pair {turns['pair'][0]:.4f} / "
          f"{turns['pair'][1]:.4f} ms, unified entry {turns['unified'][0]:.4f} / "
          f"{turns['unified'][1]:.4f} ms; fold alone "
          f"{details['split_vs_unified_300k_ms']['fold']:.4f} ms; fine_bwd_gauss "
          f"{gauss_ms['real']:.4f} ms on the render's slots, {gauss_ms['all_empty']:.4f} ms with "
          f"all {P_c} runs empty, of which the grouping {gauss_ms['grouping']:.4f} ms (plain "
          f"torch.sort + searchsorted {gauss_ms['grouping_plain']:.4f} ms)")

    # rows 6 and 7 at the 300K cloud by lane width and by route: the
    # per-Gaussian half (its per-slot pass, grouping and per-Gaussian kernel)
    # at 4, 8, 16 and 32 lanes a Gaussian; the per-ray half; a frozen scene's
    # backward as one launch with the fold fused in against the fold's entry
    # followed by the unfused per-ray launch (the route before), in turns
    idx_c, len_c, act_c, dsd_c, w_c = sel_c

    def gauss_half(G):
        """``fine_bwd_gauss``'s stages, composed as it composes them, at G
        lanes a Gaussian."""
        rays, table, idx, length, dsd = halves_c[:5]
        coef = cuda_fine_bwd._slots_stage(rays, table, idx, length, None, dsd, None,
                                          (*halves_c[5:], None), 1.0, None, None, True,
                                          False)[0]
        order, starts = slot_runs(idx, table.shape[0])
        return cuda_fine_bwd._runs_stage(rays, table, coef, None, None, order, starts, G)

    need(torch.equal(gauss_half(group_width(idx_c.numel(), P_c)), fine_bwd_gauss(*halves_c)),
         "row 6 at 300K: the composed stages differ from fine_bwd_gauss")
    half_by_lanes = {G: dict(ms=cuda_ms(lambda G=G: gauss_half(G), 20),
                             device_ms=device_ms(lambda G=G: gauss_half(G), 10))
                     for G in (4, 8, 16, 32)}
    frozen_c = (rays_c, table_cl, idx_c, len_c, dsd_c, None, None, None)

    def fused():
        return fine_bwd_rays(*frozen_c, act=act_c, w=w_c, g_w=g_c[3], agg_ow=1.0)

    def fold_then_rays():
        return fine_bwd_rays(*frozen_c[:5], *fold_weights(len_c, act_c, dsd_c, w_c, g_c[3], 1.0))

    need(torch.equal(fused(), fold_then_rays()), "frozen 300K backward: the fused launch "
                                                 "differs from the fold + the per-ray half")
    routes_ms = {"fused": [], "fold_then_rays": []}
    for name in ("fused", "fold_then_rays", "fold_then_rays", "fused"):
        routes_ms[name].append(cuda_ms(fused if name == "fused" else fold_then_rays, 20))
    v_c, v_sq_c = slot_counts(idx_c)
    occupied_c = torch.unique(idx_c[idx_c >= 0]).numel()
    frozen_bound = bound_ms(nbytes(rays_c, idx_c, len_c, act_c, dsd_c, w_c, g_c[3])
                            + occupied_c * 64 + nbytes(rays_c),
                            v_sq_c * FOLD_FLOPS + v_c * SLOT_RAY_FLOPS)
    frozen_t = dict(ms=routes_ms, bound_ms=frozen_bound[0], bound_by=frozen_bound[1],
                    profile={k: launch_profile(f, 10) for k, f in (("fused", fused),
                                                                   ("fold_then_rays",
                                                                    fold_then_rays))},
                    rays_only_ms=cuda_ms(lambda: fine_bwd_rays(*halves_c), 20),
                    rays_only_device_ms=device_ms(lambda: fine_bwd_rays(*halves_c), 10))
    details["rows_6_7_300k"] = dict(gauss_by_lanes=half_by_lanes, frozen_backward=frozen_t,
                                    lanes=group_width(idx_c.numel(), P_c))
    print(f"row 6 at the 300K cloud (fine_bwd_gauss, grouping included) by lanes a Gaussian "
          f"(the rule takes {group_width(idx_c.numel(), P_c)}): " + ", ".join(
              f"{G}: {v['ms']:.4f} ms (device {v['device_ms']:.4f})"
              for G, v in half_by_lanes.items()))
    print(f"row 7 at the 300K cloud: rays-only launch {frozen_t['rays_only_ms']:.4f} ms (device "
          f"{frozen_t['rays_only_device_ms']:.4f}); frozen backward fused "
          f"{routes_ms['fused'][0]:.4f} / {routes_ms['fused'][1]:.4f} ms, fold + per-ray half "
          f"{routes_ms['fold_then_rays'][0]:.4f} / {routes_ms['fold_then_rays'][1]:.4f} ms, "
          f"equal to the bit; bound of the fused launch {frozen_bound[0]:.5f} ms by "
          f"{frozen_bound[1]}; a call: " + "; ".join(
              f"{k} device {p['device_ms']:.4f} ms, kernels {p['kernels']:.1f}"
              for k, p in frozen_t["profile"].items()))

    # K3's three parts apart: the per-slot kernel, the grouping of the slot
    # ids (beside its plain version) and the per-Gaussian kernel, at the headline (compacted
    # entry, attributes, with and without rays) and the ShapeFitting shapes
    # (global entry, only g_w, as the trainer's loss gives it)
    def k3_parts(k3, attrs, g_img):
        rays, table, idx = k3[0], k3[1], k3[2]
        parts = (rays, table, idx, *k3[3:7], k3[7:11], k3[11], attrs, g_img)
        coef = cuda_fine_bwd._slots_stage(*parts, True, k3[-1])[0]
        order, starts = slot_runs(idx, table.shape[0])
        runs = lambda G=None: cuda_fine_bwd._runs_stage(rays, table, coef, k3[6], g_img, order,
                                                         starts, G)
        return dict(
            slots=cuda_ms(lambda: cuda_fine_bwd._slots_stage(*parts, True, k3[-1]), 50),
            grouping=cuda_ms(lambda: slot_runs(idx, table.shape[0]), 50),
            grouping_plain=cuda_ms(lambda: slot_runs_plain(idx, table.shape[0]), 50),
            runs=cuda_ms(runs, 50), lanes=group_width(idx.numel(), table.shape[0]),
            runs_by_lanes={G: cuda_ms(lambda G=G: runs(G), 50) for G in (4, 8, 16, 32)},
            runs_device_by_lanes={G: device_ms(lambda G=G: runs(G), 10) for G in (4, 8, 16, 32)})
    k3b_rays = head["k3b"][:-1] + (True,)
    k3_ms = {"cloud_300k": k3_parts(head["k3c"], None, None),
             "headline": k3_parts(head["k3b"], *head["k3b"][12:14]),
             "headline_rays": k3_parts(k3b_rays, *head["k3b"][12:14]),
             "shapefit": k3_parts(head["k3g"], None, None)}
    for tag, v in k3_ms.items():
        print(f"K3 parts {tag}: per-slot kernel {v['slots']:.4f} ms, grouping {v['grouping']:.4f} "
              f"ms (plain {v['grouping_plain']:.4f}), per-Gaussian kernel {v['runs']:.4f} ms at "
              f"{v['lanes']} lanes a Gaussian; by lanes " + ", ".join(
                  f"{G}: {v['runs_by_lanes'][G]:.4f} (device {v['runs_device_by_lanes'][G]:.4f})"
                  for G in (4, 8, 16, 32)))
    details["k3_parts_ms"] = k3_ms

    # pose: scoring 8 hypotheses in one chunk, and one refinement step
    def pose_score(_):
        return scorer.score(Rh, Th, target_pose)

    def pose_refine(_):
        return vt.refine_pose(scorer, target_pose, init_pose, steps=1, lr=0.01)

    def pose_refine_whole(_):
        """A refinement step with K3 whole: the scene's verts made to need a
        gradient, which is then unused (the route before the per-ray half)."""
        scorer.verts.requires_grad_(True)
        try:
            return pose_refine(_)
        finally:
            scorer.verts.requires_grad_(False)

    details["pose_score"] = in_turns("pose score B=8", pose_score, [range(5)] * 4)
    details["pose_refine_step"] = in_turns("pose refine step", pose_refine, [range(5)] * 4)
    by_route = {"per_ray": [], "k3_whole": []}
    pose_refine_whole(0)
    torch.cuda.synchronize()
    for name in ("per_ray", "k3_whole", "k3_whole", "per_ray"):
        by_route[name] += timed(pose_refine if name == "per_ray" else pose_refine_whole,
                                range(5))
    route_prof = {k: launch_profile(lambda f=f: f(0), 5)
                  for k, f in (("per_ray", pose_refine), ("k3_whole", pose_refine_whole))}
    details["pose_refine_by_route"] = dict(
        ms={k: dict(median_ms=statistics.median(v), min_ms=min(v), max_ms=max(v), n=len(v))
            for k, v in by_route.items()}, profile=route_prof)
    print("pose refine step by backward route (in turns): " + "; ".join(
        f"{k} median {statistics.median(v):.3f} ms (min {min(v):.3f}, max {max(v):.3f}), device "
        f"{route_prof[k]['device_ms']:.4f} ms, kernels {route_prof[k]['kernels']:.1f}, memsets "
        f"{route_prof[k]['memsets']:.1f}" for k, v in by_route.items()))

    # the coarse stage alone (compact_candidates), staged kernels against the
    # int64 route in turns, at every main path's shapes: CUDA-event ms of
    # back-to-back calls, and from a profile the device ms, kernel launches,
    # memsets and host reads a call; the check reads the host reads counted
    # on the host, call by call
    stage_t = {}
    for tag, (cams_s, pts_s, isg_s, hw_s, K_s) in coarse_cells.items():
        def call(cams_s=cams_s, pts_s=pts_s, isg_s=isg_s, hw_s=hw_s, K_s=K_s):
            return fine.compact_candidates(*cams_s, pts_s, isg_s, hw_s, 0.01, K_s)

        ms = {"staged": [], "sorted": []}
        for route in ("staged", "sorted", "sorted", "staged"):
            with sorted_route() if route == "sorted" else nullcontext():
                ms[route].append(cuda_ms(call, 20))
        prof = {}
        for route in ("staged", "sorted"):
            with sorted_route() if route == "sorted" else nullcontext():
                prof[route] = launch_profile(call, 10)
        syncs = host_syncs(call, 10)
        b_ms, b_by = coarse_held[tag]["bounds"]["stage"]
        stage_t[tag] = dict(ms=ms, profile=prof, host_syncs=syncs, bound_ms=b_ms, bound_by=b_by)
        print(f"coarse stage {tag} (compact_candidates): staged {ms['staged'][0]:.4f} / "
              f"{ms['staged'][1]:.4f} ms, int64 route {ms['sorted'][0]:.4f} / "
              f"{ms['sorted'][1]:.4f} ms; bound {b_ms:.5f} ms by {b_by}; a call: "
              + "; ".join(f"{r} device {p['device_ms']:.4f} ms, kernels {p['kernels']:.1f}, "
                          f"memsets {p['memsets']:.1f}, host reads {p['host_reads']:.1f}, "
                          f"host writes {p['host_writes']:.1f}" for r, p in prof.items())
              + f"; staged host reads counted by call {syncs}")
        need(syncs == [2 if tag == "texture" else 1] * len(syncs),
             f"coarse stage {tag}: not one host read a render (two when it re-emits): {syncs}")
    details["coarse_stage_ms"] = stage_t

    def routes(label, fn, args):
        """``fn`` over ``args`` on the staged coarse stage and on the int64
        route in turns (staged, int64, int64, staged): the stats by route."""
        fn(args[0])
        with sorted_route():
            fn(args[0])
        runs = {"staged": [], "sorted": []}
        for route in ("staged", "sorted", "sorted", "staged"):
            with sorted_route() if route == "sorted" else nullcontext():
                runs[route] += timed(fn, args)
        out = {r: dict(median_ms=statistics.median(v), min_ms=min(v), max_ms=max(v), n=len(v))
               for r, v in runs.items()}
        print(f"{label} by coarse route: " + ", ".join(
            f"{r} median {v['median_ms']:.3f} ms (min {v['min_ms']:.3f}, max {v['max_ms']:.3f})"
            for r, v in out.items()))
        return out

    details["e2e_by_coarse_route"] = {
        "headline_step": routes("headline fwd+bwd", fwd_bwd, inputs[4:14]),
        "texture_chain": routes("texture extraction", tex_chain, tex_inputs[4:14]),
        "cloud_100k_forward": routes("point cloud 100K forward", cloud_forward,
                                     [verts_p * (1.0 + 1e-4 * i) for i in range(10)]),
        "pose_score": routes("pose score B=8", pose_score, range(5)),
    }

    k2, k3 = head["k2"], head["k3"]
    hc = head["coarse"]
    per = {
        "emit_rows": (lambda: emit_rows(*hc["k1"]), lambda: emit_rows_plain(*hc["k1"])),
        "coarse_globals": (lambda: coarse_globals(*hc["glob"]),
                           lambda: coarse_globals_plain(*hc["glob"])),
        "coarse_rows": (lambda: coarse_rows(*hc["rows_args"]),
                        lambda: coarse_rows_plain(*hc["rows_args"])),
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
        "attr_scatter": (lambda: attr_scatter(*head["scatter"]),
                         lambda: attr_scatter_plain(*head["scatter"])),
        "attr_dw": (lambda: attr_dw(*head["dw"]), lambda: attr_dw_plain(*head["dw"])),
        "fine_select_bins": (lambda: fine_select_bins(*head["k2b"]),
                             lambda: fine_select_bins_plain(*head["k2b"])),
        "fine_bwd_gauss": (lambda: fine_bwd_gauss(*halves_c),
                           lambda: fine_bwd_gauss_plain(*halves_c)),
        "fine_bwd_rays": (lambda: fine_bwd_rays(*halves_c),
                          lambda: fine_bwd_rays_plain(*halves_c)),
        "slot_runs": (lambda: slot_runs(head["scatter"][0], N_tx),
                      lambda: slot_runs_plain(head["scatter"][0], N_tx)),
    }

    # Bounds: bytes each input is read once and each output written once
    # (of candidate tables only the occupied rows), operations as counted
    # from this run's selections (see the constants at the top).
    def select_bound(rays, n_rows_read, idx, pairs, extra_in=0, outs=5, d=0):
        valid, valid_sq = slot_counts(idx)
        n_pix, K = idx.numel() // idx.shape[-1], idx.shape[-1]
        by = nbytes(rays) + n_rows_read + extra_in + outs * n_pix * K * 4 + n_pix * d * 4
        weights = valid_sq * WEIGHT_FLOPS if outs == 5 else 0.0
        return bound_ms(by, pairs * PAIR_FLOPS + weights + valid * 2 * d)

    def bwd_bound(rays, n_rows_read, sel, cots, rows_out, want_rays, attrs=None, g_img=None):
        valid, valid_sq = slot_counts(sel[0])
        d = 0 if attrs is None else attrs.shape[1]
        by = (nbytes(rays, *sel, *cots, attrs, g_img) + n_rows_read + rows_out * (12 + d) * 4
              + (nbytes(rays) if want_rays else 0))
        return bound_ms(by, valid_sq * FOLD_FLOPS + valid * (SLOT_BWD_FLOPS + 4 * d))

    def half_bound(halves, gauss):
        """The split backward's halves: every slot array read once, the
        feature rows of the Gaussians that hold a slot, the dense output."""
        rays, table, idx, *slots = halves
        ok = (idx >= 0) & (idx < table.shape[0])
        by = (nbytes(rays, idx, *slots) + torch.unique(idx[ok]).numel() * 64
              + (table.shape[0] * 48 if gauss else nbytes(rays)))
        return bound_ms(by, ok.sum().item() * (SLOT_GAUSS_FLOPS if gauss else SLOT_RAY_FLOPS))

    def global_bound(args, idx, stats):
        """K2's global entry, bytes as above, operations counted two ways:
        ``all_pairs`` a hit test for every (ray, Gaussian) pair (what the
        entry did before it culled); ``needed`` a hit test for every pair
        that passes it (each may enter the top-K: what the function's result
        needs, however the rest is ruled out).  The kernels line carries the
        second.  ``cone_tests_ms``: this kernel's one cone test a (block,
        Gaussian) pair at the card's peak, its own overhead, in no bound."""
        rays, table = args[0], args[1]
        every = float(rays.numel() // 3) * (table.shape[0] // rays.shape[0])
        return dict(all_pairs=select_bound(rays, nbytes(table), idx, every),
                    needed=select_bound(rays, nbytes(table), idx, stats["passing_pairs"]),
                    cone_tests_ms=stats["block_pairs"] * CULL_FLOPS / FP32_FLOP_S * 1e3)

    sel_h = fine_select(*k2)
    occupied = int(k2[4].sum())
    k3b, k3g, k2g, k2b = head["k3b"], head["k3g"], head["k2g"], head["k2b"]
    n_sf = k2g[0].numel() // 3
    lists = k2b[2]
    listed = ((lists >= 0).sum(-1).double() * tile_rays(256, 256, k2b[5], k2b[5], dev)[None])
    sc_valid, _ = slot_counts(head["scatter"][0])
    idx4, w4, attrs4, g4 = head["k4b"]
    v4, v4_sq = slot_counts(idx4)
    bounds = {
        **{k: hc["bounds"][k] for k in COARSE_KERNELS},
        "fine_select": select_bound(
            k2[0], occupied * 72 + nbytes(k2[4], k2[9]), sel_h[0],
            compacted_pairs(k2[2], k2[4], 256, 256, k2[7]), d=k2[9].shape[1]),
        "attr_merge": merge_bound(*k3),
        "fold_weights": bound_ms(8 * nbytes(head["fold"][0]),
                                 slot_counts(sel_h[0])[1] * FOLD_FLOPS),
        "fine_bwd": bwd_bound(k3b[0], torch.unique(k3b[2][k3b[2] >= 0]).numel() * 64, k3b[2:7],
                              k3b[7:11], k3b[1].shape[0], k3b[14], k3b[12], k3b[13]),
        "attr_merge_bwd": bound_ms(nbytes(idx4, w4, attrs4, g4) + nbytes(w4, attrs4),
                                   v4 * 4 * attrs4.shape[1]),
        "fine_select_global": global_bound(k2g, sel_sf[0], cull_sf)["needed"],
        "fine_bwd_global": bwd_bound(k3g[0], nbytes(k3g[1]), k3g[2:7],
                                     [c for c in k3g[7:11] if c is not None],
                                     k3g[1].shape[0], k3g[12]),
        "attr_scatter": bound_ms(nbytes(*head["scatter"][:3]) + N_tx * 4 * 4, sc_valid * 2 * 4),
        "attr_dw": dw_bound(*head["dw"]),
        "fine_select_bins": select_bound(
            k2b[0], nbytes(k2b[1], lists), fine_select_bins(*k2b)[0], listed.sum().item(),
            outs=4),
        "fine_bwd_gauss": half_bound(halves_c, True),
        "fine_bwd_rays": half_bound(halves_c, False),
        # the grouping: idx read once, starts and the valid slots' order written once
        "slot_runs": bound_ms(nbytes(head["scatter"][0]) + (N_tx + 1) * 8 + sc_valid * 4, 0.0),
    }

    # one PyTorch call that computes the same function, where there is one,
    # on inputs prepared outside the timed call; the port never calls them
    idx_s, w_s, g_s, _ = head["scatter"]
    ok_s = idx_s >= 0
    seg_s = torch.where(ok_s, idx_s, N_tx).long().reshape(-1)
    vals_s = (torch.where(ok_s, w_s, 0.0)[..., None] * g_s[..., None, :]).reshape(-1, 4)
    acc_s = torch.zeros((N_tx + 1, 4), device=dev)
    bag_idx = torch.where(k3[0] >= 0, k3[0], k3[2].shape[0]).long().reshape(-1, k3[0].shape[-1])
    bag_w = k3[1].reshape(bag_idx.shape)
    bag_rows = torch.cat([k3[2], torch.zeros_like(k3[2][:1])])
    key_s = torch.where(ok_s, idx_s, N_tx).reshape(-1)
    edges_s = torch.arange(N_tx + 1, dtype=key_s.dtype, device=dev)
    library = {
        "attr_scatter": lambda: acc_s.zero_().index_add_(0, seg_s, vals_s),
        "attr_merge": lambda: torch.nn.functional.embedding_bag(
            bag_idx, bag_rows, per_sample_weights=bag_w, mode="sum",
            padding_idx=k3[2].shape[0]),
        "slot_runs": lambda: torch.searchsorted(torch.sort(key_s, stable=True)[0], edges_s),
        # the int64 route's sort of the stage's keys and search of its row
        # edges, which slot_runs and the rows kernel replace
        "coarse_rows": lambda: torch.searchsorted(torch.sort(hc["keys"])[0], hc["edges"]),
    }
    e = (library["attr_scatter"]()[:N_tx] - attr_scatter(*head["scatter"])).abs().max().item()
    need(e <= GRAD_TOL * acc_s.abs().max().item(), f"index_add_ vs attr_scatter {e}")
    e = (library["attr_merge"]().reshape(k3[0].shape[:-1] + (-1,)) - attr_merge(*k3)).abs().max().item()
    need(e <= 1e-5, f"embedding_bag vs attr_merge {e}")
    sort_ms = cuda_ms(lambda: slot_runs(idx_s, N_tx), 20)
    sort_plain_ms = cuda_ms(lambda: slot_runs_plain(idx_s, N_tx), 20)
    print(f"attr_scatter's grouping of {idx_s.numel()} slot ids (slot_runs) takes {sort_ms:.4f} ms "
          f"of the wrapper's time; its plain version (torch.sort + searchsorted) {sort_plain_ms:.4f} ms")
    details["attr_scatter_sort_ms"] = dict(kernel=sort_ms, plain=sort_plain_ms)

    # rows 3, 12 and 10 at the headline and at the texture shapes
    a_sh = head["attr_shapes"]
    plain_at = {"attr_merge": lambda tag: lambda: attr_merge_plain(*a_sh[tag][0]),
                "attr_dw": lambda tag: lambda: attr_dw_plain(*a_sh[tag][1]),
                "attr_merge_bwd": lambda tag: lambda: attr_merge_bwd_plain(*a_sh[tag][2])}
    at_shapes = details["attr_rows_at_shapes"] = attr_rows_at_shapes(a_sh, plain_at)

    kern = []
    details["kernels_device_ms"] = {}
    for name, (kfn, pfn) in per.items():
        ms = cuda_ms(kfn, 50)
        plain_ms = cuda_ms(pfn, 5 if name.startswith(("fine_select", "fine_bwd")) else 20)
        lib_ms = cuda_ms(library[name], 20) if name in library else None
        b_ms, b_by = bounds[name]
        dev_ms = details["kernels_device_ms"][name] = device_ms(kfn, 10)
        h_us = host_us(kfn)
        print(f"kernel {name}: {ms:.4f} ms (device {dev_ms:.4f}, host {h_us:.2f} us a call), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} (share {b_ms / ms:.4f}), "
              "library " + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
              + f", launches on the main paths {launches[name]}")
        _, src, rep = KERNELS[name]
        kern.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=launches[name], max_abs_err=err[name],
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, device_ms=dev_ms, host_us=h_us))
        if name in at_shapes:
            kern[-1]["shapes"] = at_shapes[name]
    details["kernels"] = kern
    need(len(kern) == len(KERNELS) == 16, "the kernels line lists every entry")

    # K2's global entry and the unified backward once more, at the 300K
    # shapes (the lines above hold them at the ShapeFitting shapes)
    k2c = head["k2c"]
    c3 = dict(select_ms=cuda_ms(lambda: fine_select_global(*k2c), 3),
              unified_bwd_ms=statistics.median(turns["unified"]))
    gb_c, gb_sf = global_bound(k2c, sel_c[0], cull_c), global_bound(k2g, sel_sf[0], cull_sf)
    c3["select_bound_ms"], c3["select_bound_by"] = gb_c["needed"]
    c3["select_bound_all_pairs_ms"] = gb_c["all_pairs"][0]
    sf_ms = next(k["ms"] for k in kern if k["name"] == "fine_select_global")
    for tag, gb, ms in (("ShapeFitting", gb_sf, sf_ms), ("300K", gb_c, c3["select_ms"])):
        need(gb["needed"][0] <= ms, f"fine_select_global at the {tag} shapes beats its bound")
        print(f"fine_select_global bound at the {tag} shapes: every (ray, Gaussian) pair "
              f"tested {gb['all_pairs'][0]:.5f} ms by {gb['all_pairs'][1]} (the kernel takes "
              f"{ms / gb['all_pairs'][0]:.3f} of it); the passing pairs {gb['needed'][0]:.5f} ms "
              f"by {gb['needed'][1]} (share {gb['needed'][0] / ms:.4f}); beside the bound, the "
              f"kernel's own cone tests at the card's peak {gb['cone_tests_ms']:.5f} ms")
    details["fine_select_global_bounds"] = {
        tag: dict(all_pairs=gb["all_pairs"][0], needed=gb["needed"][0],
                  cone_tests_ms=gb["cone_tests_ms"])
        for tag, gb in (("shapefit", gb_sf), ("cloud_300k", gb_c))}
    c3["unified_bound_ms"], c3["unified_bound_by"] = bwd_bound(
        k3c[0], nbytes(k3c[1]), k3c[2:7], [k3c[10]], P_c, True)
    print(f"kernel fine_select_global at the 300K shapes: {c3['select_ms']:.3f} ms, bound "
          f"{c3['select_bound_ms']:.4f} ms by {c3['select_bound_by']} (share "
          f"{c3['select_bound_ms'] / c3['select_ms']:.4f}); fine_bwd_global there: "
          f"{c3['unified_bwd_ms']:.4f} ms, bound {c3['unified_bound_ms']:.5f} ms by "
          f"{c3['unified_bound_by']}")
    details["kernels_300k"] = c3

    # K2's compacted entry once more, at the texture render's shapes (the
    # line above holds it at the headline's): 74% of that path's device time
    k2tx = head["k2tx"]
    tx = dict(ms=cuda_ms(lambda: fine_select(*k2tx), 20),
              plain_ms=cuda_ms(lambda: fine_select_plain(*k2tx), 3))
    tx["bound_ms"], tx["bound_by"] = select_bound(
        k2tx[0], int(k2tx[4].sum()) * 72 + nbytes(k2tx[4]), idx_tx,
        compacted_pairs(k2tx[2], k2tx[4], *TEX_HW, k2tx[7]))
    print(f"kernel fine_select at the texture shapes (K = {TEX_K}): "
          f"{tx['ms']:.4f} ms, plain {tx['plain_ms']:.4f} ms, bound {tx['bound_ms']:.5f} ms by "
          f"{tx['bound_by']} (share {tx['bound_ms'] / tx['ms']:.4f}), library none")
    details["fine_select_texture"] = tx

    # K2's compacted entry at the 100K cloud, the rows' gather there and at
    # the texture shapes, and the global entry's glue
    c_pp = fine.compact_candidates(*cams_p, points_p, isg_p, CLOUD_HW, 0.01, CLOUD_K)
    tab_pp = fine.candidate_table(points_p, isg_p, c_pp.pos_c)
    k2p = (ctx_p.rays, tab_pp, c_pp.bits_c, c_pp.ids_c, c_pp.counts_c, c_pp.thr_act, CLOUD_K,
           c_pp.bin_size, 1.0, None)
    cp = dict(ms=cuda_ms(lambda: fine_select(*k2p), 20),
              gather_ms=cuda_ms(lambda: fine.candidate_table(points_p, isg_p, c_pp.pos_c), 20),
              gather_texture_ms=cuda_ms(
                  lambda: fine.candidate_table(points_tx, isg_tx, c_tx.pos_c), 20),
              row_width=tab_pp.shape[1], row_width_texture=tab_tx.shape[1])
    cp["bound_ms"], cp["bound_by"] = select_bound(
        k2p[0], int(k2p[4].sum()) * 72 + nbytes(k2p[4]), frag_p.vert_index,
        compacted_pairs(k2p[2], k2p[4], *CLOUD_HW, k2p[7]))
    print(f"kernel fine_select at the 100K cloud: {cp['ms']:.4f} ms, bound {cp['bound_ms']:.5f} "
          f"ms by {cp['bound_by']} (share {cp['bound_ms'] / cp['ms']:.4f}); candidate_table "
          f"(rows of {cp['row_width']}) {cp['gather_ms']:.4f} ms; at the texture shapes (rows of "
          f"{cp['row_width_texture']}) {cp['gather_texture_ms']:.4f} ms")
    details["fine_select_cloud_100k"] = cp
    th_g, tw_g = cuda_fine.global_tile(False, bs_c)
    def level1(r, t):
        """The two-level route's glue past the cull rows: the warps' and the
        super-tiles' cones and level 1's masks."""
        rows = cuda_fine.cull_rows(t, thr_act)
        return lambda: cuda_fine.cull_lists(rows, cuda_fine.two_level_cones(r)[1], r.shape[0],
                                            t.shape[0] // r.shape[0])

    glue = {tag: dict(cull_rows_ms=cuda_ms(lambda: cuda_fine.cull_rows(t, thr_act), 20),
                      block_cones_ms=cuda_ms(lambda: cuda_fine.block_cones(r, th_g, tw_g), 20),
                      level1_ms=cuda_ms(level1(r, t), 20))
            for tag, r, t in (("shapefit", rays_sf, table_sf), ("cloud_300k", rays_c, table_cl))}
    print("K2 global glue (inside the wrapper's time): " + "; ".join(
        f"{tag} cull_rows {v['cull_rows_ms']:.4f} ms, block_cones {v['block_cones_ms']:.4f} ms, "
        f"two-level cones and level 1 {v['level1_ms']:.4f} ms" for tag, v in glue.items()))
    details["fine_select_global_glue"] = glue

    # the global entry against the same kernel walking every Gaussian (its
    # reference without the cone cull), in turns (on, off, off, on)
    def cull_both_ways(args, n):
        out = {True: [], False: []}
        for v in (True, False, False, True):
            out[v].append(cuda_ms(lambda: fine_select_global(*args, _cull=v), n))
        return dict(on=out[True], off=out[False])

    switches = {"cull_shapefit": cull_both_ways(k2g, 20), "cull_cloud_300k": cull_both_ways(k2c, 2)}
    for tag, v in switches.items():
        print(f"K2 global with and without its cull, {tag}: on {v['on'][0]:.4f} / "
              f"{v['on'][1]:.4f} ms, off {v['off'][0]:.4f} / {v['off'][1]:.4f} ms")
    details["k2_switches"] = switches

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
        events = prof.key_averages()
        kinds = {ev.key: ev.self_device_time_total / 1e3 for ev in events if on_device(ev)}
        dev_ms = sum(kinds.values()) / len(args)
        # the device total as it was read before user-annotated ranges were
        # left out: comparable with readings taken that way
        with_ranges = sum(ev.self_device_time_total for ev in events
                          if on_card(ev)) / 1e3 / len(args)
        busy = dev_ms / untraced_ms
        top = sorted(kinds.items(), key=lambda kv: -kv[1])[:10]
        print(f"profile {tag}: device {dev_ms:.3f} ms per step (with user-annotated ranges "
              f"{with_ranges:.3f}), busy share {busy:.3f} of the untraced median (traced wall "
              f"{wall_ms / len(args):.3f} ms); top over {len(args)} steps: "
              + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))
        (OUT_DIR / path).write_text(events.table(sort_by="self_device_time_total", row_limit=40))
        return dict(device_ms_per_step=dev_ms, device_busy_share=busy,
                    device_ms_with_ranges_per_step=with_ranges,
                    traced_wall_ms_per_step=wall_ms / len(args),
                    device_ms_by_kernel=kinds)

    details["profile"] = profiled("fitting step", fwd_bwd, inputs[:5], step_ms, "profile.txt")
    details["profile_shapefit"] = profiled(
        "shapefit step", sf_step, range(5), details["shapefit_step"]["kernel"]["median_ms"],
        "profile_shapefit.txt")
    details["profile_texture"] = profiled(
        "texture extraction", tex_chain, tex_inputs[:5],
        details["texture"]["kernel"]["median_ms"], "profile_texture.txt")
    details["profile_two_stage"] = profiled(
        "two-stage fwd+bwd", two_stage, two_inputs[:5],
        details["two_stage_step"]["kernel"]["median_ms"], "profile_two_stage.txt")
    details["profile_cloud_100k"] = profiled(
        "point cloud 100K forward", cloud_forward,
        [verts_p * (1.0 + 1e-4 * i) for i in range(10, 15)],
        details["cloud_100k_forward"]["median_ms"], "profile_cloud_100k.txt")
    details["profile_cloud_300k"] = profiled(
        "point cloud 300K step", cloud300, range(6, 11),
        details["cloud_300k_step"]["median_ms"], "profile_cloud_300k.txt")
    details["profile_pose_score"] = profiled(
        "pose score B=8", pose_score, range(5), details["pose_score"]["kernel"]["median_ms"],
        "profile_pose_score.txt")
    details["profile_pose_refine"] = profiled(
        "pose refine step", pose_refine, range(5),
        details["pose_refine_step"]["kernel"]["median_ms"], "profile_pose_refine.txt")

    cell_timings(dev, cells_state, head, profiled, details)

    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(f"nvidia-smi: {smi_line()}")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
