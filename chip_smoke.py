"""The port's build report and per-kernel table on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  The kernels' and paths' checks on the
card are the ``cuda`` tests (``tests/test_torch_cuda*.py``), and
``portbench/`` measures the benchmark cells' paths; this script holds what
it builds and times to the same checks, with the same helpers
(``tests/cuda_common.py``), so that its table is of kernels that compute
their functions.  Phases:
  1. the card (nvidia-smi name and power limit) and the kernel build from
     ``voge_tpu_torch/csrc``, one ``nvcc`` per source, all at once (build
     seconds, ptxas register / spill report; K2's registers, spills and
     shared memory per instantiation and its resident blocks by K; K3's
     per-slot kernel's, its per-Gaussian kernel's at each lane width and the
     fold's registers and spills);
  2. one call of each main path (the headline fitting step;
     ``GaussianRenderer`` -> white background -> backward; a ``ShapeFitter``
     step; the texture chain and a backward through the sampler; the
     two-stage tracer forward + backward; the 100,000-point forward; the
     300,000-point step; its frozen-scene step; pose scoring of 8 hypotheses
     and one refinement step; one step refining 8 images at 128 features;
     the occlusion step; the headline step at B = 8) with every plain
     version made to raise, each kernel the path
     needs (``cuda_common.PATH_KERNELS``) launched, and the launches of each
     kernel wrapper counted by the port's tracing;
  3. the kernel table (PERF.md section 6): each kernel on a main path's
     inputs (the headline, the ShapeFitting, texture and 300K shapes), held
     to its plain version on them (``hold_plain``), its CUDA-event ms,
     device ms (torch.profiler), host µs a call (enqueued without
     synchronising), its plain version's ms, one PyTorch call that
     computes the same function where there is one, and its bound: the
     larger of its bytes over the card's memory rate and its operations
     over its FP32 rate (``portbench/roofline.py``), counted from this
     run's inputs (K2's global entry: its passing pairs, counted through
     the plain cone cull); rows 3, 12 and 10 (K3f, ``attr_dw``, K4b) at the
     headline and the texture shapes, device ms also with the inputs rotated
     past the L2 (``past_l2``); the similarity kernel at pose scoring's
     (32, 256, 256, 128) (``similarity_row``) and its gradient's kernels at
     pose refinement's (``similarity_grad_row``) and at the pose path's
     scalar refinement (``similarity_scalar_row``); the coarse stage against its
     int64 route (``ops.coarse._emit_candidates_sorted``), equal to the bit
     and timed in turns, at the headline and texture shapes, with device ms,
     kernels, memsets and host reads a call; K2's compacted entry at the
     texture and 100K shapes; K2's
     global entry and K3's unified entry at 300K; a frozen scene's backward
     at 300K as one fused launch and as the fold + the unfused per-ray launch;
  4. the paths no benchmark cell measures whose times the records cite: the
     K = 200 step through the dense route in both modes and the sharded
     headline step on four meshes of the one card beside the single-device
     step (medians by ``voge_tpu_torch.timing``, device ms by kernel from a
     profile).

The last line is ``{"ok": ..., "failures": n, "device": {...}}``; the line
before it a JSON line of the kernels, and before that the card's nvidia-smi
line.  A failed check is printed as ``FAILED ...`` where it happens and
makes ``ok`` false and the exit code 1.  Without a CUDA device the script
exits nonzero at once.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import itertools
import json
import math
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:   # appended: a tool that loads this file keeps its own checkout first
    sys.path.append(str(ROOT))
sys.path.append(str(ROOT / "tests"))
from cuda_common import (  # noqa: E402
    CLOUD_HW, CLOUD_K, COARSE_KERNELS, KERNELS, MERGE_TOL, OCC_HW, OCC_K, OCC_MPPB,
    PATH_KERNELS, POSE_B, POSE_HW, SF_B, SF_HW, SF_K, SIM_TOL, TEX_HW, TEX_K, THR_ACT,
    batch8_cams, bench_loss, cloud_scene, cloud_step, equal_select, fitting_step, grad_err,
    main_path, occlusion_scene, scene, seeded, shapefit_scene, sim_grad_err, stage_inputs,
    texture_chain, texture_scene,
)
from portbench import roofline  # noqa: E402

OUT_DIR = ROOT / "chiprun_out"
# Operation counts behind the bounds that portbench/roofline.py does not
# hold, per unit of work: one (block, Gaussian) cone test of K2's global
# entry (its own overhead, printed beside its bound and never counted into
# it); a slot's chain rule on the Gaussian's side alone (the per-Gaussian
# half); K1 per Gaussian (projection 15, the rotated 2x2 block 108, radii and
# window 40, plus ~5 per bin-axis test and ~10 per window cell); a global
# member's bits in one supertile (4 origins, 8 bounds, 12 tests).
CULL_FLOPS, SLOT_GAUSS_FLOPS, EMIT_FLOPS, GLOBAL_FLOPS = 28, 110, 163, 24
L2_BYTES = 50 << 20  # the H100's L2


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---- measurement ---------------------------------------------------------------

@contextmanager
def recorded(failures, what):
    """Run the block; a check that fails in it (an AssertionError, or a
    RuntimeError such as a plain version run on a main path) is printed and
    added to ``failures`` rather than raised, so that the table is printed
    whole and the last line says ``"ok": false``."""
    try:
        yield
    except (AssertionError, RuntimeError) as e:
        failures.append(f"{what}: {e}")
        print(f"FAILED {what}: {e}")


def hold_plain(name, got, want):
    """Kernel ``name``'s result against its plain version's on the same
    inputs, as ``tests/test_torch_cuda*.py`` hold it: the coarse stage's
    kernels equal to the bit; K2's entries by ``equal_select``; K3f within
    MERGE_TOL; the grouping's run starts and the valid prefix of its order
    equal to the bit; the backward kernels by ``grad_err`` (GRAD_TOL of the
    plain version's largest entry), tensor by tensor."""
    if name in COARSE_KERNELS:
        assert all(a is b is None or (a.dtype == b.dtype and torch.equal(a, b))
                   for a, b in zip(got, want)), "not equal to the bit"
    elif name.startswith("fine_select"):
        equal_select(got, want)
    elif name == "attr_merge":
        e = (got - want).abs().max().item()
        assert e <= MERGE_TOL, f"kernel vs plain {e:.3e}"
    elif name == "slot_runs":
        (order, starts), (p_order, p_starts) = got, want
        v = int(p_starts[-1])
        assert torch.equal(starts, p_starts) and torch.equal(order[:v], p_order[:v]), \
            "not the plain version's grouping"
    else:
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        for a, b in pairs:
            assert (a is None) == (b is None), "an output is None on one side only"
            if b is not None:
                grad_err(a, b, name)


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


def on_device(ev):
    """A profiler event of work on the card: a kernel, memset or copy, not a
    user-annotated range (an optimizer's step is traced as the span of its
    kernels on the device timeline, which counts them, and the gaps between
    them, twice).  Fails where the profiler does not mark such ranges, rather
    than count them."""
    if ev.device_type != torch.autograd.DeviceType.CUDA:
        return False
    if not hasattr(ev, "is_user_annotation"):
        raise RuntimeError("the profiler's events do not mark user-annotated ranges: "
                           "device totals would count them on top of their kernels")
    return not ev.is_user_annotation


def _profiled(fn, n):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_ms(fn, n):
    """Device milliseconds a call of ``fn`` (its kernels and memsets), from a
    torch.profiler trace of ``n`` calls: what the wrapper's host work hides
    when back-to-back calls outrun the card."""
    return sum(ev.self_device_time_total for ev in _profiled(fn, n) if on_device(ev)) / 1e3 / n


def device_breakdown(fn, n, path, top=8):
    """Device milliseconds a call of ``fn`` and its ``top`` heaviest device
    events by name, per call, from a torch.profiler trace of ``n`` calls;
    the trace's table goes to ``OUT_DIR / path``."""
    events = _profiled(fn, n)
    kinds = {ev.key: ev.self_device_time_total / 1e3 / n for ev in events if on_device(ev)}
    (OUT_DIR / path).write_text(events.table(sort_by="self_device_time_total", row_limit=40))
    return sum(kinds.values()), dict(sorted(kinds.items(), key=lambda kv: -kv[1])[:top])


def launch_profile(fn, n):
    """Per call of ``fn``, from a torch.profiler trace of ``n`` calls: device
    ms, kernel launches, memsets, device-to-host copies (host reads) and
    host-to-device copies."""
    out = dict(device_ms=0.0, kernels=0, memsets=0, host_reads=0, host_writes=0)
    for ev in _profiled(fn, n):
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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def past_l2(fn, *args):
    """``fn`` over copies of ``args`` in turn, enough that together they
    exceed the L2 twice, so that a call finds its inputs in DRAM (back-to-back
    calls on one input small enough to stay in the L2 read it from there)."""
    n = max(1, -(-2 * L2_BYTES // nbytes(*(a for a in args if torch.is_tensor(a)))))
    sets = itertools.cycle([args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                                     for _ in range(n - 1)])
    return lambda: fn(*next(sets))


def bound(n_bytes, flops):
    """(the least milliseconds the card could take by ``roofline.bound_ms``,
    what bounds it)."""
    by_bytes = n_bytes / roofline.HBM_BYTES_S >= flops / roofline.FP32_FLOP_S
    return roofline.bound_ms(n_bytes, flops), "bytes" if by_bytes else "operations"


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


def cull_stats(rays, table, bin_size):
    """What K2's global entry (no bits plane) does on these inputs, counted
    with the plain versions of its glue: (blocks, (block, Gaussian) pairs,
    of them culled, (ray, Gaussian) pairs left for the hit test, of them
    passing).  A culled pair never passes (the proof in
    ``csrc/fine_select.cu``), so the last count is every passing pair."""
    from voge_tpu_torch.ops import cuda_fine as cf

    B = rays.shape[0]
    P = table.shape[0] // B
    th, tw = cf.global_tile(False, bin_size)
    cones, rows = cf.block_cones_plain(rays, th, tw), cf.cull_rows_plain(table, THR_ACT)
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
                passing += int((act < THR_ACT).sum())
    return dict(blocks=cones.shape[0], block_pairs=cones.shape[0] * P, culled=culled,
                culled_share=culled / (cones.shape[0] * P), tested_pairs=tested,
                passing_pairs=passing)


# ---- 1. the card and the build ---------------------------------------------------

def build_report(details):
    """The card, the kernels built in this run side by side, their ptxas
    reports; K2's resident blocks an SM by K."""
    from voge_tpu_torch import _build

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
    details["build_s"] = build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s wall, in parallel: " + ", ".join(
        f"{k} {v[0]:.1f} s" for k, v in _build.build_info.items()))
    ptxas = "\n".join(f"== {k}\n{v[1]}" for k, v in _build.build_info.items())
    (OUT_DIR / "ptxas.txt").write_text(ptxas)
    for line in ptxas.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    def report(lib, kname):
        lines = _build.build_info[lib][1].splitlines()
        at = next(i for i, line in enumerate(lines) if kname in line and "Compiling" in line)
        return " ".join(x.strip() for x in lines[at + 2:at + 4])

    # K2's four instantiations (compacted 0, global 1, lists 2, masked 3): one
    # code path at every K, the top-K in K KB of dynamic shared memory beside
    # 18.6 KB of staging, so the resident blocks an SM follow from K and the
    # registers
    details["ptxas_k2"] = {}
    k2_regs = 0
    for mode, tag in ((0, "compacted"), (1, "global"), (2, "lists"), (3, "masked")):
        details["ptxas_k2"][tag] = rep = report("fine_select", f"fine_select_kernelILi{mode}E")
        print(f"ptxas K2 {tag}: {rep}")
        k2_regs = max(k2_regs, int(re.search(r"Used (\d+) registers", rep).group(1)))
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
        details["ptxas_k3"][kname] = rep = report(lib, kname)
        print(f"ptxas K3 {kname}: {rep}")


# ---- the table's inputs ---------------------------------------------------------

def table_inputs(dev):
    """Each main path's scene and each kernel row's arguments on it."""
    import voge_tpu_torch as vt
    from voge_tpu_torch.aggregation import expend_sigma
    from voge_tpu_torch.ops import coarse, fine
    from voge_tpu_torch.ops.cuda_fine import fine_select, fine_select_bins, fine_select_global
    from voge_tpu_torch.ops.cuda_fine_bwd import fold_weights
    from voge_tpu_torch.rays import camera_rays

    s = {}
    # the headline: the 10K cuboid at 256x256, K = 20, colours
    g, cams, colors = scene(10000, (256, 256), 300.0, dev)
    rays, points, isig = stage_inputs(g, cams, (256, 256))
    c = fine.compact_candidates(*cams, points, isig, (256, 256), 0.01, 20)
    k2 = (rays, fine.feature_table(points, isig), c.bits_c, c.ids_c, c.counts_c,
          c.thr_act, 20, c.bin_size, 1.0, colors)
    sel = fine_select(*k2)
    g_cot = [seeded(sel[1].shape, dev, 10 + q) for q in range(4)]
    s.update(head=(g, cams, colors), head_stage=(rays, points, isig), k2=k2,
             k3=(sel[0], sel[4], colors), fold=(*sel[1:5], g_cot[3], 1.0),
             k3b=(rays, fine.feature_table(points, isig), *sel[:5], *g_cot, 1.0, colors,
                  seeded(rays.shape, dev, 20), False),
             k4b=(sel[0], sel[4], colors, seeded(sel[0].shape[:-1] + (3,), dev, 30)))
    # K2's per-bin-list entry on rasterize_coarse's lists, no bin truncated
    bs_h, mppb_h = coarse.coarse_bin_config((256, 256), 20, points.shape[1])
    bp_h, cnt_h = vt.ops.rasterize_coarse(*cams, points, isig, (256, 256), 0.01, bs_h, mppb_h,
                                          return_counts=True)
    if int(cnt_h.max()) > mppb_h:
        mppb_h = int(cnt_h.max())
        bp_h = vt.ops.rasterize_coarse(*cams, points, isig, (256, 256), 0.01, bs_h, mppb_h)
    s["k2b"] = (rays, fine.feature_table(points, isig), bp_h, THR_ACT, 20, bs_h)
    s["bins"] = (bs_h, mppb_h)

    # the ShapeFitting shapes: K2's and K3's global entries
    verts_sf, isig_sf, colors_sf, cams_sf, targets_sf = shapefit_scene(dev)
    rays_sf, origins_sf = camera_rays(*cams_sf, SF_HW)
    P_sf = verts_sf.shape[0]
    isig3 = (2.0 * expend_sigma(isig_sf))[None].expand(SF_B, P_sf, 3, 3)
    table_sf = fine.feature_table(verts_sf[None] - origins_sf[:, None, :], isig3)
    bs_sf, _ = fine.production_bin_geometry(SF_HW, SF_K, P_sf, None, -1)
    s["k2g"] = (rays_sf, table_sf, None, THR_ACT, SF_K, bs_sf, 1.0)
    sel_sf = fine_select_global(*s["k2g"])
    g_sf = [seeded(sel_sf[1].shape, dev, 50 + q) for q in range(4)]
    s["k3g"] = (rays_sf, table_sf, *sel_sf, None, None, None, g_sf[3], 1.0, False)
    s["sf"] = (verts_sf, isig_sf, colors_sf, cams_sf, targets_sf)

    # the texture shapes: the render at K = 80 and the sampler's inputs
    verts_tx, isig_tx, cams_tx, image_tx = texture_scene(dev)
    N_tx = verts_tx.shape[0]
    ctx_tx = vt.precompute_camera_ctx(*cams_tx, TEX_HW, N_tx, max_assign=TEX_K)
    frag_tx = vt.render_pipeline(verts_tx, isig_tx, *cams_tx, image_size=TEX_HW,
                                 max_assign=TEX_K, cam_ctx=ctx_tx)
    idx_tx, w_tx = frag_tx.vert_index, frag_tx.vert_weight
    aug_tx = torch.cat([image_tx, torch.ones_like(image_tx[..., :1])], dim=-1).contiguous()
    g_aug = seeded((N_tx, 4), dev, 60)
    rays_tx, origins_tx = camera_rays(*cams_tx, TEX_HW)
    points_tx = verts_tx[None] - origins_tx[:, None, :]
    isg_tx = 2.0 * expend_sigma(isig_tx)[None]
    c_tx = fine.compact_candidates(*cams_tx, points_tx, isg_tx, TEX_HW, 0.01, TEX_K)
    s.update(tex=(verts_tx, isig_tx, cams_tx, image_tx, ctx_tx), frag_tx=frag_tx,
             tex_stage=(cams_tx, points_tx, isg_tx),
             scatter=(idx_tx, w_tx, aug_tx, N_tx), dw=(idx_tx, g_aug, aug_tx),
             k2tx=(rays_tx, fine.feature_table(points_tx, isg_tx), c_tx.bits_c,
                   c_tx.ids_c, c_tx.counts_c, c_tx.thr_act, TEX_K, c_tx.bin_size, 1.0, None))
    idx_h, w_h, colors_h = s["k3"]
    g_h = s["k4b"][3]
    s["attr_shapes"] = {
        "headline": ((idx_h, w_h, colors_h), (idx_h, colors_h, g_h), (idx_h, w_h, colors_h, g_h)),
        "texture": ((idx_tx, w_tx, g_aug), s["dw"], (idx_tx, w_tx, g_aug, aug_tx)),
    }

    # the 300,000-point cloud, no coarse stage: K2's global entry, the
    # halves' inputs with only g_w set (the step's), K3's unified entry
    verts_c, isig_c, cams_c = cloud_scene(300_000, dev)
    rays_c, origins_c = camera_rays(*cams_c, CLOUD_HW)
    points_c = verts_c[None] - origins_c[:, None, :]
    isg_c = (2.0 * expend_sigma(isig_c))[None]
    table_c = fine.feature_table(points_c, isg_c)
    bs_c, _ = fine.production_bin_geometry(CLOUD_HW, CLOUD_K, verts_c.shape[0], None, -1)
    s["k2c"] = (rays_c, table_c, None, THR_ACT, CLOUD_K, bs_c, 1.0)
    sel_c = fine_select_global(*s["k2c"])
    g_c = [seeded(sel_c[1].shape, dev, 90 + q) for q in range(4)]
    s["halves"] = (rays_c, table_c, sel_c[0], sel_c[1], sel_c[3],
                   *fold_weights(sel_c[1], sel_c[2], sel_c[3], sel_c[4], g_c[3], 1.0))
    s["k3c"] = (rays_c, table_c, *sel_c, None, None, None, g_c[3], 1.0, True)
    s["cloud"] = (verts_c, isig_c, cams_c, isg_c)

    # the 100,000-point cloud with its coarse stage
    verts_p, isig_p, cams_p = cloud_scene(100_000, dev)
    ctx_p = vt.precompute_camera_ctx(*cams_p, CLOUD_HW, verts_p.shape[0], max_assign=CLOUD_K)
    points_p = verts_p[None] - ctx_p.origins[:, None, :]
    isg_p = (2.0 * expend_sigma(isig_p))[None]
    c_p = fine.compact_candidates(*cams_p, points_p, isg_p, CLOUD_HW, 0.01, CLOUD_K)
    s["k2p"] = (ctx_p.rays, fine.feature_table(points_p, isg_p), c_p.bits_c,
                c_p.ids_c, c_p.counts_c, c_p.thr_act, CLOUD_K, c_p.bin_size, 1.0, None)
    s["c100"] = (verts_p, isig_p, cams_p, ctx_p)
    torch.cuda.synchronize()
    return s


# ---- 2. launches by main path ---------------------------------------------------

def path_launches(dev, s, details):
    """One call of each main path under ``main_path``: the plain versions
    made to raise, each kernel the path needs (``PATH_KERNELS``) launched,
    and the launches of each kernel wrapper (``launch.<name>``) by path and
    in all."""
    import voge_tpu_torch as vt
    from voge_tpu_torch.ops import fine
    from voge_tpu_torch.rays import camera_rays

    g, cams, colors = s["head"]
    rays_h, points_h, isig_h = s["head_stage"]
    ctx = vt.precompute_camera_ctx(*cams, (256, 256), g.verts.shape[0], max_assign=20)
    verts_sf, isig_sf, colors_sf, cams_sf, targets_sf = s["sf"]
    verts_tx, isig_tx, cams_tx, image_tx, ctx_tx = s["tex"]
    verts_c, isig_c, cams_c, isg_c = s["cloud"]
    verts_p, isig_p, cams_p, ctx_p = s["c100"]
    bs_h, mppb_h = s["bins"]

    def fitting_step_():
        _, loss, params = fitting_step(g, cams, colors, (256, 256), ctx)
        torch.autograd.grad(loss, params)

    def white_background_step():
        cam = vt.PerspectiveCameras(focal_length=300.0, principal_point=((128.0, 128.0),),
                                    image_size=((256, 256),), device=dev)
        rend = vt.GaussianRenderer(cam, vt.GaussianRenderSettings(image_size=(256, 256)))
        cols = colors.detach().requires_grad_(True)
        img = vt.to_white_background(rend(g, R=cams[0], T=cams[1]), cols)
        torch.autograd.grad(((img - 0.5) ** 2).mean(), (g.verts, cols))

    def shapefit_step():
        fitter = vt.ShapeFitter({"verts": verts_sf, "colors": colors_sf}, {"sigmas": isig_sf},
                                image_size=SF_HW, focal=cams_sf[2][0], principal=cams_sf[3][0],
                                max_assign=SF_K, device=dev)
        fitter.step(cams_sf[0], cams_sf[1], *targets_sf)

    def texture_chain_():
        texture_chain(verts_tx, isig_tx, cams_tx, image_tx, ctx_tx)

    def sampler_backward():
        frag = s["frag_tx"]
        w = frag.vert_weight.detach().clone().requires_grad_(True)
        img = image_tx.clone().requires_grad_(True)
        feat, wsum = vt.sample_features(
            vt.Fragments(w, frag.vert_index, frag.valid_num, frag.vert_hit_length), img,
            n_vert=verts_tx.shape[0])
        torch.autograd.grad(feat.sum() + wsum.sum(), (w, img))

    def two_stage_step():
        bp = vt.ops.rasterize_coarse(*cams, points_h, isig_h, (256, 256), 0.01, bs_h, mppb_h)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (points_h.reshape(-1, 3), isig_h.reshape(-1, 3, 3), rays_h)]
        sel = vt.ops.ray_tracing_fine(*leaves, bp, 0.01, bs_h, 20)
        torch.autograd.grad(sel[1].sum() + sel[2].sum() + sel[3].sum(), leaves)

    def cloud_100k_forward():
        vt.render_pipeline(verts_p, isig_p, *cams_p, image_size=CLOUD_HW, max_assign=CLOUD_K,
                           cam_ctx=ctx_p)

    def cloud_300k_step():
        _, loss, leaves = cloud_step(verts_c, isig_c, cams_c, ((verts_c + 1) / 2).contiguous())
        torch.autograd.grad(loss, leaves)

    def frozen_300k_step():
        Rl = cams_c[0].detach().clone().requires_grad_(True)
        r, o = camera_rays(Rl, cams_c[1], cams_c[2], cams_c[3], CLOUD_HW)
        sel, _ = fine.ray_tracing((Rl, cams_c[1], cams_c[2], cams_c[3]),
                                  (verts_c[None] - o[:, None, :]).detach(), isg_c, r, CLOUD_HW,
                                  0.01, CLOUD_K, max_points_per_bin=-1)
        torch.autograd.grad((sel[4].sum(-1).clamp(max=1.0) ** 2).mean(), (Rl,))

    def pose_score_and_refine():
        R, T = vt.look_at_view_transform(dist=[6.0] * POSE_B, elev=list(np.linspace(5, 25, POSE_B)),
                                         azim=list(np.linspace(50, 90, POSE_B)), device=dev)
        scorer = vt.PoseHypothesisScorer(g.verts.detach(), g.sigmas.detach(), colors, focal=300.0,
                                         principal=(128.0, 128.0), image_size=POSE_HW,
                                         max_assign=20, chunk=POSE_B, device=dev)
        with torch.no_grad():
            target = scorer.render_features(R[3:4], T[3:4])[0][0]
        scorer.score(R, T, target)
        vt.refine_pose(scorer, target, (6.0, math.radians(12.0), math.radians(64.0), 0.0),
                       steps=1, lr=0.01)

    def pose_refine_batch():
        R, T = vt.look_at_view_transform(dist=[6.0] * POSE_B, elev=list(np.linspace(5, 25, POSE_B)),
                                         azim=list(np.linspace(50, 90, POSE_B)), device=dev)
        feats = seeded((g.verts.shape[0], 128), dev, 115)
        scorer = vt.PoseHypothesisScorer(g.verts.detach(), g.sigmas.detach(),
                                         feats / torch.linalg.norm(feats, dim=-1, keepdim=True),
                                         focal=300.0, principal=(128.0, 128.0),
                                         image_size=POSE_HW, max_assign=20, chunk=POSE_B,
                                         device=dev)
        with torch.no_grad():
            targets = scorer.render_features(R, T)[0]
        init = torch.tensor([[6.2, math.radians(e + 3.0), math.radians(a - 6.0), 0.05]
                             for e, a in zip(np.linspace(5, 25, POSE_B),
                                             np.linspace(50, 90, POSE_B))], device=dev)
        vt.refine_pose(scorer, targets, init, steps=1, lr=0.02)

    def occlusion_step():
        verts, sig, col, cams_o = occlusion_scene(dev)
        leaves = [x.detach().requires_grad_(True) for x in (verts, sig, col)]
        frag = vt.render_pipeline(leaves[0], leaves[1], *cams_o, image_size=OCC_HW,
                                  max_assign=OCC_K, max_point_per_bin=OCC_MPPB)
        img = vt.interpolate_attr(frag, leaves[2])
        torch.autograd.grad(((img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean(),
                            leaves)

    def batch8_step():
        leaves = [x.detach().requires_grad_(True) for x in (g.verts, g.sigmas, colors)]
        frag = vt.render_pipeline(leaves[0], leaves[1], *batch8_cams(dev), image_size=(256, 256),
                                  max_assign=20, attrs=leaves[2])
        torch.autograd.grad(bench_loss(frag), leaves)

    paths = {"fitting_step": fitting_step_, "white_background_step": white_background_step,
             "shapefit_step": shapefit_step, "texture_chain": texture_chain_,
             "sampler_backward": sampler_backward, "two_stage_step": two_stage_step,
             "cloud_100k_forward": cloud_100k_forward, "cloud_300k_step": cloud_300k_step,
             "frozen_300k_step": frozen_300k_step, "pose_score_and_refine": pose_score_and_refine,
             "pose_refine_batch": pose_refine_batch, "occlusion_step": occlusion_step,
             "batch8_step": batch8_step}
    if paths.keys() != PATH_KERNELS.keys():
        raise RuntimeError("chip_smoke: the paths are not cuda_common.PATH_KERNELS'")
    by_path, total = {}, dict.fromkeys(KERNELS, 0)
    for name, fn in paths.items():
        counts = {}
        with recorded(details["failures"], f"main path {name}"):
            with main_path(PATH_KERNELS[name], kernels_only=True) as counts:
                fn()
        counts = {k: v for k, v in counts.items() if v}
        by_path[name] = counts
        for k in total:
            total[k] += counts.get(k, 0)
        print(f"launches, {name}: " + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())))
    details["launches_by_path"] = by_path
    return total


# ---- 3. the kernel table --------------------------------------------------------

def merge_bound(idx, w, attrs):
    """K3f's bound: the ids read whole, the weights of the valid slots (no
    other weight is needed), the attribute rows, the image written; 2 d
    operations a valid slot."""
    n_rows, d = attrs.shape
    valid = int(((idx >= 0) & (idx < n_rows)).sum())
    return bound(nbytes(idx, attrs) + valid * 4 + idx.numel() // idx.shape[-1] * d * 4,
                 valid * 2 * d)


def dw_bound(idx, attrs, g):
    """``attr_dw``'s bound: the ids read and d_w written whole, the attribute
    rows, and the g rows of the pixels that hold a valid slot (no other row
    is needed); 2 d operations a valid slot."""
    n_rows, d = attrs.shape
    ok = (idx >= 0) & (idx < n_rows)
    return bound(2 * nbytes(idx) + nbytes(attrs) + int(ok.any(-1).sum()) * d * 4,
                 int(ok.sum()) * 2 * d)


def attr_rows_at_shapes(shapes):
    """Rows 3 (K3f), 12 (attr_dw) and 10 (K4b) at each of ``shapes`` (tag ->
    (merge args, dw args, K4b args)): CUDA-event ms, device ms on the same
    inputs call after call and with the inputs past the L2 (``past_l2``),
    host µs a call, the plain version's ms, and the bound (``merge_bound``,
    ``dw_bound``; K4b's: its inputs read once and its outputs written once,
    4 d operations a valid slot)."""
    from voge_tpu_torch.ops.cuda_attr import (
        attr_dw, attr_dw_plain, attr_merge, attr_merge_bwd, attr_merge_bwd_plain, attr_merge_plain,
    )

    out = {"attr_merge": {}, "attr_dw": {}, "attr_merge_bwd": {}}
    for tag, (m_args, d_args, b_args) in shapes.items():
        idx, attrs = m_args[0], m_args[2]
        b_valid, _ = slot_counts(b_args[0])
        rows = {
            "attr_merge": (attr_merge, attr_merge_plain, m_args, merge_bound(*m_args)),
            "attr_dw": (attr_dw, attr_dw_plain, d_args, dw_bound(*d_args)),
            "attr_merge_bwd": (attr_merge_bwd, attr_merge_bwd_plain, b_args,
                               bound(nbytes(*b_args) + nbytes(b_args[1], b_args[2]),
                                     b_valid * 4 * b_args[2].shape[1])),
        }
        for name, (kfn, pfn, args, (b_ms, b_by)) in rows.items():
            call = lambda: kfn(*args)
            r = dict(ms=cuda_ms(call, 50), device_ms=device_ms(call, 20),
                     device_ms_past_l2=device_ms(past_l2(kfn, *args), 20),
                     host_us=host_us(call), plain_ms=cuda_ms(lambda: pfn(*args), 5),
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


SIM_SHAPE = (32, 256, 256, 128)         # cuboid10k.score32's stack: 32 poses, 128 features


def similarity_row(dev, failures):
    """The similarity kernel at pose scoring's shape, a stack against one
    target map expanded (batch stride 0): its CUDA-event and device ms,
    device ms with the inputs past the L2 (two stacks, and targets that
    together exceed the L2 twice, in turn: back to back on one input, the
    33.5 MB target stays in the 50 MB L2 while the stack streams past it with
    evict-first loads, so the share can read over 100%; in pose scoring the
    merge's 1.07 GB write evicts it between calls), host µs a call, its bound
    (the stack and the target read once, B floats written; 4 operations a
    (batch, pixel, channel), 2 a (pixel, channel) of the target), the plain
    version's ms (the nine PyTorch passes), and
    ``cosine_similarity(...).mean((1, 2))``'s as the library yardstick (the
    port never calls it), with its distance from the kernel's result."""
    from voge_tpu_torch.ops.cuda_similarity import feature_similarity, feature_similarity_plain

    B, H, W, C = SIM_SHAPE
    g = torch.Generator(dev).manual_seed(19)
    target = torch.randn((H, W, C), generator=g, device=dev)
    pred = 0.8 * target + torch.randn(SIM_SHAPE, generator=g, device=dev)
    tx = target.expand(SIM_SHAPE)
    with recorded(failures, "kernel feature_similarity against its plain version"):
        got = feature_similarity(pred, tx)
        want = feature_similarity_plain(pred.double(), target.double().expand(SIM_SHAPE))
        assert torch.equal(got, feature_similarity(pred, tx)), "two runs differ"
        e = (got.double() - want).abs().max().item()
        assert e <= SIM_TOL, f"kernel vs plain in float64 {e:.3e}"
        del want
    library = lambda: torch.nn.functional.cosine_similarity(pred, tx, dim=-1).mean((1, 2))
    e_lib = (library() - feature_similarity(pred, tx)).abs().max().item()
    call = lambda: feature_similarity(pred, tx)
    stacks = [pred, pred.clone()]
    targets = [tx] + [target.clone().expand(SIM_SHAPE)
                      for _ in range(-(-2 * L2_BYTES // nbytes(target)) - 1)]
    turn = itertools.count()

    def call_past_l2():
        i = next(turn)
        return feature_similarity(stacks[i % len(stacks)], targets[i % len(targets)])

    b_ms, b_by = bound(nbytes(pred, target) + B * 4, B * H * W * C * 4 + H * W * C * 2)
    r = dict(ms=cuda_ms(call, 50), device_ms=device_ms(call, 20),
             device_ms_past_l2=device_ms(call_past_l2, 24), host_us=host_us(call),
             plain_ms=cuda_ms(lambda: feature_similarity_plain(pred, tx), 5),
             library_ms=cuda_ms(library, 5), bound_ms=b_ms, bound_by=b_by, library_gap=e_lib)
    del stacks, targets
    print(f"kernel feature_similarity at score32's shape {SIM_SHAPE} (target batch stride 0): "
          f"{r['ms']:.5f} ms (device {r['device_ms']:.5f}, past the L2 "
          f"{r['device_ms_past_l2']:.5f}, host {r['host_us']:.2f} us a call), plain "
          f"{r['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by {b_by} (share {b_ms / r['ms']:.4f} "
          f"event, {b_ms / r['device_ms']:.4f} device, {b_ms / r['device_ms_past_l2']:.4f} "
          f"device past the L2), library {r['library_ms']:.4f} ms (vs the kernel {e_lib:.3e})")
    return r


def similarity_grad_row(dev, failures):
    """Row 14b: the similarity gradient's kernel at pose refinement's shape
    (``cuboid10k.refine_b32``: a stack of 32 images against a target each),
    against the gradient of ``-sim.sum()`` (one value expanded): held to
    autograd of the plain version in float64 (``sim_grad_err``), two calls
    equal to the bit; its CUDA-event and device ms (its 3.2 GB pass the L2
    on every call), host µs a call, its bound (the stack and the targets
    read once, the cotangent written once; 9 operations a (batch, pixel,
    channel)), the plain version's ms (autograd's backward of the
    expression, its graph kept), and autograd's backward of
    ``cosine_similarity(...).mean((1, 2))`` as the library yardstick (the
    port never calls it); then row 14c (``similarity_scalar_row``)."""
    from voge_tpu_torch.ops.cuda_similarity import (
        feature_similarity_grad, feature_similarity_grad_plain, feature_similarity_plain,
    )

    B, H, W, C = SIM_SHAPE
    g = torch.Generator(dev).manual_seed(23)
    target = torch.randn(SIM_SHAPE, generator=g, device=dev)
    pred = 0.8 * target + torch.randn(SIM_SHAPE, generator=g, device=dev)
    grad = torch.tensor(-1.0, device=dev).expand(B)
    e = None
    with recorded(failures, "kernel feature_similarity_grad against autograd of its plain version"):
        got = feature_similarity_grad(pred, target, grad)
        assert torch.equal(got, feature_similarity_grad(pred, target, grad)), "two runs differ"
        want = feature_similarity_grad_plain(pred.double(), target.double(), grad.double())
        e = sim_grad_err(got, want, pred, grad, "feature_similarity_grad")
        del got, want

    def backward_of(fn):
        p = pred.detach().requires_grad_(True)
        out = fn(p)
        return lambda: torch.autograd.grad(out, p, grad, retain_graph=True)

    call = lambda: feature_similarity_grad(pred, target, grad)
    b_ms, b_by = bound(3 * nbytes(pred) + 4, B * H * W * C * 9)
    r = dict(ms=cuda_ms(call, 20), device_ms=device_ms(call, 10), host_us=host_us(call, 50),
             bound_ms=b_ms, bound_by=b_by, err=e)
    r["plain_ms"] = cuda_ms(backward_of(lambda p: feature_similarity_plain(p, target)), 5)
    r["library_ms"] = cuda_ms(backward_of(lambda p: torch.nn.functional.cosine_similarity(
        p, target, dim=-1).mean((1, 2))), 5)
    print(f"kernel feature_similarity_grad at refine_b32's shape {SIM_SHAPE} (a target an "
          f"image): {r['ms']:.5f} ms (device {r['device_ms']:.5f}, host {r['host_us']:.2f} us a "
          f"call), plain {r['plain_ms']:.4f} ms (autograd's backward), bound {b_ms:.5f} ms by "
          f"{b_by} (share {b_ms / r['ms']:.4f} event, {b_ms / r['device_ms']:.4f} device), "
          f"library {r['library_ms']:.4f} ms (autograd of cosine_similarity), against float64 "
          + ("not held" if e is None else f"{e:.3e} of a row's scale"))
    r["scalar"] = similarity_scalar_row(dev, failures)
    return r


SIM_SCALAR_SHAPE = (1, *POSE_HW, 3)     # the pose path's scalar refine_pose: 3 colour channels


def similarity_scalar_row(dev, failures):
    """Row 14c: the similarity's forward and its gradient's lane-loop kernel
    (C = 3 takes ``cos_grad_lanes_kernel``) at the pose path's scalar
    ``refine_pose``: one image of 3 channels against its target, rendered
    features' range with background rows (all zero) in each, the gradient
    of ``-sim.sum()`` through the public function as the refinement takes
    it.  Each held to its plain version in float64 (``SIM_TOL``,
    ``sim_grad_err``), two calls equal to the bit, one launch each; the
    gradient's CUDA-event and device ms against its bound (launch-bound at
    this size)."""
    from voge_tpu_torch import trace
    from voge_tpu_torch.ops.cuda_similarity import (
        feature_similarity, feature_similarity_grad, feature_similarity_grad_plain,
        feature_similarity_plain,
    )

    B, H, W, C = SIM_SCALAR_SHAPE
    g = torch.Generator(dev).manual_seed(29)
    target = torch.rand(SIM_SCALAR_SHAPE, generator=g, device=dev)
    pred = (target + 0.05 * torch.randn(SIM_SCALAR_SHAPE, generator=g, device=dev)).clamp(min=0)
    target[:, : H // 4] = 0                # background of the target alone
    pred[:, H // 4: H // 2] = 0            # of the render alone
    pred[:, -H // 8:] = 0                  # of both
    target[:, -H // 8:] = 0
    grad = torch.tensor(-1.0, device=dev).expand(B)

    def refine_grad():
        p = pred.detach().requires_grad_(True)
        return torch.autograd.grad(-feature_similarity(p, target).sum(), p)[0]

    e = e_fwd = None
    with recorded(failures, "kernels feature_similarity and feature_similarity_grad at the "
                            "scalar refine's shape against their plain versions"):
        with trace.tracing():
            sim, got = feature_similarity(pred, target), refine_grad()
            torch.cuda.synchronize()
            counts = trace.counts()
        assert counts.get("launch.feature_similarity") == 2 \
            and counts.get("launch.feature_similarity_grad") == 1, counts
        assert torch.equal(sim, feature_similarity(pred, target)), "two forward runs differ"
        assert torch.equal(got, refine_grad()), "two gradient runs differ"
        e_fwd = (sim.double() - feature_similarity_plain(pred.double(), target.double())) \
            .abs().max().item()
        assert e_fwd <= SIM_TOL, f"forward vs plain in float64 {e_fwd:.3e}"
        want = feature_similarity_grad_plain(pred.double(), target.double(), grad.double())
        e = sim_grad_err(got, want, pred, grad, "feature_similarity_grad (scalar refine)")

    call = lambda: feature_similarity_grad(pred, target, grad)
    b_ms, b_by = bound(3 * nbytes(pred) + 4, B * H * W * C * 9)
    r = dict(ms=cuda_ms(call, 50), device_ms=device_ms(call, 20), host_us=host_us(call, 50),
             bound_ms=b_ms, bound_by=b_by, err=e, fwd_err=e_fwd)
    print(f"kernel feature_similarity_grad at the scalar refine's shape {SIM_SCALAR_SHAPE} "
          f"(the lane loop): {r['ms']:.5f} ms (device {r['device_ms']:.5f}, host "
          f"{r['host_us']:.2f} us a call), bound {b_ms:.5f} ms by {b_by} (share "
          f"{b_ms / r['device_ms']:.4f} device), against float64 "
          + ("not held" if e is None else f"{e:.3e} of a row's scale, the forward {e_fwd:.3e}"))
    return r


def coarse_stage_rows(dev, s, details):
    """Row 1 and the bounds of rows 1a-1c: the coarse stage
    (``compact_candidates``) against its int64 route
    (``ops.coarse._emit_candidates_sorted`` on the same arguments) in turns,
    CUDA-event ms of back-to-back calls and from a profile the device ms,
    kernel launches, memsets and host reads a call, at the headline and the
    texture shapes; the bounds on the render's final emission (bytes of
    each input read once and each output written once), and the int64 keys
    the route sorts, for the rows kernel's library call."""
    from voge_tpu_torch.ops import coarse, fine
    from voge_tpu_torch.ops.cuda_attr import slot_runs
    from voge_tpu_torch.ops.cuda_coarse import coarse_globals, coarse_rows, emit_rows

    _, cams_h, _ = s["head"]
    _, points_h, isig_h = s["head_stage"]
    cells = {"headline": (cams_h, points_h, isig_h, (256, 256), 20),
             "texture": (*s["tex_stage"], TEX_HW, TEX_K)}
    out, held = {}, {}
    for tag, (cams, points, isig, hw, K) in cells.items():
        B, P = points.shape[:2]
        c = fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
        bs = c.bin_size
        nst, BH2, BW2, S, win0 = coarse.emission_geometry(P, hw, bs)
        staged = lambda: fine.compact_candidates(*cams, points, isig, hw, 0.01, K)
        sorted_ = lambda: coarse._emit_candidates_sorted(
            *cams, points, isig, hw, 0.01, bs, 0, 64, fine._pick_cand_chunk(P), False, win0)
        with recorded(details["failures"], f"coarse stage {tag} against its int64 route"):
            assert all(torch.equal(a, b) for a, b in zip(c[:5], sorted_()[:5])), \
                "not the int64 route's rows"
        ms = {"staged": [], "sorted": []}
        for route in ("staged", "sorted", "sorted", "staged"):
            ms[route].append(cuda_ms(staged if route == "staged" else sorted_, 20))
        prof = {"staged": launch_profile(staged, 10), "sorted": launch_profile(sorted_, 10)}
        # the kernels' arguments at the render's final emission
        win = coarse.emit_supertile_candidates(
            *cams, points, isig, hw, 0.01, bs, 0, row_align=fine._pick_cand_chunk(P),
            return_dst=True)[5][0].shape[-1]
        win = math.isqrt(win)
        k1 = (*cams, points, isig, 0.01, bs, hw, nst, BH2, BW2, win)
        em = emit_rows(*k1)
        rid, bits, planes, over, info = em
        order, starts = slot_runs(rid, B * nst)
        g_args = (over, planes, starts, info, min(64, P), nst, BW2, bs, hw)
        glob = coarse_globals(*g_args)
        r_args = (order, starts, bits, glob[0], glob[2], glob[3], c.pos_c.shape[1], nst, False)
        rows = coarse_rows(*r_args)
        n_valid, n_glob = int(starts[-1]), int(glob[1].sum())
        in_bytes = nbytes(points, isig) + B * 13 * 4
        emit_ops = B * P * (EMIT_FLOPS + 10 * win + 10 * win * win)
        glob_ops = n_glob * nst * GLOBAL_FLOPS
        bounds = dict(
            emit_rows=bound(in_bytes + nbytes(*em), emit_ops),
            coarse_globals=bound(nbytes(over, starts, info, *glob) + 16 * n_glob, glob_ops),
            coarse_rows=bound(5 * n_valid + nbytes(starts, *glob, *rows[:5]), 0.0),
            stage=bound(in_bytes + nbytes(*c[:5]), emit_ops + glob_ops))
        idx = torch.arange(P, device=dev)[:, None]
        big = B * nst * S * 16
        gpos, g_valid, bits_g, _ = glob
        kg = ((torch.arange(B * nst, device=dev).reshape(B, 1, nst) * S + gpos.long()[..., None])
              * 16 + bits_g.long())
        keys = torch.cat([torch.where(rid >= 0, (rid.long() * S + idx) * 16 + bits.long(),
                                      big).reshape(-1),
                          torch.where((bits_g != 0) & g_valid[..., None], kg, big).reshape(-1)])
        held[tag] = dict(k1=k1, glob=g_args, rows_args=r_args, bounds=bounds, keys=keys,
                         edges=torch.arange(B * nst + 1, device=dev) * (S * 16))
        b_ms, b_by = bounds["stage"]
        out[tag] = dict(ms=ms, profile=prof, bound_ms=b_ms, bound_by=b_by, windows=[win0, win],
                        rows=B * nst, width=c.pos_c.shape[1], memberships=int(c.counts_c.sum()))
        print(f"coarse stage {tag} (compact_candidates): staged {ms['staged'][0]:.4f} / "
              f"{ms['staged'][1]:.4f} ms, int64 route {ms['sorted'][0]:.4f} / "
              f"{ms['sorted'][1]:.4f} ms; bound {b_ms:.5f} ms by {b_by}; windows {win0} / {win}; "
              "a call: " + "; ".join(
                  f"{r} device {p['device_ms']:.4f} ms, kernels {p['kernels']:.1f}, memsets "
                  f"{p['memsets']:.1f}, host reads {p['host_reads']:.1f}, host writes "
                  f"{p['host_writes']:.1f}" for r, p in prof.items()))
    details["coarse_stage_ms"] = out
    return held["headline"]


def kernel_table(dev, s, launches, details):
    """PERF.md section 6's rows, one ``kernel ...`` line each; returns the
    kernels line's entries."""
    from voge_tpu_torch.ops.cuda_attr import (
        attr_dw, attr_dw_plain, attr_merge, attr_merge_bwd, attr_merge_bwd_plain,
        attr_merge_plain, attr_scatter, attr_scatter_plain, slot_runs, slot_runs_plain,
    )
    from voge_tpu_torch.ops.cuda_coarse import (
        coarse_globals, coarse_globals_plain, coarse_rows, coarse_rows_plain, emit_rows,
        emit_rows_plain,
    )
    from voge_tpu_torch.ops.cuda_fine import (
        fine_select, fine_select_bins, fine_select_bins_plain, fine_select_global,
        fine_select_global_plain, fine_select_plain,
    )
    from voge_tpu_torch.ops.cuda_fine_bwd import (
        fine_bwd, fine_bwd_gauss, fine_bwd_gauss_plain, fine_bwd_global, fine_bwd_global_plain,
        fine_bwd_plain, fine_bwd_rays, fine_bwd_rays_plain, fold_weights, fold_weights_plain,
    )

    hc = coarse_stage_rows(dev, s, details)
    k2, k3, k2g, k3g, k2b = s["k2"], s["k3"], s["k2g"], s["k3g"], s["k2b"]
    halves_c, N_tx = s["halves"], s["scatter"][3]
    per = {
        "emit_rows": (lambda: emit_rows(*hc["k1"]), lambda: emit_rows_plain(*hc["k1"])),
        "coarse_globals": (lambda: coarse_globals(*hc["glob"]),
                           lambda: coarse_globals_plain(*hc["glob"])),
        "coarse_rows": (lambda: coarse_rows(*hc["rows_args"]),
                        lambda: coarse_rows_plain(*hc["rows_args"])),
        "fine_select": (lambda: fine_select(*k2), lambda: fine_select_plain(*k2)),
        "attr_merge": (lambda: attr_merge(*k3), lambda: attr_merge_plain(*k3)),
        "fold_weights": (lambda: fold_weights(*s["fold"]), lambda: fold_weights_plain(*s["fold"])),
        "fine_bwd": (lambda: fine_bwd(*s["k3b"]), lambda: fine_bwd_plain(*s["k3b"])),
        "attr_merge_bwd": (lambda: attr_merge_bwd(*s["k4b"]),
                           lambda: attr_merge_bwd_plain(*s["k4b"])),
        "fine_select_global": (lambda: fine_select_global(*k2g),
                               lambda: fine_select_global_plain(*k2g)),
        "fine_bwd_global": (lambda: fine_bwd_global(*k3g), lambda: fine_bwd_global_plain(*k3g)),
        "attr_scatter": (lambda: attr_scatter(*s["scatter"]),
                         lambda: attr_scatter_plain(*s["scatter"])),
        "attr_dw": (lambda: attr_dw(*s["dw"]), lambda: attr_dw_plain(*s["dw"])),
        "fine_select_bins": (lambda: fine_select_bins(*k2b), lambda: fine_select_bins_plain(*k2b)),
        "fine_bwd_gauss": (lambda: fine_bwd_gauss(*halves_c),
                           lambda: fine_bwd_gauss_plain(*halves_c)),
        "fine_bwd_rays": (lambda: fine_bwd_rays(*halves_c),
                          lambda: fine_bwd_rays_plain(*halves_c)),
        "slot_runs": (lambda: slot_runs(s["scatter"][0], N_tx),
                      lambda: slot_runs_plain(s["scatter"][0], N_tx)),
    }

    # Bounds: bytes each input is read once and each output written once
    # (of candidate tables only the occupied rows), operations as counted
    # from this run's selections (portbench/roofline.py's counts).
    def select_bound(rays, n_rows_read, idx, pairs, extra_in=0, outs=5, d=0):
        valid, valid_sq = slot_counts(idx)
        n_pix, K = idx.numel() // idx.shape[-1], idx.shape[-1]
        by = nbytes(rays) + n_rows_read + extra_in + outs * n_pix * K * 4 + n_pix * d * 4
        weights = valid_sq * roofline.WEIGHT_FLOPS if outs == 5 else 0.0
        return bound(by, pairs * roofline.PAIR_FLOPS + weights + valid * 2 * d)

    def bwd_bound(rays, n_rows_read, sel, cots, rows_out, want_rays, attrs=None, g_img=None):
        valid, valid_sq = slot_counts(sel[0])
        d = 0 if attrs is None else attrs.shape[1]
        by = (nbytes(rays, *sel, *cots, attrs, g_img) + n_rows_read + rows_out * (12 + d) * 4
              + (nbytes(rays) if want_rays else 0))
        return bound(by, valid_sq * roofline.FOLD_FLOPS
                     + valid * (roofline.SLOT_BWD_FLOPS + 4 * d))

    def half_bound(halves, gauss):
        """The split backward's halves: every slot array read once, the
        feature rows of the Gaussians that hold a slot, the dense output."""
        rays, table, idx, *slots = halves
        ok = (idx >= 0) & (idx < table.shape[0])
        by = (nbytes(rays, idx, *slots) + torch.unique(idx[ok]).numel() * 64
              + (table.shape[0] * 48 if gauss else nbytes(rays)))
        return bound(by, ok.sum().item() * (SLOT_GAUSS_FLOPS if gauss else roofline.SLOT_RAY_FLOPS))

    def global_bound(args, idx, stats):
        """K2's global entry, bytes as above, operations counted two ways:
        ``all_pairs`` a hit test for every (ray, Gaussian) pair; ``needed``
        one for every pair that passes it (what the function's result
        needs), which is its bound.  ``cone_tests_ms``: this kernel's one
        cone test a (block, Gaussian) pair at the card's peak, its own
        overhead, in no bound."""
        rays, table = args[0], args[1]
        every = float(rays.numel() // 3) * (table.shape[0] // rays.shape[0])
        return dict(all_pairs=select_bound(rays, nbytes(table), idx, every),
                    needed=select_bound(rays, nbytes(table), idx, stats["passing_pairs"]),
                    cone_tests_ms=stats["block_pairs"] * CULL_FLOPS / roofline.FP32_FLOP_S * 1e3)

    culls = {}
    for tag, args in (("shapefit", k2g), ("cloud_300k", s["k2c"])):
        culls[tag] = cull_stats(args[0], args[1], args[5])
        st = culls[tag]
        print(f"K2 global {tag} cull (plain glue): {st['culled']} of {st['block_pairs']} (block, "
              f"Gaussian) pairs culled ({st['culled_share']:.5f}) over {st['blocks']} blocks; "
              f"{st['tested_pairs']} (ray, Gaussian) pairs left to test, {st['passing_pairs']} pass")
    details["cull"] = culls
    sel_h, sel_sf = fine_select(*k2), fine_select_global(*k2g)
    k3b = s["k3b"]
    idx4, w4, attrs4, g4 = s["k4b"]
    v4, _ = slot_counts(idx4)
    lists = k2b[2]
    listed = ((lists >= 0).sum(-1).double() * tile_rays(256, 256, k2b[5], k2b[5], dev)[None])
    sc_valid, _ = slot_counts(s["scatter"][0])
    bounds = {
        **{k: hc["bounds"][k] for k in COARSE_KERNELS},
        "fine_select": select_bound(
            k2[0], int(k2[4].sum()) * 72 + nbytes(k2[4], k2[9]), sel_h[0],
            compacted_pairs(k2[2], k2[4], 256, 256, k2[7]), d=k2[9].shape[1]),
        "attr_merge": merge_bound(*k3),
        "fold_weights": bound(8 * nbytes(s["fold"][0]),
                              slot_counts(sel_h[0])[1] * roofline.FOLD_FLOPS),
        "fine_bwd": bwd_bound(k3b[0], torch.unique(k3b[2][k3b[2] >= 0]).numel() * 64, k3b[2:7],
                              k3b[7:11], k3b[1].shape[0], k3b[14], k3b[12], k3b[13]),
        "attr_merge_bwd": bound(nbytes(idx4, w4, attrs4, g4) + nbytes(w4, attrs4),
                                v4 * 4 * attrs4.shape[1]),
        "fine_select_global": global_bound(k2g, sel_sf[0], culls["shapefit"])["needed"],
        "fine_bwd_global": bwd_bound(k3g[0], nbytes(k3g[1]), k3g[2:7],
                                     [c for c in k3g[7:11] if c is not None],
                                     k3g[1].shape[0], k3g[12]),
        "attr_scatter": bound(nbytes(*s["scatter"][:3]) + N_tx * 4 * 4, sc_valid * 2 * 4),
        "attr_dw": dw_bound(*s["dw"]),
        "fine_select_bins": select_bound(
            k2b[0], nbytes(k2b[1], lists), fine_select_bins(*k2b)[0], listed.sum().item(),
            outs=4),
        "fine_bwd_gauss": half_bound(halves_c, True),
        "fine_bwd_rays": half_bound(halves_c, False),
        # the grouping: idx read once, starts and the valid slots' order written once
        "slot_runs": bound(nbytes(s["scatter"][0]) + (N_tx + 1) * 8 + sc_valid * 4, 0.0),
    }

    # one PyTorch call that computes the same function, where there is one
    # (``tests/test_torch_cuda_paths.py`` holds the first two to the kernels),
    # on inputs prepared outside the timed call; the port never calls them
    idx_s, w_s, g_s, _ = s["scatter"]
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

    for name, (kfn, pfn) in per.items():
        with recorded(details["failures"], f"kernel {name} against its plain version"):
            hold_plain(name, kfn(), pfn())
    at_shapes = details["attr_rows_at_shapes"] = attr_rows_at_shapes(s["attr_shapes"])
    kern = []
    for name, (kfn, pfn) in per.items():
        ms = cuda_ms(kfn, 50)
        plain_ms = cuda_ms(pfn, 5 if name.startswith(("fine_select", "fine_bwd")) else 20)
        lib_ms = cuda_ms(library[name], 20) if name in library else None
        b_ms, b_by = bounds[name]
        dev_ms, h_us = device_ms(kfn, 10), host_us(kfn)
        print(f"kernel {name}: {ms:.4f} ms (device {dev_ms:.4f}, host {h_us:.2f} us a call), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} (share {b_ms / ms:.4f}), "
              "library " + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
              + f", launches on the main paths {launches[name]}")
        _, src, rep = KERNELS[name]
        kern.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=launches[name], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms, host_us=h_us))
        if name in at_shapes:
            kern[-1]["shapes"] = at_shapes[name]
    sim = details["similarity"] = similarity_row(dev, details["failures"])
    _, src, rep = KERNELS["feature_similarity"]
    print(f"kernel feature_similarity: launches on the main paths {launches['feature_similarity']}")
    kern.append(dict(name="feature_similarity", route="cuda", source=src, replaces=rep,
                     launches=launches["feature_similarity"],
                     **{k: sim[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                            "device_ms", "device_ms_past_l2", "host_us")}))
    sim_g = details["similarity_grad"] = similarity_grad_row(dev, details["failures"])
    _, src, rep = KERNELS["feature_similarity_grad"]
    print("kernel feature_similarity_grad: launches on the main paths "
          f"{launches['feature_similarity_grad']}")
    kern.append(dict(name="feature_similarity_grad", route="cuda", source=src, replaces=rep,
                     launches=launches["feature_similarity_grad"],
                     **{k: sim_g[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms", "device_ms", "host_us")}))
    if len(kern) != len(KERNELS):
        raise RuntimeError("chip_smoke: the kernels line does not list every entry")

    # K2's global entry and K3's unified entry at the 300K shapes (the rows
    # above take the ShapeFitting shapes), the bounds at both
    k2c, k3c = s["k2c"], s["k3c"]
    c3 = dict(select_ms=cuda_ms(lambda: fine_select_global(*k2c), 3),
              unified_bwd_ms=cuda_ms(lambda: fine_bwd_global(*k3c), 10))
    gb_c = global_bound(k2c, fine_select_global(*k2c)[0], culls["cloud_300k"])
    gb_sf = global_bound(k2g, sel_sf[0], culls["shapefit"])
    c3["select_bound_ms"], c3["select_bound_by"] = gb_c["needed"]
    c3["select_bound_all_pairs_ms"] = gb_c["all_pairs"][0]
    sf_ms = next(k["ms"] for k in kern if k["name"] == "fine_select_global")
    for tag, gb, ms in (("ShapeFitting", gb_sf, sf_ms), ("300K", gb_c, c3["select_ms"])):
        if gb["needed"][0] > ms:
            raise RuntimeError(f"chip_smoke: fine_select_global at the {tag} shapes beats "
                               "its bound: the bound is wrong")
        print(f"fine_select_global bound at the {tag} shapes: every (ray, Gaussian) pair "
              f"tested {gb['all_pairs'][0]:.5f} ms by {gb['all_pairs'][1]} (the kernel takes "
              f"{ms / gb['all_pairs'][0]:.3f} of it); the passing pairs {gb['needed'][0]:.5f} ms "
              f"by {gb['needed'][1]} (share {gb['needed'][0] / ms:.4f}); beside the bound, the "
              f"kernel's own cone tests at the card's peak {gb['cone_tests_ms']:.5f} ms")
    c3["unified_bound_ms"], c3["unified_bound_by"] = bwd_bound(
        k3c[0], nbytes(k3c[1]), k3c[2:7], [k3c[10]], k3c[1].shape[0], True)
    print(f"kernel fine_select_global at the 300K shapes: {c3['select_ms']:.3f} ms, bound "
          f"{c3['select_bound_ms']:.4f} ms by {c3['select_bound_by']} (share "
          f"{c3['select_bound_ms'] / c3['select_ms']:.4f}); fine_bwd_global there: "
          f"{c3['unified_bwd_ms']:.4f} ms, bound {c3['unified_bound_ms']:.5f} ms by "
          f"{c3['unified_bound_by']}")
    details["kernels_300k"] = c3

    # K2's compacted entry at the texture render's and the 100K cloud's shapes
    for tag, args, hw in (("texture", s["k2tx"], TEX_HW), ("100K cloud", s["k2p"], CLOUD_HW)):
        r = dict(ms=cuda_ms(lambda: fine_select(*args), 20),
                 plain_ms=cuda_ms(lambda: fine_select_plain(*args), 3))
        r["bound_ms"], r["bound_by"] = select_bound(
            args[0], int(args[4].sum()) * 72 + nbytes(args[4]), fine_select(*args)[0],
            compacted_pairs(args[2], args[4], *hw, args[7]))
        print(f"kernel fine_select at the {tag} shapes (K = {args[6]}): {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by {r['bound_by']} (share "
              f"{r['bound_ms'] / r['ms']:.4f}), library none")
        details[f"fine_select_{tag.replace(' ', '_')}"] = r

    # a frozen scene's backward at 300K as one launch with the fold fused in
    # against the fold's entry followed by the unfused per-ray launch, in turns
    rays_c, table_c = k3c[0], k3c[1]
    idx_c, len_c, act_c, dsd_c, w_c = k3c[2:7]
    g_w = k3c[10]
    frozen = (rays_c, table_c, idx_c, len_c, dsd_c, None, None, None)
    fused = lambda: fine_bwd_rays(*frozen, act=act_c, w=w_c, g_w=g_w, agg_ow=1.0)
    unfused = lambda: fine_bwd_rays(*frozen[:5], *fold_weights(len_c, act_c, dsd_c, w_c, g_w, 1.0))
    routes = {"fused": [], "fold_then_rays": []}
    for name in ("fused", "fold_then_rays", "fold_then_rays", "fused"):
        routes[name].append(cuda_ms(fused if name == "fused" else unfused, 20))
    v_c, v_sq_c = slot_counts(idx_c)
    occupied_c = torch.unique(idx_c[idx_c >= 0]).numel()
    f_ms, f_by = bound(nbytes(rays_c, idx_c, len_c, act_c, dsd_c, w_c, g_w) + occupied_c * 64
                       + nbytes(rays_c), v_sq_c * roofline.FOLD_FLOPS
                       + v_c * roofline.SLOT_RAY_FLOPS)
    prof = {"fused": launch_profile(fused, 10), "fold_then_rays": launch_profile(unfused, 10)}
    details["frozen_backward_300k"] = dict(ms=routes, bound_ms=f_ms, bound_by=f_by, profile=prof)
    print(f"frozen backward at the 300K cloud: fused {routes['fused'][0]:.4f} / "
          f"{routes['fused'][1]:.4f} ms, fold + per-ray half {routes['fold_then_rays'][0]:.4f} / "
          f"{routes['fold_then_rays'][1]:.4f} ms; bound of the fused launch {f_ms:.5f} ms by "
          f"{f_by}; a call: " + "; ".join(f"{k} device {p['device_ms']:.4f} ms, kernels "
                                          f"{p['kernels']:.1f}" for k, p in prof.items()))
    return kern


# ---- 4. paths no benchmark cell measures ----------------------------------------

# (mesh shape, model axis, ring): the replicated scene, the all-gather merge on
# two shapes, the ring; every shard on the one card
SHARD_MESHES = {"dp_2x1": ((2, 1), None, False), "gather_2x2": ((2, 2), "model", False),
                "ring_2x2": ((2, 2), "model", True), "gather_1x4": ((1, 4), "model", False)}
LK_MODES = {"coarse": (0.01, None), "no_coarse": (1e-8, -1)}   # mode -> (thr, max_point_per_bin)


def uncelled_paths(dev, s, details):
    """The K = 200 step through the dense route on the 10K cuboid at
    256x256 in both modes, and the sharded headline step (the 10K cuboid
    padded to a multiple of 4, ``bench.py:324-361``'s 8 cameras, colours
    through ``interpolate_attr_sharded``) on four meshes of the one card
    beside the single-device step: medians by ``voge_tpu_torch.timing``
    (distinct inputs, a pair of CUDA events a call), device ms by kernel
    from a profile (``chiprun_out/profile_*.txt``)."""
    import voge_tpu_torch as vt
    from voge_tpu_torch import timing
    from voge_tpu_torch.parallel import (
        interpolate_attr_sharded, make_mesh, render_pipeline_sharded,
    )

    def stats(fn, verts, n, tag, eps):
        st = timing.measure_stats(fn, args_fn=lambda i: (verts * (1.0 + eps * i),), n=n,
                                  warmup=1, device=dev)
        total, top = device_breakdown(lambda: fn(verts), 3, f"profile_{tag}.txt")
        return dict(median_ms=st["median"] * 1e3, spread=st["spread"],
                    iqr_spread=st["iqr_spread"], device_ms=total, device_ms_by_kernel=top)

    out = {}
    g, cams, colors = s["head"]
    for mode, (thr, mppb) in LK_MODES.items():
        def dense_step(v, mode=mode, thr=thr, mppb=mppb):
            leaves = [x.detach().requires_grad_(True) for x in (v, g.sigmas, colors)]
            frag = vt.render_pipeline(leaves[0], leaves[1], *cams, image_size=(256, 256),
                                      max_assign=200, thr_activation=thr,
                                      max_point_per_bin=mppb, attrs=leaves[2])
            loss = ((frag.attr_img - 0.5) ** 2).mean() + (vt.get_silhouette(frag) ** 2).mean()
            return torch.autograd.grad(loss, leaves)

        out[f"dense_k200_{mode}_step"] = stats(dense_step, g.verts.detach(),
                                               5 if mode == "coarse" else 3,
                                               f"dense_k200_{mode}", 1e-5)

    n = g.verts.shape[0]
    n_pad = -(-n // 4) * 4
    pad = lambda x, v: torch.cat([x.detach(), torch.full((n_pad - n,) + x.shape[1:], v,
                                                         device=dev)])
    verts, sigmas, cols = pad(g.verts, 100.0), pad(g.sigmas, 1.0), pad(colors, 0.5)
    R, T = vt.look_at_view_transform(dist=[6.0] * 8, elev=list(np.linspace(5, 25, 8)),
                                     azim=list(np.linspace(50, 90, 8)), device=dev)
    cams8 = (R, T, torch.full((8, 2), 300.0, device=dev),
             torch.tensor([[128.0, 128.0]] * 8, device=dev))
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
        return torch.autograd.grad(loss, leaves)

    out["sharded_single"] = stats(step, verts, 10, "sharded_single", 1e-5)
    for tag, (shape, axis, ring) in SHARD_MESHES.items():
        mesh = make_mesh(("data", "model"), shape, devices=[dev] * (shape[0] * shape[1]))
        out[f"sharded_{tag}"] = stats(lambda v, m=mesh, a=axis, r=ring: step(v, m, a, r), verts,
                                      10, f"sharded_{tag}", 1e-5)
    for tag, st in out.items():
        print(f"{tag} (timing.py): median {st['median_ms']:.3f} ms, spread {st['spread']:.3f}, "
              f"iqr spread {st['iqr_spread']:.3f}; device {st['device_ms']:.3f} ms by kernel: "
              + "; ".join(f"{k[:60]} {v:.3f}" for k, v in st["device_ms_by_kernel"].items()))
    details["uncelled_paths"] = out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible; the port's table runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    OUT_DIR.mkdir(exist_ok=True)
    details = {"failures": []}
    build_report(details)
    inputs = table_inputs(dev)
    launches = path_launches(dev, inputs, details)
    kern = details["kernels"] = kernel_table(dev, inputs, launches, details)
    uncelled_paths(dev, inputs, details)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(f"nvidia-smi: {smi_line()}")
    print(json.dumps({"kernels": kern}))
    failures = details["failures"]
    print(json.dumps({"ok": not failures, "failures": len(failures), "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
