"""Drive the voge_tpu_torch forward render on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases:
  1. the card (nvidia-smi name and power limit) and the kernel build from
     ``voge_tpu_torch/csrc`` (build seconds, ptxas report);
  2. each kernel against its plain PyTorch version on the card, on a 1K
     scene at 128x128 and on the 10K-Gaussian headline at 256x256 (K1 exact;
     K2 at K = 5 and 20, with and without attributes; K3f);
  3. the main path at the headline, through ``render_pipeline(attrs=)`` and
     ``GaussianRenderer`` + ``to_white_background``, with every launch
     counter read around it; the 1K result against the golden file written
     by ``voge_tpu`` (tests/data); the 1K quickstart against its bounds;
  4. CUDA-event timings of the headline forward on the kernel path and on
     the plain path, and of each kernel against its plain version; a
     torch.profiler trace of five kernel-path forwards gives the device's
     busy share and the time by kernel.

Any failed check raises, so the exit code is nonzero.  The last line is
``{"ok": true, "device": {...}}``; the line before it a JSON line of the
kernels.  Without a CUDA device the script exits nonzero at once.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "voge_tpu_golden_1k_128.npz"
OUT_DIR = ROOT / "chiprun_out"
KERNELS = {  # name -> (source, replaced TPU kernel)
    "emit_keys": ("voge_tpu_torch/csrc/emit.cu",
                  "voge_tpu/ops/pallas_coarse.py:38"),
    "fine_select": ("voge_tpu_torch/csrc/fine_select.cu",
                    "voge_tpu/ops/pallas_fine2.py:89"),
    "attr_merge": ("voge_tpu_torch/csrc/attr_merge.cu",
                   "voge_tpu/ops/pallas_attr.py:64"),
}
# tolerances (tests/test_parity_full.py:22-49): selections equal but for
# knife-edge pixels (< 0.1% flipped); len/act/dsd rtol 1e-5 atol 1e-5;
# weights and images atol 1e-4 on agreeing pixels (kernel vs plain, and the
# small-frame golden); 1.5e-3 is the f32 ceiling at the headline.
FLIP_MAX, LAD_TOL, W_TOL = 1e-3, 1e-5, 1e-4


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
    """Route the render through the three plain versions on CUDA tensors."""
    from voge_tpu_torch.ops import coarse, cuda_attr, cuda_coarse, cuda_fine

    swaps = [(coarse, "emit_keys", cuda_coarse.emit_keys_plain),
             (cuda_fine, "fine_select", cuda_fine.fine_select_plain),
             (cuda_attr, "attr_merge", cuda_attr.attr_merge_plain)]
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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible; the port's checks run only on a GPU")
    sys.path.insert(0, str(ROOT))
    import voge_tpu_torch as vt
    from voge_tpu_torch import _build
    from voge_tpu_torch.ops import coarse, fine
    from voge_tpu_torch.ops.cuda_attr import attr_merge, attr_merge_plain
    from voge_tpu_torch.ops.cuda_coarse import emit_keys, emit_keys_plain
    from voge_tpu_torch.ops.cuda_fine import fine_select, fine_select_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    OUT_DIR.mkdir(exist_ok=True)
    details = {}
    launchers = {"emit_keys": emit_keys, "fine_select": fine_select,
                 "attr_merge": attr_merge}

    # ---- 1. card and build --------------------------------------------
    smi = smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    details["card"] = smi
    t0 = time.perf_counter()
    for src in ("emit", "fine_select", "attr_merge"):
        _build.load(src)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s total " + ", ".join(
        f"{k} {v[0]:.1f} s" for k, v in _build.build_info.items()))
    ptxas = "\n".join(f"== {k}\n{v[1]}" for k, v in _build.build_info.items())
    (OUT_DIR / "ptxas.txt").write_text(ptxas)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
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
            for attrs in (None, colors):
                args = (rays, c.table_c, c.bits_c, c.ids_c, c.counts_c,
                        c.thr_act, K, c.bin_size, 1.0, attrs)
                got, want = fine_select(*args), fine_select_plain(*args)
                flips, e = compare_select(got, want)
                err["fine_select"] = max(err["fine_select"], e)
                print(f"K2 {tag}: K={K} attrs={attrs is not None} M={c.table_c.shape[1]} "
                      f"flips={flips:.2e} max_err(w,img)={e:.3e}")
                if tag == "headline" and K == 20 and attrs is not None:
                    head["k2"] = args
                    head["k3"] = (got[0], got[4], colors)
        idx, w, attrs = head["k3"] if tag == "headline" else (got[0], got[4], colors)
        e = (attr_merge(idx, w, attrs) - attr_merge_plain(idx, w, attrs)).abs().max().item()
        need(e <= 1e-5, f"K3f {tag} error {e}")
        err["attr_merge"] = max(err["attr_merge"], e)
        print(f"K3f {tag}: max_err={e:.3e}")
        if tag == "headline":
            head.update(k1=k1_args, scene=(g, cams, colors), P=P)
    torch.cuda.synchronize()

    # ---- 3. the main path ---------------------------------------------
    g, cams, colors = head["scene"]
    R, T, focal, principal = cams
    hw = (256, 256)
    for fn in launchers.values():
        fn.launches = 0
    frag = vt.render_pipeline(g.verts, g.sigmas, *cams, image_size=hw,
                              max_assign=20, attrs=colors)
    cam_obj = vt.PerspectiveCameras(focal_length=300.0, principal_point=((128.0, 128.0),),
                                    image_size=(hw,), device=dev)
    renderer = vt.GaussianRenderer(cam_obj, vt.GaussianRenderSettings(image_size=hw))
    frag2 = renderer(g, R=R, T=T)
    white = vt.to_white_background(frag2, colors)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in launchers.items()}
    print(f"main path launches: {launches}")
    for k, nl in launches.items():
        need(nl > 0, f"{k} was not launched on the main path")
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

    q, qcams, qcolors = scene(1000, (256, 256), 300.0, dev)
    fq = vt.render_pipeline(q.verts, q.sigmas, *qcams, image_size=(256, 256), max_assign=20)
    wsum = fq.vert_weight.sum().item()
    sil = vt.get_silhouette(fq).mean().item()
    qimg = vt.to_white_background(fq, qcolors)
    need(25000 < wsum < 31000 and 0.25 < sil < 0.45, f"quickstart bounds {wsum} {sil}")
    need(qimg[0, 0, 0].min().item() > 0.999 and qimg[0, -1, -1].min().item() > 0.999,
         "quickstart corners not white")
    print(f"quickstart 1K 256x256: weight_sum={wsum:.2f} silhouette={sil:.4f}")
    details["quickstart"] = dict(weight_sum=wsum, silhouette=sil)

    # ---- 4. timings -----------------------------------------------------
    inputs = [g.verts.detach() * (1.0 + 1e-5 * i) for i in range(24)]
    sig = g.sigmas.detach()

    def forward(v):
        return vt.render_pipeline(v, sig, *cams, image_size=hw, max_assign=20,
                                  attrs=colors).attr_img

    def timed(vs):
        out = []
        for v in vs:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            forward(v)
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return out

    runs = {"kernel": [], "plain": []}
    for v in inputs[:2]:
        forward(v)
    with plain_path():
        forward(inputs[0])
    torch.cuda.synchronize()
    for order, path in enumerate(("plain", "kernel", "kernel", "plain")):
        part = inputs[4 + 10 * (order % 2): 14 + 10 * (order % 2)]
        if path == "plain":
            with plain_path():
                runs[path] += timed(part)
        else:
            runs[path] += timed(part)
    fwd = {}
    for path, ts in runs.items():
        med = statistics.median(ts)
        fwd[path] = dict(median_ms=med, min_ms=min(ts), max_ms=max(ts),
                         spread=(max(ts) - min(ts)) / med, n=len(ts))
        print(f"headline forward {path} path: median {med:.3f} ms, "
              f"min {min(ts):.3f}, max {max(ts):.3f}, n={len(ts)}")
    details["forward"] = fwd

    k2 = head["k2"]
    k3 = head["k3"]
    per = {
        "emit_keys": (lambda: emit_keys(*head["k1"]), lambda: emit_keys_plain(*head["k1"])),
        "fine_select": (lambda: fine_select(*k2), lambda: fine_select_plain(*k2)),
        "attr_merge": (lambda: attr_merge(*k3), lambda: attr_merge_plain(*k3)),
    }
    kern = []
    for name, (kfn, pfn) in per.items():
        ms = cuda_ms(kfn, 50)
        plain_ms = cuda_ms(pfn, 5 if name == "fine_select" else 20)
        print(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms")
        src, rep = KERNELS[name]
        kern.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=launches[name], max_abs_err=err[name],
                         ms=ms, plain_ms=plain_ms))
    details["kernels"] = kern

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for v in inputs[:5]:
            forward(v)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {ev.key: ev.self_device_time_total / 1e3 for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA}
    # device time per forward from the trace, over the untraced median wall
    dev_ms = sum(kinds.values()) / 5
    busy = dev_ms / fwd["kernel"]["median_ms"]
    top = sorted(kinds.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile: device {dev_ms:.3f} ms per forward, busy share {busy:.3f} of the "
          f"untraced median (traced wall {wall_ms / 5:.3f} ms); top over 5 forwards: "
          + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))
    details["profile"] = dict(device_ms_per_forward=dev_ms, device_busy_share=busy,
                              traced_wall_ms_per_forward=wall_ms / 5,
                              device_ms_by_kernel_5_forwards=kinds)
    (OUT_DIR / "profile.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))

    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(f"nvidia-smi: {smi_line()}")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
