"""Times of K2's global entry without a bits plane (``fine_select_global``)
by route of its cone cull, to set the two-level cull's threshold and
super-tile size on one NVIDIA GPU, and to set two checkouts side by side.

    python3 tools/torch_cull_levels.py [--root DIR] [--shapes a,b,...] [--supers 2,4,8]

It imports ``voge_tpu_torch`` from DIR (default: this checkout's root; the
kernels build under DIR/build) and renders, through ``chip_smoke.py``'s
scenes, the selections of:

- ``shapefit``: the no-coarse ShapeFitting shape (``ico_sphere(4)``, 2,562
  Gaussians, 5 views at 128x128, K = 25);
- ``cloud30k``, ``cloud100k``, ``cloud300k``: the point cloud at 320x320,
  one view, K = 20; ``cloud300k_b4``: 300,000 points under the four cameras
  of the benchmark's ``cloud300k.fit_b4`` cell;
- ``small<N>``: N points of the same cloud at 128x128 (focal 160), one
  view, K = 20: where the two-level route stops paying.

For each shape it runs the single-level route and, where the checkout has
it, the two-level route at each super-tile size of ``--supers`` (both forced
by the module's threshold, whatever the rule would pick), and prints for
each: device ms a call from a torch.profiler trace of 20 calls (all its
kernels, and the select's own kernels alone), CUDA-event ms of 20
back-to-back calls, whether every output equals the same kernel's with the
cull off (``_cull=False``) to the bit, the sha256 (first 16 hex digits) of
the selections and weights, and the route the rule picks.  Last line: one
JSON object.  Run it in one call against this checkout and a ``git archive``
of another unpacked under ``build/``, in the order other, this, this, other.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
SHAPES = ("shapefit", "cloud30k", "cloud100k", "cloud300k", "cloud300k_b4")


def _inputs(smoke, tag, dev):
    """(rays, table, thr_act, K, bin_size) of shape ``tag``."""
    import voge_tpu_torch as vt
    from voge_tpu_torch.aggregation import expend_sigma
    from voge_tpu_torch.ops import fine
    from voge_tpu_torch.rays import camera_rays

    if tag == "shapefit":
        verts, isig, _, cams, _ = smoke.shapefit_scene(dev)
        hw, K = smoke.SF_HW, smoke.SF_K
    elif tag.startswith("small"):
        verts, isig, cams = smoke.cloud_scene(int(tag[5:]), dev)
        hw, K = (128, 128), smoke.CLOUD_K
        cams = (cams[0], cams[1], cams[2] * 0.4, cams[3] * 0.4)
    else:
        n = {"cloud30k": 30_000, "cloud100k": 100_000}.get(tag, 300_000)
        verts, isig, cams = smoke.cloud_scene(n, dev)
        hw, K = smoke.CLOUD_HW, smoke.CLOUD_K
        if tag == "cloud300k_b4":   # the cell's four views (portbench traffic fit_colors_b4)
            R, T = vt.look_at_view_transform(dist=[4.0] * 4, elev=[10.0, 16.7, 23.3, 30.0],
                                             azim=[20.0, 30.0, 40.0, 50.0], device=dev)
            cams = (R, T, cams[2].expand(4, 2), cams[3].expand(4, 2))
    rays, origins = camera_rays(*cams, hw)
    points = verts[None] - origins[:, None, :]
    isg = (2.0 * expend_sigma(isig))[None].expand(points.shape[0], -1, 3, 3)
    table = fine.feature_table(points, isg)
    bs, _ = fine.production_bin_geometry(hw, K, verts.shape[0], None, -1)
    return rays.contiguous(), table, -math.log(0.01 + 1e-10), K, bs


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _device_ms(fn, n=20):
    """(all device ms a call, the select kernel's own ms a call, {kernel: ms})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            by[ev.key] = by.get(ev.key, 0.0) + ev.self_device_time_total / 1e3 / n
    own = sum(v for k, v in by.items() if "fine_select_kernel<" in k)
    return sum(by.values()), own, by


def _event_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose voge_tpu_torch to import")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--supers", default="2,4,8", help="super-tile sizes (blocks a side) to time")
    a = ap.parse_args()
    root = Path(a.root).resolve()
    if not torch.cuda.is_available():
        sys.exit("torch_cull_levels: no CUDA device visible")
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import voge_tpu_torch as vt
    from voge_tpu_torch.ops import cuda_fine as cf

    assert Path(vt.__file__).resolve().is_relative_to(root), vt.__file__
    dev = torch.device("cuda")
    has_two = hasattr(cf, "_TWO_LEVEL_MIN_PAIRS")
    saved = (cf._TWO_LEVEL_MIN_PAIRS, cf._SUPER) if has_two else None
    out = {"root": str(root), "two_level": has_two, "shapes": {}}
    for tag in a.shapes.split(","):
        rays, table, thr_act, K, bs = _inputs(smoke, tag, dev)
        B, H, W, _ = rays.shape
        P = table.shape[0] // B
        args = (rays, table, None, thr_act, K, bs, 1.0)
        ref = cf.fine_select_global(*args, _cull=False)
        th, tw = cf.global_tile(False, bs)
        blocks = B * ((H - 1) // th + 1) * ((W - 1) // tw + 1)
        rec = {"B": B, "P": P, "hw": [H, W], "K": K, "blocks": blocks,
               "rule": (("two" if cf.two_level(P, blocks) else "single") if has_two else None),
               "routes": {}}
        routes = [("single", None)] + ([(f"two_s{s}", int(s)) for s in a.supers.split(",")]
                                      if has_two else [])
        for name, S in routes:
            if has_two:
                cf._TWO_LEVEL_MIN_PAIRS, cf._SUPER = (1 << 62, saved[1]) if S is None else (0, S)
            fn = lambda: cf.fine_select_global(*args)
            got = fn()
            dev_ms, own_ms, by = _device_ms(fn)
            rec["routes"][name] = dict(
                device_ms=dev_ms, select_kernel_ms=own_ms, event_ms=_event_ms(fn),
                equal_to_cull_off=all(torch.equal(x, y) for x, y in zip(got, ref)),
                digest=_digest(got[0], got[4]),
                kernels={k[:90]: v for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:6]})
            r = rec["routes"][name]
            print(f"{tag:13s} P={P:7d} B={B} {name:8s} device {dev_ms:8.4f} ms (select kernel "
                  f"{own_ms:8.4f}) events {r['event_ms']:8.4f} ms equal={r['equal_to_cull_off']} "
                  f"digest={r['digest']}", flush=True)
        if has_two:
            cf._TWO_LEVEL_MIN_PAIRS, cf._SUPER = saved
        out["shapes"][tag] = rec
        del ref, table, rays
        torch.cuda.empty_cache()
    out["gpu"] = torch.cuda.get_device_name()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
