"""Digests of ``voge_tpu_torch``'s gradients on fixed seeded inputs, to set
two checkouts of the port side by side, bit for bit, on one NVIDIA GPU.

    python3 tools/torch_grad_bits.py [--root DIR]

It imports ``voge_tpu_torch`` from DIR (default: this checkout's root; the
kernels build under DIR/build) and prints one JSON line: for each case the
sha256 (first 16 hex digits) of its gradients' bytes.  Run it against two
checkouts (this one and, say, a ``git archive`` of its parent unpacked
under ``build/``) in one call: equal digests are equal bits.  The scenes
are ``chip_smoke.py``'s, and every case calls only entry points that both
sides have:

- ``frozen_300k_rays``: the 300,000-point cloud with no coarse stage, the
  points constant (the frozen-scene step of ``tests/test_torch_cuda_paths.py``):
  the ray gradient;
- ``step_300k``: the 300,000-point step's gradients (verts, sigmas, R, T);
- ``two_stage_rays`` / ``two_stage_scene``: the headline scene through
  ``rasterize_coarse`` -> ``ray_tracing_fine`` and a seeded linear loss:
  the ray gradient with the scene frozen, and the means', precisions' and
  rays' gradients with it free;
- ``compacted_rays``: the 10K cuboid at 256x256, K = 20, colours
  composited, through ``ops.fine.ray_tracing`` (coarse stage) on constant
  points, seen from the pose tests' first refinement camera: the
  ray gradient of ``bench.py``'s loss;
- ``headline_step``: the headline fitting step's gradients (verts, sigmas,
  colours), cameras fixed;
- ``attr_merge_headline``: the attribute merge (K3f) of the headline
  render's slots with the colours, and its backward (K4b: the d_w kernel and
  the scatter) under a seeded cotangent: the image and both gradients;
- ``sampler_texture``: the texture scene's K = 80 render pulled back onto
  the Gaussians by ``SampleFeatures`` and the backward of a seeded loss (K3f
  for the image's gradient, ``attr_dw`` for the weights'): the features and
  both gradients.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose voge_tpu_torch to import")
    root = Path(ap.parse_args().root).resolve()
    if not torch.cuda.is_available():
        sys.exit("torch_grad_bits: no CUDA device visible")
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import voge_tpu_torch as vt
    from voge_tpu_torch.aggregation import expend_sigma
    from voge_tpu_torch.ops import coarse, fine
    from voge_tpu_torch.rays import camera_rays

    assert Path(vt.__file__).resolve().is_relative_to(root), vt.__file__
    dev = torch.device("cuda")
    out = {}

    # the 300,000-point cloud: the frozen-scene step and the full step
    verts_c, isig_c, cams_c = smoke.cloud_scene(300_000, dev)
    rays_c, origins_c = camera_rays(*cams_c, smoke.CLOUD_HW)
    points_c = (verts_c[None] - origins_c[:, None, :]).contiguous()
    isg_c = (2.0 * expend_sigma(isig_c))[None].contiguous()
    K = smoke.CLOUD_K
    cw = smoke.seeded((1,) + smoke.CLOUD_HW + (K,), dev, 95)
    r = rays_c.clone().requires_grad_(True)
    sel, _ = fine.ray_tracing(cams_c, points_c, isg_c, r, smoke.CLOUD_HW, 0.01, K,
                              max_points_per_bin=-1)
    loss = (sel[4].sum(-1).clamp(max=1.0) ** 2).mean() + (sel[4] * cw).mean()
    out["frozen_300k_rays"] = _digest(*torch.autograd.grad(loss, r))
    colors_c = ((verts_c + 1) / 2).contiguous()
    _, loss, leaves = smoke.cloud_step(verts_c, isig_c, cams_c, colors_c)
    out["step_300k"] = _digest(*torch.autograd.grad(loss, leaves))

    # the headline scene: the two-stage tracer, the compacted path, the step
    g, cams, colors = smoke.scene(10000, (256, 256), 300.0, dev)
    rays_h, points_h, isig_h = smoke.stage_inputs(g, cams, (256, 256))
    bs, mppb = coarse.coarse_bin_config((256, 256), 20, points_h.shape[1])
    bp, cnt = vt.ops.rasterize_coarse(*cams, points_h, isig_h, (256, 256), 0.01, bs, mppb,
                                      return_counts=True)
    if int(cnt.max()) > mppb:
        mppb = int(cnt.max())
        bp = vt.ops.rasterize_coarse(*cams, points_h, isig_h, (256, 256), 0.01, bs, mppb)
    cots = [smoke.seeded(rays_h.shape[:3] + (20,), dev, 80 + q) for q in range(3)]
    mus, isg = points_h.reshape(-1, 3), isig_h.reshape(-1, 3, 3)
    for tag, scene_grad in (("two_stage_rays", False), ("two_stage_scene", True)):
        leaves = [mus.clone().requires_grad_(scene_grad), isg.clone().requires_grad_(scene_grad),
                  rays_h.clone().requires_grad_(True)]
        sel = vt.ops.ray_tracing_fine(*leaves, bp, 0.01, bs, 20)
        v = sel[1] * cots[0] + sel[2] * cots[1] + sel[3] * cots[2]
        loss = torch.where(sel[0] >= 0, v, torch.zeros_like(v)).sum()
        out[tag] = _digest(*torch.autograd.grad(
            loss, [x for x in leaves if x.requires_grad]))

    R, T = vt.models.pose_matrices(*(torch.tensor([v], device=dev) for v in (
        6.0, math.radians(12.0), math.radians(64.0), 0.0)))
    cams_p = (R, T, torch.tensor([[300.0, 300.0]], device=dev),
              torch.tensor([[128.0, 128.0]], device=dev))
    rays_p, origins_p = camera_rays(*cams_p, (256, 256))
    points_p = (g.verts.detach()[None] - origins_p[:, None, :]).contiguous()
    r = rays_p.clone().requires_grad_(True)
    sel, _ = fine.ray_tracing(cams_p, points_p, isig_h, r, (256, 256), 0.01, 20,
                              attrs=colors[None])
    loss = ((sel[5] - 0.5) ** 2).mean() + (sel[4].sum(-1).clamp(max=1.0) ** 2).mean()
    out["compacted_rays"] = _digest(*torch.autograd.grad(loss, r))

    frag, loss, leaves = smoke.fitting_step(g, cams, colors, (256, 256))
    out["headline_step"] = _digest(*torch.autograd.grad(loss, leaves))

    # the attribute merge and its backward; the sampler's backward
    from voge_tpu_torch.ops.cuda_attr import AttrMerge
    from voge_tpu_torch.sampler import SampleFeatures

    idx = frag.vert_index.contiguous()
    w = frag.vert_weight.detach().contiguous().requires_grad_(True)
    cols = colors.detach().clone().requires_grad_(True)
    img = AttrMerge.apply(w, cols, idx)
    grads = torch.autograd.grad((img * smoke.seeded(img.shape, dev, 96)).sum(), [w, cols])
    out["attr_merge_headline"] = _digest(img, *grads)
    verts_t, isig_t, cams_t, image_t = smoke.texture_scene(dev)
    frag_t = vt.render_pipeline(verts_t, isig_t, *cams_t, image_size=smoke.TEX_HW,
                                max_assign=smoke.TEX_K)
    w_t = frag_t.vert_weight.detach().contiguous().requires_grad_(True)
    image = image_t.clone().requires_grad_(True)
    feats = SampleFeatures.apply(w_t, image, frag_t.vert_index.to(torch.int32).contiguous(),
                                 verts_t.shape[0])
    grads = torch.autograd.grad((feats * smoke.seeded(feats.shape, dev, 97)).sum(), [w_t, image])
    out["sampler_texture"] = _digest(feats, *grads)
    print(json.dumps({"root": str(root), "card": torch.cuda.get_device_name(0),
                      "digests": out}))


if __name__ == "__main__":
    main()
