"""Times of the attribute merge's kernels of one checkout of the port, to set
two checkouts side by side on one NVIDIA GPU.

    python3 tools/torch_attr_times.py [--root DIR] [--inputs FILE]

It imports ``voge_tpu_torch`` from DIR (default: this checkout's root; the
kernels build under DIR/build) and times K3f (``attr_merge``), ``attr_dw``
and K4b (``attr_merge_bwd``) through that checkout's wrappers at the
headline shapes (the 10K-Gaussian render at 256x256, K = 20, the colours:
65,536 pixels, d = 3) and at the texture shapes (the texture render at
256x672, K = 80, the sampler backward's d = 4 rows: 172,032 pixels), the
inputs ``chip_smoke.py`` times them on.  For each: CUDA-event ms of 50
back-to-back calls, device ms from a torch.profiler trace of 20 calls on the
same inputs and of 20 calls with the inputs past the L2
(``chip_smoke.past_l2``), and host µs a call enqueued without a
synchronisation; and the sha256 (first 16 hex digits) of what it returns,
so that equal digests across checkouts are equal bits.  It prints one JSON
line.

The inputs are rendered by the first run, saved to FILE, and read back by
every later run, so that each checkout times the same tensors and builds
only the attribute kernels.  Run it in one call against this checkout and,
say, a ``git archive`` of its parent unpacked under ``build/``, in the
order parent, change, change, parent, and compare within that call.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def _inputs(smoke, dev):
    """{tag: (K3f args, attr_dw args, K4b args)} at the headline and the
    texture shapes."""
    import voge_tpu_torch as vt

    g, cams, colors = smoke.scene(10000, (256, 256), 300.0, dev)
    frag = vt.render_pipeline(g.verts.detach(), g.sigmas.detach(), *cams, image_size=(256, 256),
                              max_assign=20)
    idx_h, w_h = frag.vert_index.to(torch.int32).contiguous(), frag.vert_weight.contiguous()
    g_h = smoke.seeded(idx_h.shape[:-1] + (3,), dev, 96)
    verts, isig, cams_t, image = smoke.texture_scene(dev)
    frag_t = vt.render_pipeline(verts, isig, *cams_t, image_size=smoke.TEX_HW,
                                max_assign=smoke.TEX_K)
    idx_t, w_t = frag_t.vert_index.to(torch.int32).contiguous(), frag_t.vert_weight.contiguous()
    aug = torch.cat([image, torch.ones_like(image[..., :1])], dim=-1).contiguous()
    g_aug = smoke.seeded((verts.shape[0], 4), dev, 60)
    return {"headline": ((idx_h, w_h, colors), (idx_h, colors, g_h), (idx_h, w_h, colors, g_h)),
            "texture": ((idx_t, w_t, g_aug), (idx_t, g_aug, aug), (idx_t, w_t, g_aug, aug))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose voge_tpu_torch to import")
    ap.add_argument("--inputs", default=str(HERE / "build" / "attr_times_inputs.pt"),
                    help="the inputs: rendered and saved here if missing, else read")
    a = ap.parse_args()
    root, path = Path(a.root).resolve(), Path(a.inputs).resolve()
    if not torch.cuda.is_available():
        sys.exit("torch_attr_times: no CUDA device visible")
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import voge_tpu_torch as vt
    from voge_tpu_torch.ops.cuda_attr import attr_dw, attr_merge, attr_merge_bwd

    assert Path(vt.__file__).resolve().is_relative_to(root), vt.__file__
    dev = torch.device("cuda")
    if path.exists():
        shapes = {tag: tuple(tuple(t.to(dev) for t in args) for args in sets)
                  for tag, sets in torch.load(path).items()}
    else:
        shapes = _inputs(smoke, dev)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({tag: tuple(tuple(t.cpu() for t in args) for args in sets)
                    for tag, sets in shapes.items()}, path)
    out = {}
    for tag, sets in shapes.items():
        for name, kfn, args in zip(("attr_merge", "attr_dw", "attr_merge_bwd"),
                                   (attr_merge, attr_dw, attr_merge_bwd), sets):
            call = lambda: kfn(*args)
            got = call()
            h = hashlib.sha256()
            for t in got if isinstance(got, tuple) else (got,):
                h.update(t.cpu().numpy().tobytes())
            r = dict(ms=smoke.cuda_ms(call, 50), device_ms=smoke.device_ms(call, 20),
                     device_ms_past_l2=smoke.device_ms(smoke.past_l2(kfn, *args), 20),
                     host_us=smoke.host_us(call))
            print(f"{name} {tag}: " + ", ".join(f"{k} {v:.5f}" for k, v in r.items()),
                  file=sys.stderr)
            out.setdefault(name, {})[tag] = dict(r, digest=h.hexdigest()[:16])
    print(json.dumps({"root": str(root), "card": smoke.smi_line(), "times": out}))


if __name__ == "__main__":
    main()
