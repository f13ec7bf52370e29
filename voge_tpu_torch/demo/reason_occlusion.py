"""Occlusion-aware multi-object translation optimization
(``demo/reason_occlusion.py``, reference ``demo/ReasonOcclusion.py``): two
semi-transparent cuboids rendered together; the first one's translation is
recovered by Adam on an RGB MSE, with gradients flowing through occlusion."""
import numpy as np
import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import look_at_view_transform
from voge_tpu_torch.converter import Cuboid
from voge_tpu_torch.demo._utils import run, save_image
from voge_tpu_torch.renderer import interpolate_attr, render_pipeline, to_white_background


def main(iters=200, image_size=(400, 400), device=None, out_dir=None):
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    percentage = 0.7
    colors_a = np.array([[0, 0.2, 1]] * 2 + [[0, 1, 0.2]] * 2 + [[0, 1, 1]] * 2)
    verts0, sigmas0, colors0 = Cuboid.cuboid_gauss(
        (-0.8, 0.8), (-0.4, 0.4), (-0.6, 0.6), 4000, colors=colors_a, percentage=percentage)
    colors_b = np.array([[1, 0.2, 0]] * 2 + [[1, 1, 0]] * 2 + [[0.2, 1, 0]] * 2)
    verts1, sigmas1, colors1 = Cuboid.cuboid_gauss(
        (-1, 1), (-1, 1), (-0.3, 0.3), 3000, colors=colors_b, percentage=percentage)
    verts0, sigmas0, verts1, sigmas1 = map(f32, (verts0, sigmas0, verts1, sigmas1))
    colors = f32(np.concatenate([colors0, colors1]))
    sigmas = torch.cat([sigmas0, sigmas1])

    R, T = look_at_view_transform(dist=5, elev=10, azim=20, device=dev)
    focal = f32([[300.0, 300.0]])
    principal = f32([[image_size[0] // 2, image_size[1] // 2]])

    settings = dict(image_size=tuple(image_size), max_assign=60, max_point_per_bin=1500)

    def render_rgb(v0, v1):
        verts = torch.cat([verts0 + v0, verts1 + v1])
        frag = render_pipeline(verts, sigmas, R, T, focal, principal, **settings)
        return interpolate_attr(frag, colors), frag

    # target scene
    v_true0 = f32([[0.5, 0.0, 1.0]])
    v_true1 = f32([[0.0, 0.0, 0.0]])
    with torch.no_grad():
        timg, tfrag = render_rgb(v_true0, v_true1)
        save_image("reason_occ_target", to_white_background(tfrag, colors), out_dir)

    # init far away
    params = {"v0": f32([[-1.0, 0.0, -5.0]]).requires_grad_(True),
              "v1": f32([[0.0, 0.0, 0.0]]).requires_grad_(True)}
    # optax.adam(0.05, b1=0.6, b2=0.4): eps 1e-8 outside the square root
    opt = torch.optim.Adam(list(params.values()), lr=0.05, betas=(0.6, 0.4), eps=1e-8)

    with torch.no_grad():
        img0, frag0 = render_rgb(params["v0"], params["v1"])
        save_image("reason_occ_before", to_white_background(frag0, colors), out_dir)

    for i in range(iters):
        opt.zero_grad(set_to_none=True)
        img, _ = render_rgb(params["v0"], params["v1"])
        loss = ((img - timg) ** 2).mean()
        loss.backward()
        opt.step()
        if (i + 1) % 25 == 0:
            print(f"iter {i+1}: loss {loss.item():.6f} v0 {params['v0'].detach().cpu().numpy()[0]}")

    with torch.no_grad():
        img1, frag1 = render_rgb(params["v0"], params["v1"])
        save_image("reason_occ_after", to_white_background(frag1, colors), out_dir)
    err = float(torch.linalg.norm(params["v0"].detach() - v_true0))
    print("final translation error:", err)
    return err


if __name__ == "__main__":
    run(main, iters=200)
