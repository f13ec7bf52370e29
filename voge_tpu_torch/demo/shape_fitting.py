"""Shape and colour fitting (``demo/shape_fitting.py``, reference
``demo/ShapeFitting.py``): SGD with momentum on an icosphere's Gaussian
centres and per-kernel colours against multi-view silhouettes and RGB
renders of a target scene, through the no-coarse render.  The targets are
renders of the target Gaussians (the upstream cow when present, else a
squashed icosphere)."""
import numpy as np
import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import look_at_view_transform
from voge_tpu_torch.converter import shapes
from voge_tpu_torch.converter.converters import naive_vertices_converter
from voge_tpu_torch.demo._utils import ref_data, run, save_image
from voge_tpu_torch.renderer import get_silhouette, interpolate_attr, render_pipeline


def target_mesh():
    cow = ref_data("cow.obj")
    if cow is not None:
        verts, faces = shapes.load_obj(cow)
        # normalize to unit scale at origin (reference does the same)
        center = verts.mean(0)
        verts = verts - center
        verts = verts / np.abs(verts).max()
        return verts, faces
    v, f = shapes.ico_sphere(3)
    v[:, 0] *= 1.4  # squash so there is something to fit
    v[:, 2] *= 0.7
    return v, f


def main(iters=400, num_views=20, views_per_iter=5, image_size=(128, 128), seed=0,
         device=None, out_dir=None):
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    rng = np.random.RandomState(seed)

    tv, tf = target_mesh()
    t_verts, t_isig, _ = naive_vertices_converter(tv, tf, percentage=0.5)
    t_verts, t_isig = f32(t_verts), f32(t_isig)
    t_colors = f32((tv - tv.min(0)) / (tv.max(0) - tv.min(0)))

    # cameras on a ring (reference: num_views views, elev 0, azim 0..360)
    elev = np.zeros(num_views)
    azim = np.linspace(-180, 180, num_views, endpoint=False)
    R_all, T_all = look_at_view_transform(dist=2.7, elev=elev, azim=azim, device=dev)
    focal = f32([[126.0, 126.0]])
    principal = f32([[64.0, 64.0]])

    settings = dict(image_size=tuple(image_size), max_assign=25, max_point_per_bin=-1)

    def render_view(verts, sigmas, colors, R, T):
        frag = render_pipeline(verts, sigmas, R, T, focal, principal, **settings)
        return interpolate_attr(frag, colors), get_silhouette(frag)

    with torch.no_grad():
        views = [render_view(t_verts, t_isig, t_colors, R_all[j:j + 1], T_all[j:j + 1])
                 for j in range(num_views)]
    target_rgb = torch.cat([v[0] for v in views])
    target_sil = torch.cat([v[1] for v in views])
    save_image("shape_fitting_target", target_rgb[1], out_dir)

    # source: icosphere
    sv, sf = shapes.ico_sphere(4)
    s_verts, s_isig, _ = naive_vertices_converter(sv, sf, percentage=0.5)
    params = {"verts": f32(s_verts).requires_grad_(True),
              "colors": (torch.ones((s_verts.shape[0], 3), device=dev) * 0.5).requires_grad_(True)}
    s_isig = f32(s_isig)

    # optax.sgd(0.8, momentum=0.9): no dampening, no Nesterov
    opt = torch.optim.SGD(list(params.values()), lr=0.8, momentum=0.9)
    w_rgb, w_sil = 1.0, 1.0

    def total(Rb, Tb, t_rgb, t_sil):
        loss = 0.0
        for j in range(views_per_iter):
            rgb, sil = render_view(params["verts"], s_isig, params["colors"],
                                   Rb[j:j + 1], Tb[j:j + 1])
            loss = loss + w_sil * ((sil[0] - t_sil[j]) ** 2).mean()
            loss = loss + w_rgb * ((rgb[0] - t_rgb[j]) ** 2).mean()
        return loss / views_per_iter

    loss = None
    for i in range(iters):
        js = torch.as_tensor(rng.permutation(num_views)[:views_per_iter], device=dev)
        opt.zero_grad(set_to_none=True)
        loss = total(R_all[js], T_all[js], target_rgb[js], target_sil[js])
        loss.backward()
        opt.step()
        if (i + 1) % 50 == 0:
            print(f"iter {i+1}: loss {loss.item():.6f}")

    with torch.no_grad():
        rgb, sil = render_view(params["verts"], s_isig, params["colors"], R_all[1:2], T_all[1:2])
    save_image("shape_fitting_result", rgb[0], out_dir)
    return loss.item()


if __name__ == "__main__":
    run(main, iters=400)
