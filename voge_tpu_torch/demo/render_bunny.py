"""Render the Stanford bunny as per-vertex Gaussians with normals as colour
(``demo/render_bunny.py``, reference ``demo/RenderBunny.py``); an icosphere
stands in when the upstream ``bunny.off`` is absent."""
import numpy as np
import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import PerspectiveCameras, look_at_view_transform
from voge_tpu_torch.converter import IO, shapes
from voge_tpu_torch.converter.converters import naive_vertices_converter
from voge_tpu_torch.demo._utils import ref_data, run, save_image
from voge_tpu_torch.meshes import GaussianMeshesNaive
from voge_tpu_torch.renderer import GaussianRenderer, GaussianRenderSettings, to_white_background


def main(device=None, out_dir=None):
    dev = resolve_device(device)
    bunny = ref_data("bunny.off")
    if bunny is not None:
        verts_, faces_ = IO.load_off(bunny)
    else:  # self-contained fallback
        verts_, faces_ = shapes.ico_sphere(4, radius=0.08)
        verts_ = verts_ + np.array([0, 0.1, 0], np.float32)

    meshes = GaussianMeshesNaive(
        *IO.to_torch(*naive_vertices_converter(verts_, faces_, percentage=0.6), device=dev))
    normals = shapes.vertex_normals(np.asarray(verts_), np.asarray(faces_))
    color = torch.as_tensor(normals * 0.4 + 0.4, dtype=torch.float32, device=dev)

    render_settings = GaussianRenderSettings(
        batch_size=-1, image_size=(256, 256), max_assign=40, absorptivity=1,
        principal=(128, 128), inverse_sigma=False,
    )
    cameras = PerspectiveCameras(
        focal_length=2000.0, principal_point=((128, 128),),
        image_size=(render_settings["image_size"],), in_ndc=False, device=dev,
    )
    renderer = GaussianRenderer(cameras=cameras, render_settings=render_settings)
    R, T = look_at_view_transform([6], [0], [10], degrees=True, device=dev)
    frag = renderer(meshes, R=R, T=T)
    img = to_white_background(frag, color).clip(0, 1)
    save_image("bunny", img, out_dir)


if __name__ == "__main__":
    run(main)
