"""Lighting through interpolated normal maps (``demo/light_diffusion.py``,
reference ``demo/LightDiffusion.py``): render the scene's normals as an
attribute map, then shade it with a directional diffuse (Lambert) light from
three elevations."""
import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import (
    PerspectiveCameras,
    camera_position_from_spherical_angles,
    look_at_view_transform,
)
from voge_tpu_torch.converter import IO, shapes
from voge_tpu_torch.converter.converters import naive_vertices_converter
from voge_tpu_torch.demo._utils import ref_data, run, save_image
from voge_tpu_torch.meshes import GaussianMeshesNaive
from voge_tpu_torch.renderer import GaussianRenderer, GaussianRenderSettings, interpolate_attr


def diffuse(normals_map, direction, color=(1.0, 1.0, 1.0)):
    """Lambertian diffuse: color * max(0, n . l)."""
    light = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    dot = torch.clamp((normals_map * light).sum(-1, keepdim=True), min=0.0)
    return dot * torch.as_tensor(color, dtype=dot.dtype, device=dot.device)


def main(device=None, out_dir=None):
    dev = resolve_device(device)
    bunny = ref_data("bunny.off")
    if bunny is not None:
        verts_, faces_ = IO.load_off(bunny)
    else:
        verts_, faces_ = shapes.ico_sphere(4, radius=0.08)

    meshes = GaussianMeshesNaive(
        *IO.to_torch(*naive_vertices_converter(verts_, faces_, percentage=0.6), device=dev))
    normals = torch.as_tensor(shapes.vertex_normals(verts_, faces_), dtype=torch.float32,
                              device=dev)

    render_settings = GaussianRenderSettings(
        batch_size=-1, image_size=(256, 256), max_assign=40, principal=(128, 128))
    cameras = PerspectiveCameras(
        focal_length=2000.0, principal_point=((128, 128),),
        image_size=(render_settings["image_size"],), device=dev,
    )
    renderer = GaussianRenderer(cameras=cameras, render_settings=render_settings)
    R, T = look_at_view_transform([6], [0], [10], degrees=True, device=dev)
    frag = renderer(meshes, R=R, T=T)

    # a small sweep of light directions, like the reference's animation loop
    for i, elev in enumerate((30.0, 60.0, 90.0)):
        direction = camera_position_from_spherical_angles(1.0, elev, 10.0, device=dev)
        normals_map = interpolate_attr(frag, normals)
        img = diffuse(normals_map, direction)
        save_image(f"light_diffusion_{i}", torch.clamp(img, 0, 1), out_dir)


if __name__ == "__main__":
    run(main)
