"""Single-view texture extraction (inverse rendering) and re-rendering
(``demo/extract_texture.py``, reference ``demo/ExtractTexture.py``): project
a photo onto a CAD model's Gaussians with ``sample_features``, then render
from a new pose.  Needs the upstream car data (``car_image.JPEG``,
``car_annotation.npz``, ``car.off``); without it the demo says so and
returns."""
import numpy as np
import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import PerspectiveCameras, look_at_view_transform
from voge_tpu_torch.converter import IO
from voge_tpu_torch.converter.converters import naive_vertices_converter
from voge_tpu_torch.demo._utils import REF_DATA, ref_data, run, save_image
from voge_tpu_torch.meshes import GaussianMeshesNaive
from voge_tpu_torch.renderer import GaussianRenderer, GaussianRenderSettings, to_white_background
from voge_tpu_torch.sampler import sample_features
from voge_tpu_torch.utils import rotation_theta


def main(device=None, out_dir=None):
    image_path = ref_data("car_image.JPEG")
    annos_path = ref_data("car_annotation.npz")
    cad_path = ref_data("car.off")
    if not all((image_path, annos_path, cad_path)):
        print(f"skipped: no reference car data under {REF_DATA}")
        return None

    from PIL import Image

    dev = resolve_device(device)
    annos = np.load(annos_path)
    im = torch.as_tensor(np.asarray(Image.open(image_path)).astype(np.float32), device=dev)

    render_settings = GaussianRenderSettings(batch_size=-1, image_size=(256, 672), max_assign=80)
    cameras = PerspectiveCameras(
        focal_length=1800.0, principal_point=((336, 128),),
        image_size=(render_settings["image_size"],), device=dev,
    )
    renderer = GaussianRenderer(cameras=cameras, render_settings=render_settings)

    theta = float(annos["theta"])
    azim = float(annos["azimuth"])
    elev = float(annos["elevation"])
    dist = 3.0

    meshes = GaussianMeshesNaive(*IO.to_torch(
        *naive_vertices_converter(*IO.pre_process_pascal(*IO.load_off(cad_path)),
                                  percentage=0.5, max_sig_rate=2), device=dev))

    rot = rotation_theta(torch.tensor([theta], device=dev))
    R, T = look_at_view_transform([dist], [elev], [azim], degrees=False, device=dev)
    frag = renderer(meshes, R=R @ rot, T=T)

    feat, feat_sum = sample_features(frag, im[None], meshes.verts.shape[0])
    texture = feat / (1e-8 + feat_sum[:, None]) / 255.0
    texture = texture * 0.7
    print("extracted texture for", texture.shape[0], "kernels")

    # re-render from a rotated viewpoint
    R2, T2 = look_at_view_transform([dist], [elev], [azim - np.pi / 6], degrees=False, device=dev)
    frag2 = renderer(meshes, R=R2 @ rot, T=T2)
    img = to_white_background(frag2, texture).clip(0, 1)
    save_image("extract_texture_rerender", img, out_dir)
    return None


if __name__ == "__main__":
    run(main)
