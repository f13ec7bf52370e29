"""Quickstart: render a 1000-Gaussian cuboid (``demo/render_cuboid.py``,
reference ``Readme.md:70-101``)."""
from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import PerspectiveCameras, look_at_view_transform
from voge_tpu_torch.converter import Cuboid
from voge_tpu_torch.demo._utils import run, save_image
from voge_tpu_torch.renderer import GaussianRenderer, GaussianRenderSettings, to_white_background


def main(device=None, out_dir=None):
    dev = resolve_device(device)
    gaussians = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6,
                                    as_obj=True, device=dev)
    camera = PerspectiveCameras(focal_length=300, image_size=((256, 256),),
                                principal_point=((128, 128),), device=dev)
    render_settings = GaussianRenderSettings(image_size=(256, 256), principal=(128, 128))
    renderer = GaussianRenderer(cameras=camera, render_settings=render_settings)
    R, T = look_at_view_transform(dist=6, elev=10, azim=70, device=dev)
    frag = renderer(gaussians, R=R, T=T)
    img = to_white_background(frag, (gaussians.verts + 1) / 3).clip(0, 1)
    save_image("cuboid", img, out_dir)


if __name__ == "__main__":
    run(main)
