"""Render a point cloud as fixed-radius isotropic Gaussians
(``demo/render_pointclouds.py``, reference ``demo/RenderPointClouds.py``):
the JAX script's synthesised ~50K-point cloud (the reference's dataset needs
a download), 320x320."""
import numpy as np
import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import PerspectiveCameras, look_at_view_transform
from voge_tpu_torch.converter.converters import fixed_pointcloud_converter
from voge_tpu_torch.demo._utils import run, save_image
from voge_tpu_torch.meshes import GaussianMeshesNaive
from voge_tpu_torch.renderer import GaussianRenderer, GaussianRenderSettings, interpolate_attr


def synth_pointcloud(n=50000, seed=0):
    """A coloured 'terrain + arch' point cloud in a unit-ish box (the JAX
    script's, draw for draw)."""
    rng = np.random.RandomState(seed)
    # ground plane
    g = rng.uniform(-1, 1, size=(n // 2, 2))
    ground = np.stack(
        [g[:, 0], -0.4 + 0.05 * np.sin(4 * g[:, 0]) * np.cos(4 * g[:, 1]), g[:, 1]], axis=1)
    gc = np.stack([0.4 + 0.2 * g[:, 0], 0.5 + 0.1 * g[:, 1], 0.3 * np.ones(n // 2)], 1)
    # arch (half torus)
    t = rng.uniform(0, np.pi, size=(n - n // 2,))
    p = rng.uniform(0, 2 * np.pi, size=(n - n // 2,))
    r_maj, r_min = 0.6, 0.08
    arch = np.stack(
        [
            (r_maj + r_min * np.cos(p)) * np.cos(t),
            (r_maj + r_min * np.cos(p)) * np.sin(t) - 0.4,
            r_min * np.sin(p),
        ],
        axis=1,
    )
    ac = np.stack([0.7 + 0.2 * np.cos(t), 0.4 * np.ones_like(t), 0.2 + 0.2 * np.sin(p)], 1)
    points = np.concatenate([ground, arch]).astype(np.float32)
    colors = np.clip(np.concatenate([gc, ac]), 0, 1).astype(np.float32)
    return points, colors


def main(device=None, out_dir=None):
    dev = resolve_device(device)
    points, colors = synth_pointcloud()
    verts, isigma, _ = fixed_pointcloud_converter(points, radius=0.01)
    gmesh = GaussianMeshesNaive(verts, isigma, device=dev)

    render_settings = GaussianRenderSettings(image_size=(320, 320), principal=(160, 160))
    cameras = PerspectiveCameras(focal_length=400.0, principal_point=((160, 160),),
                                 image_size=((320, 320),), device=dev)
    renderer = GaussianRenderer(cameras=cameras, render_settings=render_settings)
    R, T = look_at_view_transform(dist=2.5, elev=25, azim=30, device=dev)
    frag = renderer(gmesh, R=R, T=T)
    img = interpolate_attr(frag, torch.as_tensor(colors, device=dev)).clip(0, 1)
    save_image("pointcloud", img, out_dir)


if __name__ == "__main__":
    run(main)
