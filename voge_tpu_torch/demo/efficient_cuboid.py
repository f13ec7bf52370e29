"""Efficient cuboid representation via covariance optimization
(``demo/efficient_cuboid.py``, reference
``demo/EfficientCuboidViaOptimization.py``): 6 x 17 Gaussians whose full
covariances (through a Cholesky-factor parameterization) Adam fits so that
renders of per-face one-hot attributes match a dense 4000-Gaussian target;
the fitted render takes every Gaussian (``max_assign`` = 102, threshold
1e-8, no coarse stage) and the covariance gradients."""
import numpy as np
import torch

from voge_tpu_torch._device import resolve_device
from voge_tpu_torch.cameras import look_at_view_transform
from voge_tpu_torch.converter import Cuboid
from voge_tpu_torch.demo._utils import run, save_image
from voge_tpu_torch.renderer import interpolate_attr, render_pipeline


def to_sym(m):
    """Cholesky-style SPD parameterization: tril(m) @ tril(m)^T."""
    L = torch.tril(m)
    return L @ L.transpose(-1, -2)


def efficient_cuboid(scale=1.0):
    """17 template points per face x 6 faces (reference ``:21-41``)."""
    x = np.array([0, 0.4, 0.6, 0.85], np.float32)
    y = np.array([0.85, 0.6, 0.4, 0.85], np.float32)
    t0 = np.concatenate([[0], x, -x, y, -y]).astype(np.float32)
    t1 = np.concatenate([[0], y, -y, -x, x]).astype(np.float32)
    ones = np.ones_like(t0)
    faces = [
        np.stack([t0, t1, -ones], 1), np.stack([t0, t1, ones], 1),
        np.stack([t0, -ones, t1], 1), np.stack([t0, ones, t1], 1),
        np.stack([-ones, t0, t1], 1), np.stack([ones, t0, t1], 1),
    ]
    return np.concatenate(faces) * scale, t0.shape[0]


def main(iters=320, image_size=(256, 256), seed=0, device=None, out_dir=None):
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    rng = np.random.RandomState(seed)
    colors_0 = np.eye(6, dtype=np.float32)
    rgb_mapping = f32([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0.8, 0.8], [0.8, 0, 0.8],
                       [0.8, 0.8, 0]])
    tverts, tsigmas, tcolors = map(f32, Cuboid.cuboid_gauss(
        (-1, 1), (-1, 1), (-1, 1), 4000, colors=colors_0, percentage=0.7))

    verts_np, kn = efficient_cuboid()
    verts = f32(verts_np)
    n = verts.shape[0]
    sig_init = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy() * 2.0
    for i in range(6):
        sig_init[i * kn] /= np.sqrt(3.0)
    params = {"sig": f32(sig_init).requires_grad_(True)}
    idx_attr = f32(np.repeat(colors_0, kn, axis=0))  # (n, 6) one-hot face id

    focal = f32([[200.0, 200.0]])
    principal = f32([[image_size[0] // 2, image_size[1] // 2]])
    t_settings = dict(image_size=tuple(image_size), max_assign=50, max_point_per_bin=1500)
    # full-assign, near-zero threshold, no-coarse: every kernel on every ray
    g_settings = dict(image_size=tuple(image_size), max_assign=n, max_point_per_bin=-1,
                      thr_activation=1e-8)

    def target_map(R, T):
        with torch.no_grad():
            frag = render_pipeline(tverts, tsigmas, R, T, focal, principal, **t_settings)
            return interpolate_attr(frag, tcolors)

    def pred_map(sig, R, T):
        frag = render_pipeline(verts, to_sym(sig), R, T, focal, principal, **g_settings)
        return interpolate_attr(frag, idx_attr)

    # optax.adam(0.02, b1=0.8, b2=0.6): eps 1e-8 outside the square root
    opt = torch.optim.Adam([params["sig"]], lr=0.02, betas=(0.8, 0.6), eps=1e-8)

    fixed_views = [[-90, 0], [0, 0], [90, 0], [0, 90], [0, 180], [0, 270]]
    loss = None
    for i in range(iters):
        if i <= iters // 2:
            e, a = fixed_views[rng.randint(0, 6)]
        else:
            e, a = rng.randint(-60, 60), rng.randint(0, 360)
        R, T = look_at_view_transform(5, float(e), float(a), device=dev)
        t_map = target_map(R, T)
        opt.zero_grad(set_to_none=True)
        loss = (pred_map(params["sig"], R, T) - t_map).abs().mean()
        loss.backward()
        opt.step()
        if (i + 1) % 40 == 0:
            print(f"iter {i+1}: loss {loss.item():.5f}")

    R, T = look_at_view_transform(4, 20, 30, device=dev)
    with torch.no_grad():
        g_map = pred_map(params["sig"], R, T)
    img = torch.einsum("bhwk,kc->bhwc", g_map, rgb_mapping)
    save_image("efficient_cuboid", torch.clamp(img, 0, 1), out_dir)
    return loss.item()


if __name__ == "__main__":
    run(main, iters=320)
