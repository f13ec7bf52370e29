"""Write ``voge_tpu``'s loss and gradients of the headline fitting step
(``bench.py:52-105``): ``jax.grad`` of ``mean((attr_img - 0.5)^2) +
mean(silhouette^2)`` with respect to verts, sigmas and colours, the colours
``(verts + 1) / 3`` fused through ``attrs=``, K = 20, the camera context
precomputed, camera ``look_at_view_transform(dist=6, elev=10, azim=70)``,
run with JAX on the CPU.  Two cases:

- ``voge_tpu_golden_grad_1k_128.npz``: the 1K cuboid (866 Gaussians) at
  128x128, focal 150;
- ``voge_tpu_golden_grad_10k_256.npz``: the 10K cuboid (9,602 Gaussians) at
  256x256, focal 300 (the headline).

    JAX_PLATFORMS=cpu python tests/data/make_voge_tpu_golden_grad.py

The GPU smoke check (``chip_smoke.py``) holds the PyTorch port's gradients
against them, since the GPU machine has no JAX; ``tests/test_torch_renderer.py``
regenerates them and asserts that the files are current.
"""
from pathlib import Path

import numpy as np

DIR = Path(__file__).resolve().parent
CASES = {  # file -> (requested Gaussians, image size, focal)
    "voge_tpu_golden_grad_1k_128.npz": (1000, (128, 128), 150.0),
    "voge_tpu_golden_grad_10k_256.npz": (10000, (256, 256), 300.0),
}


def golden(n_gauss, image_size, focal):
    import jax
    import jax.numpy as jnp

    from voge_tpu.cameras import look_at_view_transform
    from voge_tpu.converter import Cuboid
    from voge_tpu.renderer import get_silhouette, precompute_camera_ctx, render_pipeline

    g = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), n_gauss, percentage=0.6,
                            as_obj=True)
    verts, sigmas = jnp.asarray(g.verts), jnp.asarray(g.sigmas)
    colors = jnp.asarray((np.asarray(g.verts) + 1) / 3)
    R, T = look_at_view_transform(dist=6, elev=10, azim=70)
    f = np.asarray([[focal, focal]], np.float32)
    pp = np.asarray([[image_size[1] / 2, image_size[0] / 2]], np.float32)
    ctx = precompute_camera_ctx(R, T, f, pp, tuple(image_size), verts.shape[0],
                                max_assign=20)

    def render(verts, sigmas, colors):
        return render_pipeline(verts, sigmas, R, T, f, pp, image_size=tuple(image_size),
                               max_assign=20, cam_ctx=ctx, attrs=colors)

    def loss_fn(verts, sigmas, colors):
        frag = render(verts, sigmas, colors)
        return (jnp.mean((frag.attr_img - 0.5) ** 2)
                + jnp.mean(get_silhouette(frag) ** 2))

    assert int(render(verts, sigmas, colors).overflow_points) == 0
    loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(verts, sigmas, colors)
    return dict(loss=np.float32(loss),
                **{f"grad_{k}": np.asarray(v, np.float32)
                   for k, v in zip(("verts", "sigmas", "colors"), grads)})


if __name__ == "__main__":
    for name, case in CASES.items():
        np.savez_compressed(DIR / name, **golden(*case))
