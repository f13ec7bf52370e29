"""Write ``voge_tpu``'s loss, gradients and three ``ShapeFitter`` steps of the
ShapeFitting step (``bench.py:234-290``): ``ico_sphere(4)`` (2,562
Gaussians) through ``naive_vertices_converter(percentage=0.5)``, colours 0.5,
five views at ``dist 2.7``, elevations ``linspace(-10, 30, 5)`` and azimuths
``linspace(-60, 60, 5)``, focal 126, 128x128, K = 25, no coarse stage
(``max_point_per_bin=-1``), the loss ``mean((sil - 0)^2) + mean((rgb -
0.3)^2)`` through ``interpolate_attr`` and ``get_silhouette``, run with JAX
on the CPU:

- ``loss`` and ``grad_{verts,sigmas,colors}``: ``jax.value_and_grad`` of that
  loss at the start;
- ``fit_loss`` (3,) and ``fit_{verts,colors}``: the losses of three
  ``voge_tpu.models.ShapeFitter`` steps (default optimizer ``optax.sgd(0.8,
  momentum=0.9)``, verts and colours optimized, sigmas fixed, as in
  ``demo/shape_fitting.py``) on those five views, and the parameters after
  the third.

    JAX_PLATFORMS=cpu python tests/data/make_voge_tpu_golden_shapefit.py

``chip_smoke.py`` holds the PyTorch port's ShapeFitting step on the GPU
against this file (the GPU machine has no JAX); ``tests/test_torch_shapefit.py``
regenerates it and asserts that it is current.
"""
from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "voge_tpu_golden_shapefit_128.npz"
HW, K, B, STEPS = (128, 128), 25, 5, 3


def scene():
    """(verts, isigmas, colours, R, T, focal, principal, target_rgb,
    target_sil) as numpy arrays, without JAX: the shapes and converters are
    numpy in both packages."""
    from voge_tpu.converter.converters import naive_vertices_converter
    from voge_tpu.converter.shapes import ico_sphere

    v, f = ico_sphere(4)
    verts, isig, _ = naive_vertices_converter(v, f, percentage=0.5)
    colors = np.full((verts.shape[0], 3), 0.5, np.float32)
    focal = np.full((B, 2), 126.0, np.float32)
    principal = np.full((B, 2), 64.0, np.float32)
    t_rgb = np.full((B,) + HW + (3,), 0.3, np.float32)
    t_sil = np.zeros((B,) + HW, np.float32)
    return verts, isig, colors, focal, principal, t_rgb, t_sil


def cameras():
    """R (B, 3, 3), T (B, 3) of ``bench.py:256-259``."""
    from voge_tpu.cameras import look_at_view_transform

    R, T = look_at_view_transform(dist=[2.7] * B, elev=list(np.linspace(-10, 30, B)),
                                  azim=list(np.linspace(-60, 60, B)))
    return np.asarray(R, np.float32), np.asarray(T, np.float32)


def golden():
    import jax
    import jax.numpy as jnp

    from voge_tpu.models import ShapeFitter
    from voge_tpu.renderer import get_silhouette, interpolate_attr, render_pipeline

    verts, isig, colors, focal, principal, t_rgb, t_sil = scene()
    R, T = cameras()

    def loss_fn(verts, sigmas, colors):
        frag = render_pipeline(verts, sigmas, R, T, focal, principal, image_size=HW,
                               max_assign=K, max_point_per_bin=-1)
        rgb = interpolate_attr(frag, colors)
        sil = get_silhouette(frag)
        return jnp.mean((sil - t_sil) ** 2) + jnp.mean((rgb - t_rgb) ** 2)

    loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(
        jnp.asarray(verts), jnp.asarray(isig), jnp.asarray(colors))
    out = dict(loss=np.float32(loss),
               **{f"grad_{k}": np.asarray(g, np.float32)
                  for k, g in zip(("verts", "sigmas", "colors"), grads)})

    fitter = ShapeFitter({"verts": jnp.asarray(verts), "colors": jnp.asarray(colors)},
                         {"sigmas": jnp.asarray(isig)}, image_size=HW,
                         focal=focal[0], principal=principal[0], max_assign=K)
    out["fit_loss"] = np.asarray([fitter.step(R, T, t_rgb, t_sil) for _ in range(STEPS)],
                                 np.float32)
    for k in ("verts", "colors"):
        out[f"fit_{k}"] = np.asarray(fitter.params[k], np.float32)
    return out


if __name__ == "__main__":
    np.savez_compressed(PATH, **golden())
