"""Write ``voge_tpu``'s render above its kernels' K (its XLA select,
``voge_tpu/ops/fine.py:1334-1365``) on the 10K cuboid (9,602 Gaussians),
64x64, focal 75, camera ``look_at_view_transform(6, 10, 70)``, K = 200,
colours ``(verts + 1) / 3`` through ``attrs=``, in two modes:

- ``coarse``: thr 0.01 with the default coarse stage (12 pixels hold more
  than 128 selections);
- ``no_coarse``: thr 1e-8 with ``max_point_per_bin=-1`` (190 such pixels);

with the loss ``mean((attr_img - 0.5)^2) + mean(silhouette^2)`` and its
gradients for verts, sigmas and colours, run with JAX on the CPU.  Per mode
(keys prefixed ``<mode>_``): ``loss``, ``grad_{verts,sigmas,colors}``,
``overflow``, ``attr_img`` (64, 64, 3), ``silhouette`` (64, 64), and the
selections' digest ``valid_num`` / ``id_sum`` (64, 64).

    JAX_PLATFORMS=cpu python tests/data/make_voge_tpu_golden_large_k.py

``tests/test_torch_cuda_paths.py`` holds the port's dense route on the GPU
against this file;
``tests/test_torch_dense.py`` asserts that it is current.
"""
from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "voge_tpu_golden_large_k_64.npz"
HW, K, N_GAUSS, FOCAL = (64, 64), 200, 10000, 75.0
MODES = {"coarse": (0.01, None), "no_coarse": (1e-8, -1)}   # mode -> (thr, max_point_per_bin)


def step(verts, sigmas, colors, cams, thr, mppb, hw=HW, K=K):
    """voge_tpu's loss, gradients and fragments of one mode."""
    import jax
    import jax.numpy as jnp

    from voge_tpu.renderer import get_silhouette, render_pipeline

    R, T, f, pp = cams

    def loss_fn(verts, sigmas, colors):
        frag = render_pipeline(verts, sigmas, R, T, f, pp, image_size=tuple(hw), max_assign=K,
                               thr_activation=thr, max_point_per_bin=mppb, attrs=colors)
        sil = get_silhouette(frag)
        return jnp.mean((frag.attr_img - 0.5) ** 2) + jnp.mean(sil ** 2), (frag, sil)

    (loss, (frag, sil)), grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(verts), jnp.asarray(sigmas), jnp.asarray(colors))
    return float(loss), [np.asarray(g, np.float32) for g in grads], frag, np.asarray(sil)


def scene():
    """(verts, isigmas, colours, (R, T, focal, principal)) as numpy arrays."""
    from voge_tpu.cameras import look_at_view_transform
    from voge_tpu.converter import Cuboid

    g = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), N_GAUSS, percentage=0.6, as_obj=True)
    verts, sigmas = np.asarray(g.verts), np.asarray(g.sigmas)
    colors = ((verts + 1) / 3).astype(np.float32)
    R, T = look_at_view_transform(dist=6, elev=10, azim=70)
    cams = (np.asarray(R), np.asarray(T), np.asarray([[FOCAL, FOCAL]], np.float32),
            np.asarray([[HW[1] / 2, HW[0] / 2]], np.float32))
    return verts, sigmas, colors, cams


def run():
    """mode -> voge_tpu's (loss, grads, fragments, silhouette)."""
    verts, sigmas, colors, cams = scene()
    return {mode: step(verts, sigmas, colors, cams, thr, mppb)
            for mode, (thr, mppb) in MODES.items()}


def pack(results):
    """The file's arrays from :func:`run`'s results."""
    out = {}
    for mode, (loss, grads, frag, sil) in results.items():
        idx = np.asarray(frag.vert_index)[0]
        out.update({f"{mode}_loss": np.float32(loss),
                    f"{mode}_overflow": np.int64(int(frag.overflow_points)),
                    f"{mode}_attr_img": np.asarray(frag.attr_img, np.float32)[0],
                    f"{mode}_silhouette": sil[0].astype(np.float32),
                    f"{mode}_valid_num": (idx >= 0).sum(-1).astype(np.int16),
                    f"{mode}_id_sum": np.where(idx >= 0, idx, 0).astype(np.int64).sum(-1)})
        out.update({f"{mode}_grad_{k}": x for k, x in zip(("verts", "sigmas", "colors"), grads)})
    return out


def golden():
    return pack(run())


if __name__ == "__main__":
    np.savez_compressed(PATH, **golden())
