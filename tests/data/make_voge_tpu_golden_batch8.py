"""Write ``voge_tpu``'s headline fitting step at a batch of eight cameras
(``bench.py:324-361``, ``build_fwdbwd_batched``): the 10K cuboid (9,602
Gaussians), cameras at dist 6, elevations ``linspace(5, 25, 8)`` and
azimuths ``linspace(50, 90, 8)``, focal 300, 256x256, K = 20, colours
``(verts + 1) / 3`` through ``attrs=``, the camera context precomputed; the
loss ``mean((attr_img - 0.5)^2) + mean(silhouette^2)`` over the batch and its
gradients for verts, sigmas and colours, run with JAX on the CPU.

The eight images are independent renders of one scene and both means run
over equal-sized images, so the batch's loss is the mean of the per-camera
losses and its gradients the mean of theirs.  The file is made one camera
at a time, that way: ``voge_tpu``'s CPU chain at B = 8 holds eight times one
camera's hit tensors at once.

- ``loss``, ``grad_{verts,sigmas,colors}`` (float32), ``overflow`` (0);
- ``valid_num`` and ``id_sum`` (8, 256, 256): the selections' digest (the
  count and the sum of each pixel's selected ids, ``b * P + p``).

    JAX_PLATFORMS=cpu python tests/data/make_voge_tpu_golden_batch8.py

``tests/test_torch_cuda_paths.py`` holds the port's B = 8 step on the GPU
against this file;
``tests/test_torch_batch8.py`` asserts that it is current (marked ``slow``).
"""
from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "voge_tpu_golden_batch8_256.npz"
B, HW, K, N_GAUSS, FOCAL = 8, (256, 256), 20, 10000, 300.0


def cameras(look_at_view_transform, B=B, hw=HW, focal=FOCAL):
    """(R, T, focal, principal) of the batch as numpy arrays."""
    R, T = look_at_view_transform(dist=[6.0] * B, elev=list(np.linspace(5, 25, B)),
                                  azim=list(np.linspace(50, 90, B)))
    return (np.asarray(R, np.float32), np.asarray(T, np.float32),
            np.full((B, 2), focal, np.float32),
            np.tile(np.asarray([[hw[1] / 2, hw[0] / 2]], np.float32), (B, 1)))


def step(verts, sigmas, colors, cams, hw=HW, K=K):
    """voge_tpu's loss, gradients and fragments of the step on ``cams``."""
    import jax
    import jax.numpy as jnp

    from voge_tpu.renderer import get_silhouette, precompute_camera_ctx, render_pipeline

    R, T, f, pp = cams
    ctx = precompute_camera_ctx(R, T, f, pp, tuple(hw), verts.shape[0], max_assign=K)

    def loss_fn(verts, sigmas, colors):
        frag = render_pipeline(verts, sigmas, R, T, f, pp, image_size=tuple(hw),
                               max_assign=K, cam_ctx=ctx, attrs=colors)
        return (jnp.mean((frag.attr_img - 0.5) ** 2)
                + jnp.mean(get_silhouette(frag) ** 2)), frag

    (loss, frag), grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(verts), jnp.asarray(sigmas), jnp.asarray(colors))
    return float(loss), [np.asarray(g, np.float64) for g in grads], frag


def golden():
    from voge_tpu.cameras import look_at_view_transform
    from voge_tpu.converter import Cuboid

    g = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), N_GAUSS, percentage=0.6, as_obj=True)
    verts, sigmas = np.asarray(g.verts), np.asarray(g.sigmas)
    colors = ((verts + 1) / 3).astype(np.float32)
    cams = cameras(look_at_view_transform)
    P = verts.shape[0]
    loss, grads, overflow, valid, ids = 0.0, [0.0, 0.0, 0.0], 0, [], []
    for b in range(B):
        lb, gb, frag = step(verts, sigmas, colors, tuple(c[b:b + 1] for c in cams))
        loss += lb / B
        grads = [a + x / B for a, x in zip(grads, gb)]
        overflow += int(frag.overflow_points)
        idx = np.asarray(frag.vert_index)[0]
        valid.append((idx >= 0).sum(-1).astype(np.int16))
        ids.append(np.where(idx >= 0, idx + b * P, 0).astype(np.int64).sum(-1).astype(np.int32))
    return dict(loss=np.float32(loss), overflow=np.int64(overflow),
                valid_num=np.stack(valid), id_sum=np.stack(ids),
                **{f"grad_{k}": np.asarray(x, np.float32)
                   for k, x in zip(("verts", "sigmas", "colors"), grads)})


if __name__ == "__main__":
    np.savez_compressed(PATH, **golden())
