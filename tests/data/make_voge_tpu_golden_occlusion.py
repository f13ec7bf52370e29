"""Write ``voge_tpu``'s occlusion fitting step (``bench.py:140-186``,
``demo/ReasonOcclusion.py:52-118``): two ``cuboid_gauss`` cuboids (4,000 and
3,000 requested, 6,778 kept; the first shifted by (0.5, 0, 1)), 400x400,
K = 60, ``max_point_per_bin=1500``, camera ``look_at_view_transform(5, 10,
20)``, focal 300, principal (200, 200), the camera context precomputed; the
loss ``mean((interpolate_attr(frag, colors) - 0.5)^2) + mean(silhouette^2)``
and its gradients for verts, sigmas and colours, run with JAX on the CPU:

- ``loss``, ``grad_{verts,sigmas,colors}`` (float32);
- ``overflow`` (0: no bin of ``voge_tpu``'s CPU coarse stage truncated) and
  ``valid_hist`` (K + 1,): how many pixels hold 0 .. K selections;
- the selections' digest: ``valid_num`` (H, W) and ``id_sum`` (H, W), the sum
  of each pixel's selected ids (a pixel agrees when both are equal).

    JAX_PLATFORMS=cpu python tests/data/make_voge_tpu_golden_occlusion.py

``tests/test_torch_cuda_paths.py`` holds the PyTorch port's step on the GPU
against this file
(the GPU machine has no JAX); ``tests/test_torch_occlusion.py`` regenerates
it and asserts that it is current (a test marked ``slow``).
"""
from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "voge_tpu_golden_occlusion_400.npz"
HW, K, MPPB, FOCAL = (400, 400), 60, 1500, 300.0
COLORS0 = [[0, 0.2, 1], [0, 0.2, 1], [0, 1, 0.2], [0, 1, 0.2], [0, 1, 1], [0, 1, 1]]
COLORS1 = [[1, 0.2, 0], [1, 0.2, 0], [1, 1, 0], [1, 1, 0], [0.2, 1, 0], [0.2, 1, 0]]


def scene(cuboid_gauss, n0=4000, n1=3000):
    """(verts, isigmas, colours) as numpy arrays from a package's numpy
    ``cuboid_gauss`` (both packages give the same arrays)."""
    v0, s0, c0 = cuboid_gauss((-0.8, 0.8), (-0.4, 0.4), (-0.6, 0.6), n0,
                              colors=np.array(COLORS0), percentage=0.7)
    v1, s1, c1 = cuboid_gauss((-1, 1), (-1, 1), (-0.3, 0.3), n1,
                              colors=np.array(COLORS1), percentage=0.7)
    verts = np.concatenate([v0 + np.array([[0.5, 0, 1]]), v1], 0).astype(np.float32)
    return (verts, np.concatenate([s0, s1], 0).astype(np.float32),
            np.concatenate([c0, c1], 0).astype(np.float32))


def cameras(look_at_view_transform, hw=HW, focal=FOCAL):
    """(R, T, focal, principal) as numpy arrays."""
    R, T = look_at_view_transform(dist=5, elev=10, azim=20)
    return (np.asarray(R, np.float32), np.asarray(T, np.float32),
            np.asarray([[focal, focal]], np.float32),
            np.asarray([[hw[1] / 2, hw[0] / 2]], np.float32))


def step(verts, sigmas, colors, cams, hw=HW, K=K, mppb=MPPB):
    """voge_tpu's loss, gradients and fragments of the step."""
    import jax
    import jax.numpy as jnp

    from voge_tpu.renderer import (get_silhouette, interpolate_attr, precompute_camera_ctx,
                                   render_pipeline)

    R, T, f, pp = cams
    ctx = precompute_camera_ctx(R, T, f, pp, tuple(hw), verts.shape[0], max_assign=K,
                                max_point_per_bin=mppb)

    def loss_fn(verts, sigmas, colors):
        frag = render_pipeline(verts, sigmas, R, T, f, pp, image_size=tuple(hw),
                               max_assign=K, max_point_per_bin=mppb, cam_ctx=ctx)
        img = interpolate_attr(frag, colors)
        return jnp.mean((img - 0.5) ** 2) + jnp.mean(get_silhouette(frag) ** 2), frag

    (loss, frag), grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(verts), jnp.asarray(sigmas), jnp.asarray(colors))
    return float(loss), [np.asarray(g, np.float32) for g in grads], frag


def digest(vert_index: np.ndarray):
    """(valid_num, id_sum) of (B, H, W, K) selections."""
    idx = np.asarray(vert_index)
    return ((idx >= 0).sum(-1).astype(np.int16),
            np.where(idx >= 0, idx, 0).astype(np.int64).sum(-1))


def golden():
    from voge_tpu.cameras import look_at_view_transform
    from voge_tpu.converter import Cuboid

    verts, sigmas, colors = scene(Cuboid.cuboid_gauss)
    loss, grads, frag = step(verts, sigmas, colors, cameras(look_at_view_transform))
    valid_num, id_sum = digest(frag.vert_index)
    return dict(loss=np.float32(loss), overflow=np.int64(int(frag.overflow_points)),
                valid_hist=np.bincount(valid_num.ravel(), minlength=K + 1),
                valid_num=valid_num[0], id_sum=id_sum[0],
                **{f"grad_{k}": g for k, g in zip(("verts", "sigmas", "colors"), grads)})


if __name__ == "__main__":
    np.savez_compressed(PATH, **golden())
