"""Write ``voge_tpu``'s result for the texture-extraction chain at full width
(``bench.py:189-231``): ``ico_sphere(5)`` (10,242 Gaussians) through
``naive_vertices_converter(percentage=0.5, max_sig_rate=2)``, one view
(``look_at_view_transform(dist=3, elev=0.1, azim=0.6, degrees=False)``, focal
1800, principal (336, 128)), 256x672, K = 80, default coarse geometry, a
random image from ``np.random.RandomState(0)``:

    frag = render_pipeline(verts, sigmas, R, T, focal, principal, image_size=(256, 672),
                           max_assign=80, cam_ctx=precompute_camera_ctx(...))
    feat, wsum = sample_features(frag, image, n_vert)
    texture = feat / (1e-8 + wsum[:, None])
    out = to_white_background(frag, texture)

run with JAX on the CPU (about 12 s and 5 GB).  Stored small: ``valid_num``
(256, 672) uint8 (the selections, by their count per pixel), ``wsum``
(10242,) and ``texture`` (10242, 3) float32, and every second row and column
(``STRIDE``) of the re-rendered ``image`` (128, 336, 3) and of ``weight_sum``
(128, 336), the silhouette before its clamp, in float32; ``overflow`` (0:
nothing dropped).

    JAX_PLATFORMS=cpu python tests/data/make_voge_tpu_golden_texture.py

``tests/test_torch_cuda_paths.py`` holds the PyTorch port's texture path on
the GPU against this file (the GPU machine has no JAX); ``tests/test_torch_sampler.py``
regenerates it and asserts that it is current.
"""
from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "voge_tpu_golden_texture_256x672.npz"
HW, K, STRIDE = (256, 672), 80, 2


def scene():
    """(verts, isigmas, R, T, focal, principal, image) as numpy arrays."""
    from voge_tpu.cameras import look_at_view_transform
    from voge_tpu.converter.converters import naive_vertices_converter
    from voge_tpu.converter.shapes import ico_sphere

    v, f = ico_sphere(5)
    verts, isig, _ = naive_vertices_converter(v, f, percentage=0.5, max_sig_rate=2)
    R, T = look_at_view_transform(dist=3, elev=0.1, azim=0.6, degrees=False)
    focal = np.asarray([[1800.0, 1800.0]], np.float32)
    principal = np.asarray([[336.0, 128.0]], np.float32)
    image = np.random.RandomState(0).uniform(size=(1,) + HW + (3,)).astype(np.float32)
    return (np.asarray(verts, np.float32), np.asarray(isig, np.float32),
            np.asarray(R, np.float32), np.asarray(T, np.float32), focal, principal, image)


def chain(verts, isig, R, T, focal, principal, image, hw=HW, k=K):
    """The chain above on ``voge_tpu``; a dict of numpy arrays."""
    import jax.numpy as jnp

    from voge_tpu.renderer import (
        get_overflow_points, precompute_camera_ctx, render_pipeline, to_white_background,
    )
    from voge_tpu.sampler import sample_features

    n_vert = verts.shape[0]
    ctx = precompute_camera_ctx(R, T, focal, principal, hw, int(n_vert), max_assign=k)
    frag = render_pipeline(jnp.asarray(verts), jnp.asarray(isig), R, T, focal, principal,
                           image_size=hw, max_assign=k, cam_ctx=ctx)
    feat, wsum = sample_features(frag, jnp.asarray(image), n_vert=n_vert)
    texture = feat / (1e-8 + wsum[:, None])
    out = to_white_background(frag, texture)
    return dict(valid_num=np.asarray(frag.valid_num[0], np.uint8),
                wsum=np.asarray(wsum, np.float32),
                texture=np.asarray(texture, np.float32),
                image=np.asarray(out[0, ::STRIDE, ::STRIDE], np.float32),
                weight_sum=np.asarray(frag.vert_weight.sum(-1)[0, ::STRIDE, ::STRIDE],
                                      np.float32),
                overflow=np.int32(get_overflow_points(frag)))


def golden():
    return chain(*scene())


if __name__ == "__main__":
    np.savez_compressed(PATH, **golden())
