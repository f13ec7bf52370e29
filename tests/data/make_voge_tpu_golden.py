"""Write ``voge_tpu_golden_1k_128.npz``: ``voge_tpu``'s render of the 1K
cuboid (percentage 0.6) at 128x128, focal 150, principal (64, 64), K = 20,
camera ``look_at_view_transform(dist=6, elev=10, azim=70)``, colours
``(verts + 1) / 3`` fused through ``attrs=``, run with JAX on the CPU.

    JAX_PLATFORMS=cpu python tests/data/make_voge_tpu_golden.py

The card's tests (``tests/test_torch_cuda_paths.py``) hold the PyTorch port against it,
since the GPU machine has no JAX; ``tests/test_torch_renderer.py``
regenerates it and asserts that the file is unchanged.
"""
from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "voge_tpu_golden_1k_128.npz"


def golden():
    import jax.numpy as jnp

    from voge_tpu.cameras import look_at_view_transform
    from voge_tpu.converter import Cuboid
    from voge_tpu.renderer import render_pipeline

    g = Cuboid.cuboid_gauss((-1, 1), (-1, 1), (-1, 1), 1000, percentage=0.6,
                            as_obj=True)
    R, T = look_at_view_transform(dist=6, elev=10, azim=70)
    colors = (np.asarray(g.verts) + 1) / 3
    frag = render_pipeline(
        g.verts, g.sigmas, R, T, jnp.asarray([[150.0, 150.0]]),
        jnp.asarray([[64.0, 64.0]]), image_size=(128, 128), max_assign=20,
        attrs=jnp.asarray(colors),
    )
    assert int(frag.overflow_points) == 0
    return dict(
        vert_index=np.asarray(frag.vert_index, np.int32),
        vert_weight=np.asarray(frag.vert_weight, np.float32),
        attr_img=np.asarray(frag.attr_img, np.float32),
    )


if __name__ == "__main__":
    np.savez_compressed(PATH, **golden())
