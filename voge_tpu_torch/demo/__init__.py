"""The demos on the port (counterparts of the repository's ``demo/*.py``),
each runnable as ``python -m voge_tpu_torch.demo.<name>`` and each a
``main`` with the JAX script's signature, defaults and settings plus
``device=None`` (the card; ``"cpu"`` for the plain versions) and
``out_dir=None`` (``demo/output_torch`` of the repository):

| module | JAX script | exercises |
|---|---|---|
| ``render_cuboid`` | ``demo/render_cuboid.py`` | forward render, white background |
| ``render_bunny`` | ``demo/render_bunny.py`` | mesh converter, attribute compositing |
| ``render_pointclouds`` | ``demo/render_pointclouds.py`` | ~50K fixed-radius points, 320x320 |
| ``light_diffusion`` | ``demo/light_diffusion.py`` | normal maps, Lambert shading |
| ``shape_fitting`` | ``demo/shape_fitting.py`` | SGD through the no-coarse render |
| ``reason_occlusion`` | ``demo/reason_occlusion.py`` | Adam on translations through occlusion |
| ``efficient_cuboid`` | ``demo/efficient_cuboid.py`` | full covariances, K = every Gaussian |
| ``extract_texture`` | ``demo/extract_texture.py`` | ``sample_features`` and a re-render |

Importing the package or a demo builds no kernel.
"""
