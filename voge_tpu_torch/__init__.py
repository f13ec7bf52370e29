"""voge_tpu_torch: the PyTorch + CUDA port of ``voge_tpu`` for NVIDIA Hopper.

Same module names as ``voge_tpu``; inside, PyTorch idiom (``nn.Module``
scenes and renderer, plain functions on tensors, explicit devices).  The
render path runs three hand-written CUDA kernels (``csrc/``): K1 coarse
emission, K2 streaming top-K select with fused weights and attribute image,
K3f attribute merge.  On CPU tensors each kernel's plain PyTorch version
runs instead.  Importing builds nothing; a kernel is compiled by ``nvcc`` at
its first launch.  The port imports neither JAX nor ``voge_tpu``.
"""

__version__ = "0.1.0"

from voge_tpu_torch import aggregation, cameras, converter, interop, meshes, ops
from voge_tpu_torch import rays, renderer, utils
from voge_tpu_torch.cameras import PerspectiveCameras, look_at_view_transform
from voge_tpu_torch.interop import cameras_from_numpy, scene_from_numpy
from voge_tpu_torch.meshes import GaussianMeshes, GaussianMeshesNaive
from voge_tpu_torch.renderer import (
    CameraCtx,
    Fragments,
    GaussianRenderer,
    GaussianRenderSettings,
    get_overflow_points,
    get_silhouette,
    interpolate_attr,
    precompute_camera_ctx,
    render_pipeline,
    to_colored_background,
    to_white_background,
)
