"""voge_tpu_torch: the PyTorch + CUDA port of ``voge_tpu`` for NVIDIA Hopper.

Same module names as ``voge_tpu``; inside, PyTorch idiom (``nn.Module``
scenes and renderer, plain functions on tensors, explicit devices,
``torch.autograd.Function`` where a kernel needs a gradient).  A render and
its backward run hand-written CUDA kernels (``csrc/``): K1 coarse emission,
K2 streaming top-K select with fused weights and attribute image (over
emission-compacted rows, or over every Gaussian on the no-coarse path), K3
the fine backward with the weight fold and the attribute VJP (both spaces),
K3f attribute merge and K4b its backward.  ``sampler.sample_features``
pulls an image back onto the Gaussians through the two halves of K4b on
their own; ``ops.rasterize_coarse`` + ``ops.ray_tracing_fine`` are the
public two-stage tracer over per-bin candidate lists (K2's per-bin-list
entry).  ``models.ShapeFitter`` fits a scene with ``torch.optim`` on top of
the renderer.  ``parallel`` shards a render over a mesh of devices from one
process (``make_mesh``, ``render_pipeline_sharded``, the sharded helpers,
``DataParallelBatchifier``); ``voge_tpu_torch.demo`` holds the demos.  What the port creates lies on the card unless the caller
passes ``device="cpu"`` (``_device.py``); on CPU tensors each kernel's plain
PyTorch version runs instead.  Importing builds nothing; a
kernel is compiled by ``nvcc`` at its first launch.  The port imports
neither JAX nor ``voge_tpu``.
"""

__version__ = "0.1.0"

from voge_tpu_torch import aggregation, cameras, checkpoint, converter, interop, meshes, models
from voge_tpu_torch import camera_op as CameraOP
from voge_tpu_torch import oracle, parallel, timing
from voge_tpu_torch import ops
from voge_tpu_torch import rays, renderer, sampler, utils
from voge_tpu_torch.cameras import PerspectiveCameras, look_at_view_transform
from voge_tpu_torch.converter import (
    fixed_pointcloud_converter,
    get_vert_edge_length,
    ico_sphere,
    naive_point_cloud_converter,
    naive_vertices_converter,
    normal_mesh_converter,
)
from voge_tpu_torch.interop import (
    cameras_from_numpy,
    fitter_from_numpy,
    scene_from_numpy,
    scorer_from_numpy,
)
from voge_tpu_torch.meshes import GaussianMeshes, GaussianMeshesNaive
from voge_tpu_torch.models import PoseHypothesisScorer, ShapeFitter, refine_pose
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
from voge_tpu_torch.sampler import sample_features, scatter_max_weight
