"""Compute core of the port: the coarse stage, the fine stage and its
backward, and the hand-written CUDA kernels with their plain PyTorch versions
(``cuda_coarse``: K1 emission, ``cuda_fine``: K2 select and its global and
per-bin-list entries, ``cuda_fine_bwd``: K3 fine backward and its global
entry and the weight fold, ``cuda_attr``: K3f attribute merge, K4b its
backward and the two halves of it).  Importing builds nothing: each kernel
is compiled at its first launch."""
from voge_tpu_torch.ops.coarse import coarse_bin_config, rasterize_coarse  # noqa: F401
from voge_tpu_torch.ops.fine import ray_tracing, ray_tracing_fine  # noqa: F401
