"""Parallel execution (counterpart of ``voge_tpu.parallel``):

  - :mod:`voge_tpu_torch.parallel.batchify` -- memory-bounded chunked
    execution (the reference's ``Batchifier``, ``Utils.py:80-176``);
  - :mod:`voge_tpu_torch.parallel.shard`    -- sharding over a mesh of
    devices from one process: camera-axis data parallelism (the reference's
    ``DataParallelBatchifier``, ``Utils.py:179-333``), Gaussian-axis
    sharding with per-shard top-K and a merge, and its ring variant.
"""

from voge_tpu_torch.parallel.batchify import Batchifier, batchify  # noqa: F401
from voge_tpu_torch.parallel.shard import (  # noqa: F401
    DataParallelBatchifier,
    Mesh,
    interpolate_attr_sharded,
    make_mesh,
    render_pipeline_sharded,
    sample_features_sharded,
)
