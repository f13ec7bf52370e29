"""Camera projection matrix (counterpart of ``voge_tpu/camera_op.py`` and the
reference ``VoGE/CameraOP.py``, which wraps pytorch3d's
``_get_sfm_calibration_matrix``): the SfM-style perspective calibration
matrix in the row-vector convention used throughout (``x_hom = x @ K``)."""
from __future__ import annotations

import torch

from voge_tpu_torch._device import resolve_device


def get_projection_transform(focal, principal_point, dtype=torch.float32,
                             device=None) -> torch.Tensor:
    """4x4 SfM calibration matrices (N, 4, 4), row-vector convention:

        x @ K = (fx x + px z, fy y + py z, 1, z)

    so dividing by the last coordinate gives (fx x/z + px, fy y/z + py, 1/z).

    :param focal: scalar, (N,), (N, 1) or (N, 2)
    :param principal_point: (N, 2)
    :param device: where the matrices go (None: the device of a tensor
        argument, else the card, ``_device.resolve_device``)
    """
    from voge_tpu_torch.cameras import _as_batched

    dev = resolve_device(device, focal, principal_point)
    f = _as_batched(focal, 2, dtype, dev)
    p = _as_batched(principal_point, 2, dtype, dev)
    n = max(f.shape[0], p.shape[0])
    f, p = f.expand(n, 2), p.expand(n, 2)
    K = torch.zeros((n, 4, 4), dtype=dtype, device=dev)
    K[:, 0, 0], K[:, 1, 1] = f[:, 0], f[:, 1]
    K[:, 2, 0], K[:, 2, 1] = p[:, 0], p[:, 1]
    K[:, 2, 3] = 1.0
    K[:, 3, 2] = 1.0
    return K
