"""Models built on the renderer (counterpart of ``voge_tpu.models``): the
``ShapeFitter`` trainer.  ``models/pose.py`` waits for a later slice."""
from voge_tpu_torch.models.fitting import ShapeFitter

__all__ = ["ShapeFitter"]
