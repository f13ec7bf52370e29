"""Models built on the renderer (counterpart of ``voge_tpu.models``): the
``ShapeFitter`` trainer and render-and-compare pose estimation."""
from voge_tpu_torch.models.fitting import ShapeFitter
from voge_tpu_torch.models.pose import (
    PoseHypothesisScorer,
    feature_similarity,
    pose_matrices,
    refine_pose,
)

__all__ = ["PoseHypothesisScorer", "ShapeFitter", "feature_similarity", "pose_matrices",
           "refine_pose"]
