"""Training losses of GeoMatch (counterpart of gdm_tpu/losses)."""

from gdm_tpu_torch.losses.awl import AutomaticWeightedLoss
from gdm_tpu_torch.losses.circle import circle_loss, masked_logsumexp
from gdm_tpu_torch.losses.focal import focal_loss
from gdm_tpu_torch.losses.matching import (
    grid_matching_loss,
    matching_positive_mask,
    matching_positive_mask_depth_scaled,
    matching_positive_mask_sym,
    pointwise_matching_loss,
)

__all__ = ["AutomaticWeightedLoss", "circle_loss", "focal_loss",
           "grid_matching_loss", "masked_logsumexp",
           "matching_positive_mask", "matching_positive_mask_depth_scaled",
           "matching_positive_mask_sym", "pointwise_matching_loss"]
