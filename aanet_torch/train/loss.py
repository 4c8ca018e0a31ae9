"""Multi-scale disparity supervision loss (aanet_tpu/train/loss.py).

* pyramid weights [1/3, 2/3, 1, 1, 1] for 5 outputs (4: [1/3, 2/3, 1, 1];
  3: [1, 1, 1]; 1: [1]);
* low-resolution predictions are bilinearly upsampled to the ground
  truth's resolution and their values rescaled by W_gt / W_pred;
* masked smooth-L1 (beta 1) over the valid pixels;
* an optional pseudo-GT term on the pixels the ground truth leaves invalid;
* ``highest_loss_only`` keeps only the final full-resolution output.

Under data-parallel training every masked mean is a rank's share of the
global batch's (aanet_tpu/train/loss.py:35-37 divides by the valid
pixels of the whole batch): the rank's sum over its valid pixels divided
by the global count of valid pixels (``count``, ``pseudo_count``), so that
the shares of all ranks, and their gradients, add up to the global mean's.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from aanet_torch.ops.resize import upsample_disparity

PYRAMID_WEIGHTS = {
    5: (1 / 3, 2 / 3, 1.0, 1.0, 1.0),
    4: (1 / 3, 2 / 3, 1.0, 1.0),
    3: (1.0, 1.0, 1.0),
    1: (1.0,),
}


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber, beta 1)."""
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def masked_mean(value: torch.Tensor, mask: torch.Tensor,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of ``value`` over ``mask``, in float32 (float64 for a
    float64 value); with ``count``, the sum over ``mask`` divided by that
    count of valid values instead (this rank's share of a global mean)."""
    dt = torch.promote_types(value.dtype, torch.float32)
    m = mask.to(dt)
    total = m.sum() if count is None else count.to(dt)
    return (value.to(dt) * m).sum() / total.clamp_min(1.0)


def pyramid_loss(
    pred_pyramid: List[torch.Tensor],
    gt_disp: torch.Tensor,
    mask: torch.Tensor,
    pseudo_gt_disp: Optional[torch.Tensor] = None,
    pseudo_mask: Optional[torch.Tensor] = None,
    highest_loss_only: bool = False,
    count: Optional[torch.Tensor] = None,
    pseudo_count: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """Weighted multi-scale smooth-L1 loss.

    Args:
      pred_pyramid: [B, h_s, w_s] predictions, coarse to fine.
      gt_disp: [B, H, W].
      mask: [B, H, W] bool validity.
      pseudo_gt_disp, pseudo_mask: optional pseudo-GT supervision.
      count, pseudo_count: the global counts of ``mask`` and
        ``pseudo_mask`` under data-parallel training (``masked_mean``).
    Returns:
      (total_loss, aux) with aux['disp_loss'], aux['pseudo_loss'] and
      aux['pyramid_losses'].
    """
    if highest_loss_only:
        pred_pyramid = [pred_pyramid[-1]]
    n = len(pred_pyramid)
    if n not in PYRAMID_WEIGHTS:
        raise NotImplementedError(f"no weights for a pyramid of length {n}")
    gt_hw = tuple(gt_disp.shape[1:])
    disp_loss = pseudo_loss = 0.0
    per_scale = []
    for pred, w in zip(pred_pyramid, PYRAMID_WEIGHTS[n]):
        if tuple(pred.shape[1:]) != gt_hw:
            pred = upsample_disparity(pred, gt_hw)
        curr = masked_mean(smooth_l1(pred, gt_disp), mask, count)
        disp_loss = disp_loss + w * curr
        per_scale.append(curr)
        if pseudo_gt_disp is not None:
            pseudo_loss = pseudo_loss + w * masked_mean(smooth_l1(pred, pseudo_gt_disp), pseudo_mask,
                                                        pseudo_count)
    total = disp_loss + pseudo_loss
    return total, {"disp_loss": disp_loss, "pseudo_loss": pseudo_loss, "pyramid_losses": per_scale}
