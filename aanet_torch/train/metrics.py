"""Disparity metrics: EPE, D1, >N px, masked (aanet_tpu/train/metrics.py;
reference metric.py:7-57). With ``count`` (the global count of valid
pixels under data-parallel training) each is this rank's share of the
global metric (``loss.masked_mean``)."""
from __future__ import annotations

import torch

from aanet_torch.train.loss import masked_mean

EPSILON = 1e-8


def epe_metric(d_est, d_gt, mask, count=None):
    """Mean absolute disparity error over the valid pixels."""
    return masked_mean((d_est - d_gt).abs(), mask, count)


def d1_metric(d_est, d_gt, mask, count=None):
    """Share of valid pixels with error > 3 px and > 5 % of the ground truth."""
    e = (d_est - d_gt).abs()
    return masked_mean((e > 3.0) & (e / d_gt.clamp_min(EPSILON) > 0.05), mask, count)


def thres_metric(d_est, d_gt, mask, thres: float, count=None):
    """Share of valid pixels with error > ``thres`` px."""
    return masked_mean((d_est - d_gt).abs() > thres, mask, count)


def validity_mask(d_gt: torch.Tensor, max_disp: int) -> torch.Tensor:
    """(gt > 0) & (gt < max_disp), the KITTI convention (model.py:71)."""
    return (d_gt > 0) & (d_gt < max_disp)


def all_metrics(d_est, d_gt, mask, count=None) -> dict:
    """The reference's metric suite (model.py:327-341)."""
    out = {"epe": epe_metric(d_est, d_gt, mask, count),
           "d1": d1_metric(d_est, d_gt, mask, count)}
    for t in (1.0, 2.0, 3.0, 10.0, 20.0):
        out[f"thres{int(t)}"] = thres_metric(d_est, d_gt, mask, t, count)
    return out
