"""Bilinear / nearest resize (aanet_tpu/ops/resize.py).

The JAX package re-implements ``F.interpolate`` as matmuls for the TPU;
the port calls ``F.interpolate`` itself: bilinear with
``align_corners=False`` and no antialias, and legacy ``nearest``
(src = floor(i * in / out)); the PSMNet cost upsampling is trilinear
``F.interpolate`` on [B, C, D, H, W].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] or [B, H, W] to ``out_hw``."""
    if x.ndim == 3:
        return resize_bilinear(x.unsqueeze(1), out_hw).squeeze(1)
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-neighbour resize of [B, C, H, W] (torch legacy 'nearest')."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="nearest")


def resize_trilinear(x: torch.Tensor, out_dhw) -> torch.Tensor:
    """Trilinear resize of a [B, C, D, H, W] volume to ``out_dhw``
    (align_corners=False, no antialias; aanet_tpu/ops/resize.py:91-108)."""
    if x.ndim != 5:
        raise ValueError(f"resize_trilinear: expected [B, C, D, H, W], got {tuple(x.shape)}")
    if tuple(x.shape[2:]) == tuple(out_dhw):
        return x
    return F.interpolate(x, size=tuple(out_dhw), mode="trilinear", align_corners=False)


def upsample_disparity(disp: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear-upsample a [B, H, W] disparity map and rescale its values
    by the width ratio (disparities are horizontal pixel offsets)."""
    if tuple(disp.shape[1:]) == tuple(out_hw):
        return disp
    return resize_bilinear(disp, out_hw) * (out_hw[1] / disp.shape[2])
