"""Correlation cost volume (aanet_tpu/ops/cost_volume.py).

``cost[b, d, h, w] = mean_c L[b, c, h, w] * R[b, c, h, w - d]``, zero where
w < d, laid out [B, D, H, W] so the aggregation convs read D as channels.
The CUDA kernel is ``csrc/correlation.cu``. The difference and concat
volumes of the ablation presets are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from aanet_torch import _build

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def correlation_cost_volume_plain(
    left: torch.Tensor, right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Plain PyTorch correlation volume: the reference's shift-multiply
    loop over d (nets/cost.py:40-48)."""
    b, c, h, w = left.shape
    cost = left.new_zeros((b, max_disp, h, w))
    for d in range(max_disp):
        if d == 0:
            cost[:, 0] = (left * right).mean(1)
        elif d < w:
            cost[:, d, :, d:] = (left[..., d:] * right[..., :-d]).mean(1)
    return cost


def correlation_cost_volume(
    left: torch.Tensor, right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Correlation volume of left/right features [B, C, H, W] -> [B, D, H, W].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if left.shape != right.shape or left.ndim != 4:
        raise ValueError(
            f"correlation: left {tuple(left.shape)} and right {tuple(right.shape)} "
            "must both be [B, C, H, W]"
        )
    if left.device.type == "cpu":
        return correlation_cost_volume_plain(left, right, max_disp)
    _build.check_cuda_f32("correlation", left=left, right=right)
    b, c, h, w = left.shape
    cost = torch.empty((b, max_disp, h, w), dtype=torch.float32, device=left.device)
    _build.launch(
        "correlation", "aanet_correlation_f32", _ARGTYPES,
        _build.ptr(left), _build.ptr(right), _build.ptr(cost),
        b, c, h, w, max_disp, left.device.index, _build.stream(left),
    )
    correlation_cost_volume.launches += 1
    return cost


correlation_cost_volume.launches = 0
