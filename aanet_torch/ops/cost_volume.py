"""Correlation cost volume (aanet_tpu/ops/cost_volume.py).

``cost[b, d, h, w] = mean_c L[b, c, h, w] * R[b, c, h, w - d]``, zero where
w < d, laid out [B, D, H, W] so the aggregation convs read D as channels.
The op is a ``torch.autograd.Function`` with gradients for both feature
maps; the CUDA kernels (forward and backward) are ``csrc/correlation.cu``.
The difference and concat volumes of the ablation presets are not ported
yet.
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
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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


def correlation_cost_volume_backward_plain(grad, left, right):
    """Plain PyTorch gradients of the volume for (left, right):
    dL[c, w] = sum_d g[d, w] R[c, w-d] / C and dR[c, w'] = sum_d
    g[d, w'+d] L[c, w'+d] / C, over the pairs with w >= d."""
    b, c, h, w = left.shape
    grad_left = torch.zeros_like(left)
    grad_right = torch.zeros_like(right)
    for d in range(min(grad.shape[1], w)):
        g = grad[:, d : d + 1, :, d:] / c
        grad_left[..., d:] += g * right[..., : w - d]
        grad_right[..., : w - d] += g * left[..., d:]
    return grad_left, grad_right


def _check(left, right):
    if left.shape != right.shape or left.ndim != 4:
        raise ValueError(
            f"correlation: left {tuple(left.shape)} and right {tuple(right.shape)} "
            "must both be [B, C, H, W]"
        )


def _forward(left, right, max_disp):
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


def correlation_cost_volume_backward(grad, left, right):
    """Gradients (d left, d right) given the volume's gradient ``grad``
    [B, D, H, W]. A CPU tensor takes the plain version; a CUDA tensor
    launches ``aanet_correlation_backward_f32``."""
    _check(left, right)
    if left.device.type == "cpu":
        return correlation_cost_volume_backward_plain(grad, left, right)
    _build.check_cuda_f32("correlation backward", grad=grad, left=left, right=right)
    b, c, h, w = left.shape
    if grad.shape[0] != b or grad.shape[2:] != (h, w):
        raise ValueError(f"correlation backward: grad {tuple(grad.shape)} does not fit {tuple(left.shape)}")
    grad_left = torch.empty_like(left)
    grad_right = torch.empty_like(right)
    _build.launch(
        "correlation", "aanet_correlation_backward_f32", _BWD_ARGTYPES,
        _build.ptr(grad), _build.ptr(left), _build.ptr(right),
        _build.ptr(grad_left), _build.ptr(grad_right),
        b, c, h, w, grad.shape[1], left.device.index, _build.stream(left),
    )
    correlation_cost_volume_backward.launches += 1
    return grad_left, grad_right


class _Correlation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, left, right, max_disp):
        ctx.save_for_backward(left, right)
        return _forward(left, right, max_disp)

    @staticmethod
    def backward(ctx, grad):
        left, right = ctx.saved_tensors
        grad_left, grad_right = correlation_cost_volume_backward(grad.contiguous(), left, right)
        return grad_left, grad_right, None


def correlation_cost_volume(
    left: torch.Tensor, right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Correlation volume of left/right features [B, C, H, W] -> [B, D, H, W],
    differentiable in both.

    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels.
    """
    _check(left, right)
    return _Correlation.apply(left, right, max_disp)


correlation_cost_volume.launches = 0
correlation_cost_volume_backward.launches = 0
