"""Soft-argmin disparity estimation (aanet_tpu/ops/softargmin.py).

Softmax over the disparity axis, then the expectation against candidates
0..D-1; a matching cost (rather than a similarity) is negated first. The
op is a ``torch.autograd.Function``; the CUDA kernels (forward and
backward) are ``csrc/softargmin.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from aanet_torch import _build

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_BWD_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _probabilities(cost, match_similarity):
    logits = cost if match_similarity else -cost
    return torch.softmax(logits.to(torch.promote_types(cost.dtype, torch.float32)), dim=1)


def soft_argmin_plain(cost: torch.Tensor, match_similarity: bool = True) -> torch.Tensor:
    """Plain PyTorch soft-argmin: [B, D, H, W] -> float32 [B, H, W]
    (float64 for a float64 volume)."""
    prob = _probabilities(cost, match_similarity)
    candidates = torch.arange(cost.shape[1], dtype=prob.dtype, device=cost.device)
    return (prob * candidates.view(1, -1, 1, 1)).sum(1)


def soft_argmin_backward_plain(grad, cost, match_similarity=True):
    """Plain PyTorch gradient of the volume: s * g * p_d * (d - E[d]), with
    s = -1 for a matching cost."""
    prob = _probabilities(cost, match_similarity)
    candidates = torch.arange(cost.shape[1], dtype=prob.dtype, device=cost.device).view(1, -1, 1, 1)
    mean = (prob * candidates).sum(1, keepdim=True)
    dcost = grad.unsqueeze(1) * prob * (candidates - mean)
    return (dcost if match_similarity else -dcost).to(cost.dtype)


def _forward(cost, match_similarity):
    if cost.device.type == "cpu":
        return soft_argmin_plain(cost, match_similarity)
    _build.check_cuda_f32("soft_argmin", cost=cost)
    b, d, h, w = cost.shape
    out = torch.empty((b, h, w), dtype=torch.float32, device=cost.device)
    _build.launch(
        "softargmin", "aanet_softargmin_f32", _ARGTYPES,
        _build.ptr(cost), _build.ptr(out), b, d, h * w, int(not match_similarity),
        cost.device.index, _build.stream(cost),
    )
    soft_argmin.launches += 1
    return out


def soft_argmin_backward(grad: torch.Tensor, cost: torch.Tensor, match_similarity: bool = True):
    """Gradient of the volume [B, D, H, W] given the disparity's gradient
    ``grad`` [B, H, W]. A CPU tensor takes the plain version; a CUDA tensor
    launches ``aanet_softargmin_backward_f32``."""
    if cost.device.type == "cpu":
        return soft_argmin_backward_plain(grad, cost, match_similarity)
    _build.check_cuda_f32("soft_argmin backward", grad=grad, cost=cost)
    b, d, h, w = cost.shape
    if grad.shape != (b, h, w):
        raise ValueError(f"soft_argmin backward: grad {tuple(grad.shape)}, expected {(b, h, w)}")
    grad_cost = torch.empty_like(cost)
    _build.launch(
        "softargmin", "aanet_softargmin_backward_f32", _BWD_ARGTYPES,
        _build.ptr(grad), _build.ptr(cost), _build.ptr(grad_cost), b, d, h * w,
        int(not match_similarity), cost.device.index, _build.stream(cost),
    )
    soft_argmin_backward.launches += 1
    return grad_cost


class _SoftArgmin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cost, match_similarity):
        ctx.match_similarity = match_similarity
        ctx.save_for_backward(cost)
        return _forward(cost, match_similarity)

    @staticmethod
    def backward(ctx, grad):
        (cost,) = ctx.saved_tensors
        return soft_argmin_backward(grad.contiguous(), cost, ctx.match_similarity), None


def soft_argmin(cost: torch.Tensor, match_similarity: bool = True) -> torch.Tensor:
    """Expected disparity under softmax(cost) over dim 1.

    Args:
      cost: [B, D, H, W] similarity (or cost, if match_similarity=False).
    Returns:
      disparity [B, H, W], float32, differentiable in ``cost``.

    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels.
    """
    if cost.ndim != 4:
        raise ValueError(f"soft_argmin: expected [B, D, H, W], got {tuple(cost.shape)}")
    return _SoftArgmin.apply(cost, match_similarity)


soft_argmin.launches = 0
soft_argmin_backward.launches = 0
