"""Soft-argmin disparity estimation (aanet_tpu/ops/softargmin.py).

Softmax over the disparity axis, then the expectation against candidates
0..D-1; a matching cost (rather than a similarity) is negated first. The
CUDA kernel is ``csrc/softargmin.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from aanet_torch import _build

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def soft_argmin_plain(cost: torch.Tensor, match_similarity: bool = True) -> torch.Tensor:
    """Plain PyTorch soft-argmin: [B, D, H, W] -> float32 [B, H, W]."""
    logits = cost if match_similarity else -cost
    prob = torch.softmax(logits.float(), dim=1)
    candidates = torch.arange(cost.shape[1], dtype=torch.float32, device=cost.device)
    return (prob * candidates.view(1, -1, 1, 1)).sum(1)


def soft_argmin(cost: torch.Tensor, match_similarity: bool = True) -> torch.Tensor:
    """Expected disparity under softmax(cost) over dim 1.

    Args:
      cost: [B, D, H, W] similarity (or cost, if match_similarity=False).
    Returns:
      disparity [B, H, W], float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if cost.ndim != 4:
        raise ValueError(f"soft_argmin: expected [B, D, H, W], got {tuple(cost.shape)}")
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


soft_argmin.launches = 0
