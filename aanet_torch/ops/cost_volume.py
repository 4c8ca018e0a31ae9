"""Cost volumes (aanet_tpu/ops/cost_volume.py).

* correlation: ``cost[b, d, h, w] = mean_c L[b, c, h, w] * R[b, c, h, w - d]``,
  laid out [B, D, H, W] so the aggregation convs read D as channels; the
  CUDA kernels (forward and backward) are ``csrc/correlation.cu``;
* difference: ``cost[b, c, d, h, w] = L[b, c, h, w] - R[b, c, h, w - d]``,
  [B, C, D, H, W];
* concat: ``[L ; R(w - d)]`` on the channel axis, [B, 2C, D, H, W].

Each is zero where w < d (both channel halves of the concat volume) and is
a ``torch.autograd.Function`` with gradients for both feature maps. The 4-D
volumes feed the 3-D convs of the PSMNet, StereoNet and GC-Net
aggregations; their CUDA kernels, forward and backward, are
``csrc/volume4d.cu``.
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


def _check(left, right, op="correlation"):
    if left.shape != right.shape or left.ndim != 4:
        raise ValueError(
            f"{op}: left {tuple(left.shape)} and right {tuple(right.shape)} "
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


# ---------------------------------------------------------------------------
# The 4-D volumes: difference and concat
# ---------------------------------------------------------------------------

# the kernel stages one L and one R row in shared memory (227 KB a block)
MAX_VOLUME_WIDTH = 232448 // 8


def difference_cost_volume_plain(
    left: torch.Tensor, right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Plain PyTorch difference volume [B, C, D, H, W]: the reference's
    loop over d (nets/cost.py:22-29)."""
    b, c, h, w = left.shape
    cost = left.new_zeros((b, c, max_disp, h, w))
    for d in range(min(max_disp, w)):
        cost[:, :, d, :, d:] = left[..., d:] - right[..., : w - d]
    return cost


def concat_cost_volume_plain(
    left: torch.Tensor, right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Plain PyTorch concat volume [B, 2C, D, H, W] (nets/cost.py:31-38),
    both halves zero where w < d as in the JAX package."""
    b, c, h, w = left.shape
    cost = left.new_zeros((b, 2 * c, max_disp, h, w))
    for d in range(min(max_disp, w)):
        cost[:, :c, d, :, d:] = left[..., d:]
        cost[:, c:, d, :, d:] = right[..., : w - d]
    return cost


def difference_cost_volume_backward_plain(grad, left, right):
    """dL[w] = sum_d g[d, w] and dR[w'] = -sum_d g[d, w' + d], over the
    pairs with w >= d."""
    w = left.shape[3]
    grad_left = torch.zeros_like(left)
    grad_right = torch.zeros_like(right)
    for d in range(min(grad.shape[2], w)):
        g = grad[:, :, d, :, d:]
        grad_left[..., d:] += g
        grad_right[..., : w - d] -= g
    return grad_left, grad_right


def concat_cost_volume_backward_plain(grad, left, right):
    """The same sums as the difference volume's, from the two channel
    halves of ``grad`` and with a plus for R."""
    c, w = left.shape[1], left.shape[3]
    grad_left = torch.zeros_like(left)
    grad_right = torch.zeros_like(right)
    for d in range(min(grad.shape[2], w)):
        grad_left[..., d:] += grad[:, :c, d, :, d:]
        grad_right[..., : w - d] += grad[:, c:, d, :, d:]
    return grad_left, grad_right


def difference_cost_volume_backward(grad, left, right):
    """Gradients (d left, d right) given the volume's gradient ``grad``
    [B, C, D, H, W]. A CPU tensor takes the plain version; a CUDA tensor
    launches ``aanet_difference_volume_backward_f32``."""
    return _volume_backward("difference", difference_cost_volume_backward_plain, grad, left, right)


def concat_cost_volume_backward(grad, left, right):
    """As ``difference_cost_volume_backward``, for the concat volume's
    ``grad`` [B, 2C, D, H, W] and ``aanet_concat_volume_backward_f32``."""
    return _volume_backward("concat", concat_cost_volume_backward_plain, grad, left, right)


def _volume_backward(kind, plain, grad, left, right):
    _check(left, right, f"{kind} volume backward")
    if left.device.type == "cpu":
        return plain(grad, left, right)
    _build.check_cuda_f32(f"{kind} volume backward", grad=grad, left=left, right=right)
    b, c, h, w = left.shape
    channels = 2 * c if kind == "concat" else c
    if grad.ndim != 5 or grad.shape[:2] != (b, channels) or grad.shape[3:] != (h, w):
        raise ValueError(
            f"{kind} volume backward: grad {tuple(grad.shape)} does not fit {tuple(left.shape)}"
        )
    grad_left = torch.empty_like(left)
    grad_right = torch.empty_like(right)
    _build.launch(
        "volume4d", f"aanet_{kind}_volume_backward_f32", _ARGTYPES,
        _build.ptr(grad), _build.ptr(grad_left), _build.ptr(grad_right),
        b, c, h, w, grad.shape[2], left.device.index, _build.stream(left),
    )
    wrapper = {"difference": difference_cost_volume_backward,
               "concat": concat_cost_volume_backward}[kind]
    wrapper.launches += 1
    return grad_left, grad_right


class _Volume(torch.autograd.Function):
    """The difference (``kind`` "difference") or concat ("concat") volume."""

    @staticmethod
    def forward(ctx, left, right, max_disp, kind):
        ctx.kind = kind
        ctx.save_for_backward(left, right)
        op, plain, channels = {
            "difference": (difference_cost_volume, difference_cost_volume_plain, 1),
            "concat": (concat_cost_volume, concat_cost_volume_plain, 2),
        }[kind]
        if left.device.type == "cpu":
            return plain(left, right, max_disp)
        _build.check_cuda_f32(f"{kind} volume", left=left, right=right)
        b, c, h, w = left.shape
        if w > MAX_VOLUME_WIDTH:
            raise ValueError(f"{kind} volume: width {w} exceeds the kernel's {MAX_VOLUME_WIDTH}")
        cost = torch.empty((b, channels * c, max_disp, h, w), dtype=torch.float32, device=left.device)
        _build.launch(
            "volume4d", f"aanet_{kind}_volume_f32", _ARGTYPES,
            _build.ptr(left), _build.ptr(right), _build.ptr(cost),
            b, c, h, w, max_disp, left.device.index, _build.stream(left),
        )
        op.launches += 1
        return cost

    @staticmethod
    def backward(ctx, grad):
        left, right = ctx.saved_tensors
        backward = {"difference": difference_cost_volume_backward,
                    "concat": concat_cost_volume_backward}[ctx.kind]
        return (*backward(grad.contiguous(), left, right), None, None)


def difference_cost_volume(
    left: torch.Tensor, right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Difference volume of left/right features [B, C, H, W] ->
    [B, C, D, H, W]. A CPU tensor takes the plain version; a CUDA tensor
    launches ``aanet_difference_volume_f32``."""
    _check(left, right, "difference volume")
    return _Volume.apply(left, right, max_disp, "difference")


def concat_cost_volume(
    left: torch.Tensor, right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Concat volume of left/right features [B, C, H, W] ->
    [B, 2C, D, H, W]. A CPU tensor takes the plain version; a CUDA tensor
    launches ``aanet_concat_volume_f32``."""
    _check(left, right, "concat volume")
    return _Volume.apply(left, right, max_disp, "concat")


def cost_volume(left, right, max_disp: int, feature_similarity: str = "correlation"):
    """Dispatch on the similarity (reference nets/cost.py:19-55)."""
    ops = {
        "correlation": correlation_cost_volume,
        "difference": difference_cost_volume,
        "concat": concat_cost_volume,
    }
    if feature_similarity not in ops:
        raise NotImplementedError(feature_similarity)
    return ops[feature_similarity](left, right, max_disp)


difference_cost_volume.launches = 0
concat_cost_volume.launches = 0
difference_cost_volume_backward.launches = 0
concat_cost_volume_backward.launches = 0
