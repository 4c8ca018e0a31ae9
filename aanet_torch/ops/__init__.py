"""Core ops. Each kernel op has a plain PyTorch twin (``*_plain``) in its
module; the op runs the twin for CPU tensors and its CUDA kernel for CUDA
tensors, and counts its kernel launches in ``<op>.launches``.

Callers reach the ops through their modules (``deform.modulated_deform_conv2d``
and so on), so a check can swap an op module's function for its twin.
"""
from aanet_torch.ops import cost_volume, deform, resize, softargmin, warp

KERNEL_OPS = (
    deform.modulated_deform_conv2d,
    cost_volume.correlation_cost_volume,
    softargmin.soft_argmin,
    warp.disp_warp,
)

__all__ = ["cost_volume", "deform", "resize", "softargmin", "warp", "KERNEL_OPS"]
