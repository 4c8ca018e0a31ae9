"""Core ops. Each kernel op is a ``torch.autograd.Function`` whose forward
and backward each have a plain PyTorch twin (``*_plain``) in its module;
the op runs the twins for CPU tensors and its CUDA kernels for CUDA
tensors. Every wrapper that launches a kernel counts its launches in
``<wrapper>.launches``, and those of its bf16 form, where it has one, in
``<wrapper>.launches_bf16`` (``_build.count_launch``).

Callers reach the ops through their modules (``deform.modulated_deform_conv2d``
and so on), so a check can swap an op module's function for its twin.
"""
from aanet_torch.ops import cost_volume, deform, resize, softargmin, warp

# the differentiable ops the model calls (each launches its forward kernel)
KERNEL_OPS = (
    deform.modulated_deform_conv2d,
    cost_volume.correlation_cost_volume,
    softargmin.soft_argmin,
    warp.disp_warp,
    cost_volume.difference_cost_volume,
    cost_volume.concat_cost_volume,
)
# the wrappers of the backward kernels, called by the ops' backward
BACKWARD_OPS = (
    deform.modulated_deform_conv2d_backward_data,
    deform.modulated_deform_conv2d_backward_weight,
    cost_volume.correlation_cost_volume_backward,
    softargmin.soft_argmin_backward,
    warp.disp_warp_backward,
    cost_volume.difference_cost_volume_backward,
    cost_volume.concat_cost_volume_backward,
)

__all__ = ["cost_volume", "deform", "resize", "softargmin", "warp", "KERNEL_OPS", "BACKWARD_OPS"]
