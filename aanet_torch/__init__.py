"""PyTorch/CUDA port of the AANet stereo network for NVIDIA Hopper.

Mirrors ``aanet_tpu/`` module for module (``config``, ``ops``, ``models``,
``train``, ``parallel``, ``data``, ``utils``, ``infer``, ``cli``). Tensors are NCHW (NCDHW for the 4-D cost volumes).
The irregular ops (deformable conv, the correlation, difference and
concat volumes, soft-argmin, disparity warp) are hand-written CUDA
kernels under ``csrc/``; every other op is a dense PyTorch call. Each
kernel's wrapper runs the kernel for a CUDA tensor and its plain PyTorch
twin for a CPU tensor.
"""
