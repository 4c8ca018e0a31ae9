"""Soft-argmin disparity estimation (aanet_tpu/ops/softargmin.py).

Softmax over the disparity axis, then the expectation against candidates
0..D-1; a matching cost (rather than a similarity) is negated first. The
op is a ``torch.autograd.Function``; the CUDA kernels (forward and
backward) are ``csrc/softargmin.cu``, their tilings chosen here per shape
and SM count (``forward_plan``, ``backward_plan``).

Both kernels also have a bfloat16 form (the JAX op under a bf16 compute
dtype, ``softargmin.py:28``, and the gradient ``jax.vjp`` derives for it):
a bf16 volume, the softmax, the expectation and their backward in
float32, a float32 disparity and its float32 gradient, the volume's
gradient rounded to bf16 once (``aanet_softargmin_bf16``, a kernel of its
own with its plan, ``forward_plan_bf16``; ``aanet_softargmin_backward_bf16``,
whose slab holds the volume raw, 2 bytes a value, and has a plan of its
own, ``backward_plan_bf16``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from aanet_torch import _build
from aanet_torch._build import SM_SMEM_BYTES, SMEM_BYTES

# cost, out, batch, depth, plane, negate, the plan's three, device, stream
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
# grad, cost, grad_cost, then as the forward's
_BWD_ARGTYPES = [ctypes.c_void_p] + _ARGTYPES

# The kernels' constants (csrc/softargmin.cu): the candidates of a slice a
# thread loads before its first expf (UNROLL), the forward's tile of pixels
# (FWD_TILE: 32 quads of 4, one warp a slice), the backward's tiles, and each
# kernel's __launch_bounds__(MAX_THREADS, MIN_BLOCKS), which cap a thread's
# registers
UNROLL = 8
FWD_TILE = 128
FWD_MAX_THREADS = 256
FWD_MIN_BLOCKS = 4
BWD_TILES = (32, 64, 128, 256)
BWD_THREADS = (64, 128, 256)  # the block sizes the backward's plans consider
BWD_MAX_THREADS = 256
BWD_MIN_BLOCKS = 4
# the plans' picks (tools/torch_softargmin_sweep.py on an H100): the
# forward's slices at most FWD_SLICES; the backward's tile BWD_TILE, with
# BWD_SLICES[1] slices where D reaches BWD_DEEP or the grid is short of
# BWD_SM_BLOCKS blocks an SM, else BWD_SLICES[0]; where the plane is not a
# multiple of 4, the tile BWD_ODD_TILE with BWD_SLICES[1] slices
FWD_SLICES = 4
BWD_TILE = 64
BWD_ODD_TILE = 128
BWD_SLICES = (4, 8)
BWD_DEEP = 96
BWD_SM_BLOCKS = 8
# The bf16 forward's (softargmin_fwd_bf16_kernel): a tile of BF16_TILE pixels
# (32 octets of 8, one warp a slice), 1 to 8 slices, its __launch_bounds__
# (BF16_MIN_BLOCKS an SM where rows are read 16 bytes wide, else
# BF16_ODD_MIN_BLOCKS: the builds that take a value a load need more
# registers);
# its plan's pick (tools/torch_softargmin_sweep.py --dtype bfloat16 on an
# H100): slices of at most BF16_SHORT candidates where the grid has fewer
# than BF16_SM_TILES tiles an SM, else at most BF16_LONG; where the plane is
# not a multiple of 8 (a value a load), BF16_ODD_SLICES
BF16_TILE = 256
BF16_SLICES = (1, 2, 4, 8)
BF16_MAX_THREADS = 256
BF16_MIN_BLOCKS, BF16_ODD_MIN_BLOCKS = 3, 2
BF16_SHORT, BF16_LONG = 8, 24
BF16_SM_TILES = 3
BF16_ODD_SLICES = 2


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class ForwardPlan(NamedTuple):
    """How ``aanet_softargmin_f32`` (and ``aanet_softargmin_bf16``, with its
    own tile) cuts one volume: a block takes ``tile`` pixels of one batch
    element's plane and all D, split into ``slices`` ranges of
    ceil(D / slices) candidates, one warp each. ``threads`` a
    block, ``smem_bytes`` of shared memory, ``blocks`` in the grid."""

    tile: int
    slices: int
    threads: int
    smem_bytes: int
    blocks: int


class BackwardPlan(NamedTuple):
    """How ``aanet_softargmin_backward_f32`` cuts one gradient: a block
    stages ``tile`` pixels of one batch element's plane by all D in shared
    memory; ``slices`` ranges of D a quad of pixels, one thread each.
    ``threads`` a block, ``smem_bytes`` of shared memory, ``blocks`` in the
    grid."""

    tile: int
    slices: int
    threads: int
    smem_bytes: int
    blocks: int


def _fwd_smem(slices: int) -> int:
    """Bytes of the forward's shared memory (``fwd_smem_bytes`` in the
    kernel): the slices' merge slots [slices][2][tile], none for one slice.
    The kernel refuses a plan whose ``smem_bytes`` differ."""
    return 4 * 2 * FWD_TILE * slices if slices > 1 else 0


def _fwd_bf16_smem(slices: int) -> int:
    """Bytes of the bf16 forward's shared memory (``fwd_bf16_smem_bytes``):
    the slices' float32 merge slots [slices][3][BF16_TILE], none for one
    slice. The kernel refuses a plan whose ``smem_bytes`` differ."""
    return 4 * 3 * BF16_TILE * slices if slices > 1 else 0


def _bwd_smem(tile: int, depth: int, slices: int, value_bytes: int = 4) -> int:
    """Bytes of the backward's shared memory (``bwd_smem_bytes``; the bf16
    form's ``bwd_smem_bytes_bf16``): the slab [depth][tile] of
    ``value_bytes`` a value (4: float32; 2: the bf16 form's raw values) and
    the slices' float32 merge slots [slices][2][tile]. The kernel refuses a
    plan whose ``smem_bytes`` differ."""
    return value_bytes * tile * depth + 4 * 2 * tile * slices


def forward_plans(batch: int, depth: int, plane: int) -> list[ForwardPlan]:
    """Every tiling the forward kernel takes: 1 to FWD_MAX_THREADS / 32
    slices, never more than D has candidates (one at D = 0)."""
    blocks = batch * _ceil_div(plane, FWD_TILE)
    return [ForwardPlan(FWD_TILE, s, FWD_TILE // 4 * s, _fwd_smem(s), blocks)
            for s in range(1, min(FWD_MAX_THREADS * 4 // FWD_TILE, max(depth, 1)) + 1)]


def backward_plans(batch: int, depth: int, plane: int, value_bytes: int = 4) -> list[BackwardPlan]:
    """Every tiling the backward kernel takes at ``depth`` > 0: blocks of
    BWD_THREADS threads (tile / 4 quads by the slices, no more slices than
    candidates), a block's shared memory, and an SM's with its reserve (a
    slab of ``value_bytes`` a value: 2 for the bf16 form)."""
    plans = []
    for tile in BWD_TILES:
        for threads in BWD_THREADS:
            slices = threads // (tile // 4)
            smem = _bwd_smem(tile, depth, slices, value_bytes)
            if 1 <= slices <= depth and smem <= SMEM_BYTES and smem + 1024 <= SM_SMEM_BYTES:
                plans.append(BackwardPlan(tile, slices, threads, smem,
                                          batch * _ceil_div(plane, tile)))
    return plans


@functools.lru_cache(maxsize=None)
def forward_plan(batch: int, depth: int, plane: int, sms: int) -> ForwardPlan:
    """The forward kernel's tiling for a volume [batch, depth, plane] on a
    card of ``sms`` SMs, of ``forward_plans``: the most slices, at most
    FWD_SLICES, whose ranges are whole chunks of UNROLL candidates (a chunk
    half masked costs a whole one); else ceil(D / UNROLL) slices, at most
    FWD_SLICES. The SM count does not move the pick: on an H100 no plan
    gained on the paths' short grids (``tools/torch_softargmin_sweep.py``
    times every plan; PERF.md §6)."""
    plans = forward_plans(batch, depth, plane)[:FWD_SLICES]
    whole = [p for p in plans if _ceil_div(depth, p.slices) % UNROLL == 0]
    return whole[-1] if whole else plans[min(len(plans), max(1, _ceil_div(depth, UNROLL))) - 1]


def forward_plans_bf16(batch: int, depth: int, plane: int) -> list[ForwardPlan]:
    """Every tiling the bf16 forward takes: a tile of BF16_TILE pixels a
    block, each of BF16_SLICES up to D's candidates (one at D = 0)."""
    blocks = batch * _ceil_div(plane, BF16_TILE)
    return [ForwardPlan(BF16_TILE, s, 32 * s, _fwd_bf16_smem(s), blocks)
            for s in BF16_SLICES if s <= max(depth, 1)]


@functools.lru_cache(maxsize=None)
def forward_plan_bf16(batch: int, depth: int, plane: int, sms: int) -> ForwardPlan:
    """The bf16 forward's tiling for a volume [batch, depth, plane] on a
    card of ``sms`` SMs, of ``forward_plans_bf16``: where the plane is a
    multiple of 8 (rows read 16 bytes wide), the fewest slices whose ranges
    hold at most BF16_SHORT candidates where the grid has fewer than
    BF16_SM_TILES tiles an SM (more warps for a short grid), else at most
    BF16_LONG (fewer merges); the most, 8, where none do. Where it is not,
    BF16_ODD_SLICES (a warp's loads of a row are 32 values of 2 bytes, and
    more slices only add merges). ``tools/torch_softargmin_sweep.py --dtype
    bfloat16`` times it against every other plan."""
    plans = forward_plans_bf16(batch, depth, plane)
    if plane % 8:
        return plans[min(BF16_SLICES.index(BF16_ODD_SLICES), len(plans) - 1)]
    most = BF16_SHORT if plans[0].blocks < BF16_SM_TILES * sms else BF16_LONG
    return next((p for p in plans if _ceil_div(depth, p.slices) <= most), plans[-1])


@functools.lru_cache(maxsize=None)
def backward_plan(batch: int, depth: int, plane: int, sms: int) -> BackwardPlan:
    """The backward kernel's tiling for ``depth`` > 0 on a card of ``sms``
    SMs, of ``backward_plans``: where the plane is a multiple of 4 (rows
    copied 16 bytes at a time), the tile BWD_TILE with BWD_SLICES[1] slices
    (two warps) where D reaches BWD_DEEP or the grid holds fewer than
    BWD_SM_BLOCKS blocks an SM, else BWD_SLICES[0] (one warp): small blocks
    keep many slabs in flight (at D = 192 a 64-pixel slab takes 48 KB, four
    blocks an SM). Otherwise (4-byte copies and stores) the tile
    BWD_ODD_TILE with BWD_SLICES[1] slices: a warp's 32 quads then copy and
    store one 128-byte run of a row. Then the narrowest tile and the fewest
    threads. ``tools/torch_softargmin_sweep.py`` times it against every
    other plan. Raises if nothing fits."""
    plans = backward_plans(batch, depth, plane)
    if not plans:
        raise ValueError(
            f"soft_argmin backward: no tiling of {depth} candidates fits a block's "
            f"{SMEM_BYTES} bytes of shared memory")
    if plane % 4:
        tile, slices = BWD_ODD_TILE, BWD_SLICES[1]
    else:
        deep = depth >= BWD_DEEP or batch * _ceil_div(plane, BWD_TILE) < BWD_SM_BLOCKS * sms
        tile, slices = BWD_TILE, BWD_SLICES[deep]
    return min(plans, key=lambda p: (p.tile != tile, p.slices != slices, p.tile, p.threads))


@functools.lru_cache(maxsize=None)
def backward_plan_bf16(batch: int, depth: int, plane: int, sms: int) -> BackwardPlan:
    """The bf16 backward's tiling (``aanet_softargmin_backward_bf16``, whose
    slab holds raw bf16: 2 bytes a value) for ``depth`` > 0 on a card of
    ``sms`` SMs, of ``backward_plans(..., value_bytes=2)``: where the plane
    is a multiple of 4, the tile BWD_TILE with BWD_SLICES[1] slices where D
    reaches BWD_DEEP, else BWD_SLICES[0] (a short grid takes no more slices
    here: the halved slab keeps more blocks an SM); where it is not, the
    tile BWD_ODD_TILE with BWD_SLICES[1] slices. At D = 192 a 64-pixel slab
    takes 24 KB where the float32 form's took 48. On an H100 this was within
    4.7 % of the fastest bf16 plan at every path shape and 0.1 % over all of
    them (``tools/torch_softargmin_sweep.py --dtype bfloat16``). Raises if
    nothing fits."""
    plans = backward_plans(batch, depth, plane, value_bytes=2)
    if not plans:
        raise ValueError(
            f"soft_argmin backward: no bf16 tiling of {depth} candidates fits a block's "
            f"{SMEM_BYTES} bytes of shared memory")
    if plane % 4:
        tile, slices = BWD_ODD_TILE, BWD_SLICES[1]
    else:
        tile, slices = BWD_TILE, BWD_SLICES[depth >= BWD_DEEP]
    return min(plans, key=lambda p: (p.tile != tile, p.slices != slices, p.tile, p.threads))


def _sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _probabilities(cost, match_similarity):
    logits = cost if match_similarity else -cost
    return torch.softmax(logits.to(torch.promote_types(cost.dtype, torch.float32)), dim=1)


def soft_argmin_plain(cost: torch.Tensor, match_similarity: bool = True) -> torch.Tensor:
    """Plain PyTorch soft-argmin: [B, D, H, W] -> float32 [B, H, W]
    (float64 for a float64 volume); a bf16 volume is taken to float32."""
    prob = _probabilities(cost, match_similarity)
    candidates = torch.arange(cost.shape[1], dtype=prob.dtype, device=cost.device)
    return (prob * candidates.view(1, -1, 1, 1)).sum(1)


def soft_argmin_backward_plain(grad, cost, match_similarity=True):
    """Plain PyTorch gradient of the volume: s * g * p_d * (d - E[d]), with
    s = -1 for a matching cost; for a bf16 volume computed in float32 and
    rounded to bf16 once."""
    prob = _probabilities(cost, match_similarity)
    candidates = torch.arange(cost.shape[1], dtype=prob.dtype, device=cost.device).view(1, -1, 1, 1)
    mean = (prob * candidates).sum(1, keepdim=True)
    dcost = grad.unsqueeze(1) * prob * (candidates - mean)
    return (dcost if match_similarity else -dcost).to(cost.dtype)


def _forward(cost, match_similarity):
    if cost.device.type == "cpu":
        return soft_argmin_plain(cost, match_similarity)
    form = _build.form("soft_argmin", cost.dtype)
    _build.check_cuda("soft_argmin", cost=(cost, cost.dtype))
    b, d, h, w = cost.shape
    out = torch.empty((b, h, w), dtype=torch.float32, device=cost.device)
    planner = forward_plan_bf16 if form == "bf16" else forward_plan
    p = planner(b, d, h * w, _sms(cost))
    _build.launch(
        "softargmin", f"aanet_softargmin_{form}", _ARGTYPES,
        _build.ptr(cost), _build.ptr(out), b, d, h * w, int(not match_similarity),
        p.tile, p.slices, p.smem_bytes, cost.device.index, _build.stream(cost),
    )
    _build.count_launch(soft_argmin, form)
    return out


def soft_argmin_backward(grad: torch.Tensor, cost: torch.Tensor, match_similarity: bool = True):
    """Gradient of the volume [B, D, H, W] given the disparity's float32
    gradient ``grad`` [B, H, W], in the volume's dtype. A CPU tensor takes
    the plain version; a CUDA tensor launches
    ``aanet_softargmin_backward_f32`` with ``backward_plan``'s tiling or,
    for a bf16 volume, ``aanet_softargmin_backward_bf16`` with
    ``backward_plan_bf16``'s."""
    if cost.device.type == "cpu":
        return soft_argmin_backward_plain(grad, cost, match_similarity)
    form = _build.form("soft_argmin backward", cost.dtype)
    _build.check_cuda("soft_argmin backward", grad=(grad, torch.float32), cost=(cost, cost.dtype))
    b, d, h, w = cost.shape
    if grad.shape != (b, h, w):
        raise ValueError(f"soft_argmin backward: grad {tuple(grad.shape)}, expected {(b, h, w)}")
    grad_cost = torch.empty_like(cost)
    plan = (0,) * 3  # an empty volume: the kernel has nothing to write
    if grad_cost.numel():
        planner = backward_plan_bf16 if form == "bf16" else backward_plan
        p = planner(b, d, h * w, _sms(cost))
        plan = (p.tile, p.slices, p.smem_bytes)
    _build.launch(
        "softargmin", f"aanet_softargmin_backward_{form}", _BWD_ARGTYPES,
        _build.ptr(grad), _build.ptr(cost), _build.ptr(grad_cost), b, d, h * w,
        int(not match_similarity), *plan, cost.device.index, _build.stream(cost),
    )
    _build.count_launch(soft_argmin_backward, form)
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
      cost: [B, D, H, W] similarity (or cost, if match_similarity=False),
        float32 or bfloat16.
    Returns:
      disparity [B, H, W], float32, differentiable in ``cost``.

    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels.
    """
    if cost.ndim != 4:
        raise ValueError(f"soft_argmin: expected [B, D, H, W], got {tuple(cost.shape)}")
    return _SoftArgmin.apply(cost, match_similarity)


soft_argmin.launches = 0
soft_argmin.launches_bf16 = 0
soft_argmin_backward.launches = 0
soft_argmin_backward.launches_bf16 = 0
