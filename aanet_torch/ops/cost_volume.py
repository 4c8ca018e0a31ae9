"""Cost volumes (aanet_tpu/ops/cost_volume.py).

* correlation: ``cost[b, d, h, w] = mean_c L[b, c, h, w] * R[b, c, h, w - d]``,
  laid out [B, D, H, W] so the aggregation convs read D as channels; the
  CUDA kernels (forward and backward) are ``csrc/correlation.cu``, their
  tilings chosen here per shape and SM count (``forward_plan``,
  ``backward_plan``);
* difference: ``cost[b, c, d, h, w] = L[b, c, h, w] - R[b, c, h, w - d]``,
  [B, C, D, H, W];
* concat: ``[L ; R(w - d)]`` on the channel axis, [B, 2C, D, H, W].

Each is zero where w < d (both channel halves of the concat volume) and is
a ``torch.autograd.Function`` with gradients for both feature maps. The 4-D
volumes feed the 3-D convs of the PSMNet, StereoNet and GC-Net
aggregations; their CUDA kernels, forward and backward, are
``csrc/volume4d.cu``, with tilings chosen here per shape and SM count
(``volume_forward_plan``, ``volume_backward_plan``).

The correlation's kernels also have a bfloat16 form (the JAX op under a
bf16 compute dtype, ``cost_volume.py:108,113``, and its transpose): bf16
features and volume (and volume gradient), float32 products, sums and
the division by C, each output rounded to bf16 once
(``aanet_correlation_bf16`` and ``aanet_correlation_backward_bf16``,
kernels of their own on the tensor cores with plans of their own,
``forward_plan_bf16`` and ``backward_plan_bf16``).
So do the 4-D volumes' (the JAX ops in the features'
dtype, ``cost_volume.py:127,144``): bf16 features and volume, the
difference L - R(w - d) in float32 rounded once (concat copies), and in
the backward a bf16 volume gradient whose sums over d run in float32, in
ascending d, each gradient rounded to bf16 once
(``aanet_{difference,concat}_volume_bf16`` and their ``_backward_bf16``,
the float32 forms' plans). XLA's transpose on the CPU instead adds the D
slices in descending d and rounds each partial sum to bf16; the two agree
to within that rounding (``tests/test_torch_bf16_volumes.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from aanet_torch import _build
from aanet_torch._build import SM_SMEM_BYTES, SMEM_BYTES

# the 4-D volumes: three tensors, batch .. max_disp, the plan's one
# (forward) or three (backward), device, stream
_VOL_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_VOL_BWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# left, right, out, batch .. max_disp, the plan's five (the bf16 forward's
# four), device, stream
_CORR_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_CORR_MMA_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
# grad, left, right, grad_left, grad_right, batch .. max_disp, the plan's three, device, stream
_CORR_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

# The correlation kernels' constants (csrc/correlation.cu): a forward
# thread's tile of FWD_CW columns by one of FWD_DD disparities (the builds),
# a backward thread's of BWD_CW columns by BWD_CC channels of one gradient
# (its window slides BWD_DSTEP disparities a trip), the neighbouring column
# groups of a warp (FWD_LX, BWD_LX), and each kernel's
# __launch_bounds__(MAX_THREADS, MIN_BLOCKS), which cap a thread's registers
FWD_CW = 4
FWD_LX = 8
FWD_DD = (8, 16)
FWD_MAX_THREADS = 256
FWD_MIN_BLOCKS = 1
BWD_CW = 4
BWD_CC = 8
BWD_LX = 8
BWD_DSTEP = 8
BWD_MAX_THREADS = 256
BWD_MIN_BLOCKS = 2
TILE_WS = (32, 64, 128, 256)  # columns of a block the plans consider
CHUNKS = (8, 16, 32, 64)  # channels staged at a time the plans consider
# The forward's plan: blocks of at least FWD_MIN_THREADS threads, and the
# least ksplit that gives the grid FWD_SM_THREADS threads an SM
FWD_MIN_THREADS = 64
FWD_SM_THREADS = 256
# The bf16 forward on the tensor cores (corr_fwd_mma_kernel): a warp's 16
# output columns (MMA_CW, mma.sync's m16), k-steps of MMA_K channels, its
# launch bounds, its builds (MMA_NTGS: the n-tiles of 8 window columns a
# warp takes at most), and the tile widths and chunks its plans consider;
# the plan's picks (tools/torch_correlation_sweep.py on an H100): a row of
# up to MMA_WHOLE_W columns in one tile, a wider one in tiles of at most
# MMA_TILE_W, chunks of 64 channels where the grid holds fewer than
# MMA_SM_BLOCKS blocks an SM
MMA_CW = 16
MMA_K = 16
MMA_MAX_THREADS = 256
MMA_MIN_BLOCKS = 2
MMA_NTGS = (2, 4, 6, 8, 10, 12, 14, 16)
MMA_TILE_WS = tuple(range(MMA_CW, 8 * MMA_CW + 1, MMA_CW))
MMA_CHUNKS = (16, 32, 64)
MMA_WHOLE_W = 96
MMA_TILE_W = 64
MMA_SM_BLOCKS = 4
# The bf16 backward on the tensor cores (corr_bwd_mma_kernel): a warp's 16
# output columns of one gradient (BMMA_CW), k-steps of BMMA_K window
# columns, its launch bounds, and the tile widths and chunks (its builds)
# its plans consider; the plan's picks (tools/torch_correlation_sweep.py on
# an H100): tiles of BMMA_PICK_WS columns, chunks of 64 channels where the
# grid holds fewer than BMMA_SM_BLOCKS blocks an SM
BMMA_CW = 16
BMMA_K = 16
BMMA_MAX_THREADS = 512
BMMA_MIN_BLOCKS = 1
BMMA_TILE_WS = tuple(range(BMMA_CW, 8 * BMMA_CW + 1, BMMA_CW))
BMMA_CHUNKS = (16, 32, 64)
BMMA_PICK_WS = (32, 48, 64)
BMMA_SM_BLOCKS = 2


def correlation_cost_volume_plain(
    left: torch.Tensor, right: torch.Tensor, max_disp: int, exact: bool = False
) -> torch.Tensor:
    """Plain PyTorch correlation volume: the reference's shift-multiply
    loop over d (nets/cost.py:40-48), summed in the features' dtype as the
    JAX op sums. With ``exact``, float32 features are summed in float64
    and the volume rounded to float32 once: what the kernel's float32 form
    computes (the correctly rounded mean but at the rarest ties), and what
    chip_smoke.py holds it against. For bf16 features, the bf16 form:
    computed in float32, the volume rounded to bf16 once."""
    if left.dtype == torch.bfloat16:
        return correlation_cost_volume_plain(left.float(), right.float(), max_disp).to(left.dtype)
    if exact and left.dtype == torch.float32:
        return correlation_cost_volume_plain(left.double(), right.double(), max_disp).float()
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
    g[d, w'+d] L[c, w'+d] / C, over the pairs with w >= d. For bf16
    features, the bf16 form: computed in float32, each gradient rounded to
    bf16 once."""
    if left.dtype == torch.bfloat16:
        grads = correlation_cost_volume_backward_plain(grad.float(), left.float(), right.float())
        return tuple(g.to(left.dtype) for g in grads)
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


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class ForwardPlan(NamedTuple):
    """How ``aanet_correlation_f32`` cuts one volume: a block takes
    ``tile_w`` columns of one (b, h) row and all disparities; a thread a
    tile of ``FWD_CW`` columns by ``dd`` disparities (``ny`` disparity
    groups cover D); ``ksplit`` thread groups split each chunk of ``chunk``
    channels. ``threads`` a block, ``smem_bytes`` of shared memory,
    ``blocks`` in the grid."""

    tile_w: int
    dd: int
    ny: int
    ksplit: int
    chunk: int
    threads: int
    smem_bytes: int
    blocks: int


class BackwardPlan(NamedTuple):
    """How ``aanet_correlation_backward_f32`` cuts one gradient: a block
    takes ``tile_w`` columns of one (b, h) row, all channels and ``dtot``
    disparities (D rounded up to ``BWD_DSTEP``); half its threads sum dL,
    half dR, each a tile of ``BWD_CC`` channels by ``BWD_CW`` columns;
    channels are staged ``chunk`` at a time. ``threads`` a block,
    ``smem_bytes`` of shared memory, ``blocks`` in the grid."""

    tile_w: int
    chunk: int
    dtot: int
    threads: int
    smem_bytes: int
    blocks: int


class BackwardPlanBf16(NamedTuple):
    """How ``aanet_correlation_backward_bf16`` cuts one gradient on the
    tensor cores: a block takes ``tile_w`` columns of one (b, h) row, all
    channels and all disparities, for both gradients; a warp 16 of those
    columns of one gradient by ``chunk`` channels, contracted in ``nk``
    k-steps of 16 window columns (the windows reach ``dtot`` columns past
    the tile); channels are staged ``chunk`` at a time. ``threads`` a
    block, ``smem_bytes`` of shared memory, ``blocks`` in the grid."""

    tile_w: int
    chunk: int
    nk: int
    dtot: int
    threads: int
    smem_bytes: int
    blocks: int


class ForwardPlanBf16(NamedTuple):
    """How ``aanet_correlation_bf16`` cuts one volume on the tensor cores: a
    block takes ``tile_w`` columns of one (b, h) row and all disparities; a
    warp 16 of those columns by at most ``ntg`` n-tiles of 8 window columns
    (``ny`` warps split a 16-column group's ceil((D + 15) / 8) n-tiles);
    channels are staged ``chunk`` at a time. ``threads`` a block,
    ``smem_bytes`` of shared memory, ``blocks`` in the grid."""

    tile_w: int
    chunk: int
    ntg: int
    ny: int
    threads: int
    smem_bytes: int
    blocks: int


def _mma_row(n: int) -> int:
    """bf16 values of a row of n staged by the bf16 forward (``mma_row``):
    an odd number of 16-byte pieces, so the 8 channels an ldmatrix reads
    fall in different banks."""
    pieces = _ceil_div(n, 8)
    return 8 * (pieces + 1 - pieces % 2)


def _fwd_mma_smem(tile_w: int, max_disp: int, chunk: int) -> int:
    """Bytes of the bf16 forward's shared memory (``fwd_mma_smem_bytes``):
    two buffers of a chunk's left tile [chunk][_mma_row(tile_w)] and right
    window [chunk][_mma_row(tile_w + dtot)], raw bf16 (dtot: D rounded up to
    8); the epilogue's band [D][_mma_row(tile_w)] reuses them. The kernel
    refuses a plan whose ``smem_bytes`` differ."""
    dtot = 8 * _ceil_div(max_disp, 8)
    stage = 2 * chunk * (_mma_row(tile_w) + _mma_row(tile_w + dtot))
    return 2 * max(stage, max_disp * _mma_row(tile_w))


def mma_tiles(max_disp: int) -> tuple[int, int, int]:
    """(nt, ny, ntg): the n-tiles of a 16-column group's band, ceil((D +
    15) / 8); the warps that split them, as few as the largest build
    allows; and the build, the least even count that holds a warp's
    share."""
    nt = _ceil_div(max_disp + 15, 8)
    ny = _ceil_div(nt, MMA_NTGS[-1])
    return nt, ny, 2 * _ceil_div(_ceil_div(nt, ny), 2)


def _fwd_smem(tile_w: int, dtot: int, chunk: int, ksplit: int) -> int:
    """Bytes of the forward's shared memory (``fwd_smem_words`` in the
    kernel): two buffers of a chunk's left tile [chunk][tile_w] and right
    window [chunk][tile_w + dtot]; the ksplit - 1 partial tiles of the final
    sum reuse them. The kernel refuses a plan whose ``smem_bytes`` differ."""
    return 4 * max(2 * chunk * (2 * tile_w + dtot), (ksplit - 1) * tile_w * dtot)


def _bwd_smem(tile_w: int, dtot: int, chunk: int) -> int:
    """Bytes of the backward's shared memory (``bwd_smem_words`` in the
    kernel): the two gradient tiles [dtot][tile_w] and two buffers of a
    chunk's right and left windows [chunk][tile_w + dtot]. The kernel
    refuses a plan whose ``smem_bytes`` differ."""
    return 4 * (2 * dtot * tile_w + 4 * chunk * (tile_w + dtot))


def bwd_mma_steps(max_disp: int) -> tuple[int, int]:
    """(nk, dtot) of the bf16 backward (``bwd_mma_steps``): the k-steps of
    16 window columns that cover a warp's band, ceil((D + 15) / 16), and
    the columns its windows reach past the tile, 16 (nk - 1) >= D - 1."""
    nk = _ceil_div(max_disp + 15, BMMA_K)
    return nk, BMMA_K * (nk - 1)


def _bwd_mma_smem(tile_w: int, max_disp: int, chunk: int) -> int:
    """Bytes of the bf16 backward's shared memory (``bwd_mma_smem_bytes``):
    two buffers of a chunk's right and left windows
    [chunk][_mma_row(tile_w + dtot)], the two band matrices
    [tile_w][_mma_row(16 nk)] and the chunk's dL and dR tiles
    [chunk][_mma_row(tile_w)], raw bf16. The kernel refuses a plan whose
    ``smem_bytes`` differ."""
    nk, dtot = bwd_mma_steps(max_disp)
    return 2 * (4 * chunk * _mma_row(tile_w + dtot) + 2 * tile_w * _mma_row(BMMA_K * nk)
                + 2 * chunk * _mma_row(tile_w))


def forward_plans(batch: int, channels: int, height: int, width: int,
                  max_disp: int) -> list[ForwardPlan]:
    """Every tiling the forward kernel takes at this shape: whole warps
    within its launch bounds and a block's shared memory, a chunk of at
    least one channel per thread group."""
    plans = []
    for dd in FWD_DD:
        ny = _ceil_div(max_disp, dd)
        for tile_w in TILE_WS:
            for ksplit in (1, 2, 4, 8):
                threads = tile_w // FWD_CW * ny * ksplit
                if threads % 32 or threads > FWD_MAX_THREADS:
                    continue
                for chunk in CHUNKS:
                    smem = _fwd_smem(tile_w, ny * dd, chunk, ksplit)
                    if ksplit <= chunk and smem <= SMEM_BYTES:
                        plans.append(ForwardPlan(tile_w, dd, ny, ksplit, chunk, threads, smem,
                                                 batch * height * _ceil_div(width, tile_w)))
    return plans


def backward_plans(batch: int, channels: int, height: int, width: int,
                   max_disp: int) -> list[BackwardPlan]:
    """Every tiling the backward kernel takes at this shape (``max_disp``
    > 0): whole warps for each gradient within its launch bounds and a
    block's shared memory."""
    dtot = _ceil_div(max_disp, BWD_DSTEP) * BWD_DSTEP
    plans = []
    for tile_w in TILE_WS:
        for chunk in CHUNKS:
            per_side = tile_w // BWD_CW * (chunk // BWD_CC)
            smem = _bwd_smem(tile_w, dtot, chunk)
            if chunk % BWD_CC or per_side % 32 or 2 * per_side > BWD_MAX_THREADS or smem > SMEM_BYTES:
                continue
            plans.append(BackwardPlan(tile_w, chunk, dtot, 2 * per_side, smem,
                                      batch * height * _ceil_div(width, tile_w)))
    return plans


def backward_plans_bf16(batch: int, channels: int, height: int, width: int,
                        max_disp: int) -> list[BackwardPlanBf16]:
    """Every tiling the bf16 backward takes at this shape (``max_disp`` >
    0): tiles of whole 16-column groups and the built chunks within its
    launch bounds and a block's shared memory."""
    nk, dtot = bwd_mma_steps(max_disp)
    plans = []
    for tile_w in BMMA_TILE_WS:
        threads = 2 * 32 * tile_w // BMMA_CW
        for chunk in BMMA_CHUNKS:
            smem = _bwd_mma_smem(tile_w, max_disp, chunk)
            if threads <= BMMA_MAX_THREADS and smem <= SMEM_BYTES:
                plans.append(BackwardPlanBf16(tile_w, chunk, nk, dtot, threads, smem,
                                              batch * height * _ceil_div(width, tile_w)))
    return plans


def forward_plans_bf16(batch: int, channels: int, height: int, width: int,
                       max_disp: int) -> list[ForwardPlanBf16]:
    """Every tiling the bf16 forward takes at this shape (``max_disp`` >
    0): tiles of whole 16-column groups and chunks of whole k-steps within
    its launch bounds and a block's shared memory."""
    _, ny, ntg = mma_tiles(max_disp)
    plans = []
    for tile_w in MMA_TILE_WS:
        threads = 32 * tile_w // MMA_CW * ny
        for chunk in MMA_CHUNKS:
            smem = _fwd_mma_smem(tile_w, max_disp, chunk)
            if threads <= MMA_MAX_THREADS and smem <= SMEM_BYTES:
                plans.append(ForwardPlanBf16(tile_w, chunk, ntg, ny, threads, smem,
                                             batch * height * _ceil_div(width, tile_w)))
    return plans


@functools.lru_cache(maxsize=None)
def forward_plan(batch: int, channels: int, height: int, width: int, max_disp: int,
                 sms: int) -> ForwardPlan:
    """The forward kernel's tiling for L and R [batch, channels, height,
    width] and ``max_disp`` disparities on a card of ``sms`` SMs, of
    ``forward_plans``, by these preferences in turn:

    - a thread's tile of 16 disparities where D is a multiple of 32, else 8
      (whole warps of a block at ksplit 1 in both cases);
    - blocks of 64 columns, or 32 where the grid of 64-column blocks is
      short of one block an SM;
    - channel chunks of 16, or 32 at ksplit 4 and more (each thread group
      keeps 8 channels a chunk);
    - blocks of FWD_MIN_THREADS threads or more;
    - a grid of FWD_SM_THREADS threads an SM or more, else the most;
    - the least ksplit.

    ``tools/torch_correlation_sweep.py`` times it against every other plan
    (PERF.md §6 has its distance from the fastest on an H100). Raises if
    nothing fits."""
    plans = forward_plans(batch, channels, height, width, max_disp)
    if not plans:
        raise ValueError(
            f"correlation: no forward tiling of {max_disp} disparities fits a block of "
            f"{FWD_MAX_THREADS} threads and {SMEM_BYTES} bytes of shared memory")
    dd = 16 if max_disp % 32 == 0 else 8
    tile_w = 64 if batch * height * _ceil_div(width, 64) >= sms else 32

    def key(p):
        supply = min(p.blocks * p.threads, FWD_SM_THREADS * sms)
        return (p.dd != dd, p.tile_w != tile_w, p.chunk != (32 if p.ksplit >= 4 else 16),
                p.threads < FWD_MIN_THREADS, -supply, p.ksplit, p.tile_w, p.chunk)
    return min(plans, key=key)


@functools.lru_cache(maxsize=None)
def forward_plan_bf16(batch: int, channels: int, height: int, width: int, max_disp: int,
                      sms: int) -> ForwardPlanBf16:
    """The bf16 forward's tiling for ``max_disp`` > 0 on a card of ``sms``
    SMs, of ``forward_plans_bf16``: a row of up to MMA_WHOLE_W columns in
    one tile, a wider row in the fewest tiles of at most MMA_TILE_W
    columns, each ``16 * ceil(W / 16 / tiles)`` wide; chunks of 16
    channels where C <= 32, of 32 where C <= 64, else of 64 where the grid
    holds fewer than MMA_SM_BLOCKS blocks an SM and 32 where it holds more;
    then the nearest tile that fits. On an H100 this was within 7.3 % of
    the fastest plan at every path shape and 2.9 % over all of them
    (``tools/torch_correlation_sweep.py --dtype bfloat16``). Raises if
    nothing fits."""
    plans = forward_plans_bf16(batch, channels, height, width, max_disp)
    if not plans:
        raise ValueError(
            f"correlation: no bf16 forward tiling of {max_disp} disparities fits a block of "
            f"{MMA_MAX_THREADS} threads and {SMEM_BYTES} bytes of shared memory")
    tiles = 1 if width <= MMA_WHOLE_W else _ceil_div(width, MMA_TILE_W)
    tile_w = MMA_CW * _ceil_div(_ceil_div(width, MMA_CW), tiles)
    short = batch * height * _ceil_div(width, tile_w) < MMA_SM_BLOCKS * sms
    chunk = 16 if channels <= 32 else 32 if channels <= 64 or not short else 64
    return min(plans, key=lambda p: (abs(p.tile_w - tile_w), p.chunk != chunk, p.tile_w, p.chunk))


@functools.lru_cache(maxsize=None)
def backward_plan(batch: int, channels: int, height: int, width: int, max_disp: int,
                  sms: int) -> BackwardPlan:
    """The backward kernel's tiling for ``max_disp`` > 0 on a card of
    ``sms`` SMs, of ``backward_plans``: blocks of 64 columns where they pad
    the row no more than blocks of 32 and the grid holds a block an SM,
    else 32; chunks of 32 channels where there are 64 or more, else 16.
    Raises if nothing fits."""
    plans = backward_plans(batch, channels, height, width, max_disp)
    if not plans:
        raise ValueError(
            f"correlation backward: no tiling of {max_disp} disparities fits a block of "
            f"{BWD_MAX_THREADS} threads and {SMEM_BYTES} bytes of shared memory")
    pad = lambda tw: _ceil_div(width, tw) * tw - width  # noqa: E731
    tile_w = 64 if pad(64) <= pad(32) and batch * height * _ceil_div(width, 64) >= sms else 32
    chunk = 32 if channels >= 64 else 16
    return min(plans, key=lambda p: (p.tile_w != tile_w, p.chunk != chunk, p.tile_w, p.chunk))


@functools.lru_cache(maxsize=None)
def backward_plan_bf16(batch: int, channels: int, height: int, width: int, max_disp: int,
                       sms: int) -> BackwardPlanBf16:
    """The bf16 backward's tiling (``aanet_correlation_backward_bf16``, on
    the tensor cores) for ``max_disp`` > 0 on a card of ``sms`` SMs, of
    ``backward_plans_bf16``: tiles of 32, 48 or 64 columns, the one that
    pads the row least, the narrowest on a tie; chunks of 64 channels where
    the grid holds fewer than BMMA_SM_BLOCKS blocks an SM, else of 32 where
    C > 64 and of 16 where C <= 64, and never more than the least build
    that holds C; then the nearest tile and chunk that fit. On an H100 this
    was the fastest plan or within 3.8 % of it at every train step's shape
    (at the inference shapes, where no backward runs, within 22.3 %;
    ``tools/torch_correlation_sweep.py --dtype bfloat16``). Raises if
    nothing fits."""
    plans = backward_plans_bf16(batch, channels, height, width, max_disp)
    if not plans:
        raise ValueError(
            f"correlation backward: no bf16 tiling of {max_disp} disparities fits a block of "
            f"{BMMA_MAX_THREADS} threads and {SMEM_BYTES} bytes of shared memory")
    pad = lambda tw: _ceil_div(width, tw) * tw - width  # noqa: E731
    tile_w = min(BMMA_PICK_WS, key=lambda tw: (pad(tw), tw))
    short = batch * height * _ceil_div(width, tile_w) < BMMA_SM_BLOCKS * sms
    chunk = min(64 if short else 32 if channels > 64 else 16,
                next((n for n in BMMA_CHUNKS if n >= channels), BMMA_CHUNKS[-1]))
    return min(plans, key=lambda p: (abs(p.tile_w - tile_w), abs(p.chunk - chunk), p.tile_w,
                                     p.chunk))


def _sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _forward(left, right, max_disp):
    if left.device.type == "cpu":
        return correlation_cost_volume_plain(left, right, max_disp)
    form = _build.form("correlation", left.dtype)
    _build.check_cuda("correlation", left=(left, left.dtype), right=(right, left.dtype))
    b, c, h, w = left.shape
    cost = torch.empty((b, max_disp, h, w), dtype=left.dtype, device=left.device)
    bf16 = form == "bf16"
    plan = (0,) * (4 if bf16 else 5)  # an empty volume: nothing to write
    if cost.numel() and bf16:
        p = forward_plan_bf16(b, c, h, w, max_disp, _sms(left))
        plan = (p.tile_w, p.chunk, p.ntg, p.smem_bytes)
    elif cost.numel():
        p = forward_plan(b, c, h, w, max_disp, _sms(left))
        plan = (p.tile_w, p.dd, p.ksplit, p.chunk, p.smem_bytes)
    _build.launch(
        "correlation", f"aanet_correlation_{form}", _CORR_MMA_ARGTYPES if bf16 else _CORR_ARGTYPES,
        _build.ptr(left), _build.ptr(right), _build.ptr(cost),
        b, c, h, w, max_disp, *plan, left.device.index, _build.stream(left),
    )
    _build.count_launch(correlation_cost_volume, form)
    return cost


def correlation_cost_volume_backward(grad, left, right):
    """Gradients (d left, d right) given the volume's gradient ``grad``
    [B, D, H, W], all of the features' dtype. A CPU tensor takes the plain
    version; a CUDA tensor launches ``aanet_correlation_backward_f32`` with
    ``backward_plan``'s tiling or, for bf16 features,
    ``aanet_correlation_backward_bf16`` with ``backward_plan_bf16``'s."""
    _check(left, right)
    if left.device.type == "cpu":
        return correlation_cost_volume_backward_plain(grad, left, right)
    form = _build.form("correlation backward", left.dtype)
    dt = left.dtype
    _build.check_cuda("correlation backward", grad=(grad, dt), left=(left, dt), right=(right, dt))
    b, c, h, w = left.shape
    if grad.shape[0] != b or grad.shape[2:] != (h, w):
        raise ValueError(f"correlation backward: grad {tuple(grad.shape)} does not fit {tuple(left.shape)}")
    grad_left = torch.empty_like(left)
    grad_right = torch.empty_like(right)
    plan = (0,) * 3  # no disparities: the kernel zeroes the gradients
    if grad.shape[1] and left.numel():
        planner = backward_plan_bf16 if form == "bf16" else backward_plan
        p = planner(b, c, h, w, grad.shape[1], _sms(left))
        plan = (p.tile_w, p.chunk, p.smem_bytes)
    _build.launch(
        "correlation", f"aanet_correlation_backward_{form}", _CORR_BWD_ARGTYPES,
        _build.ptr(grad), _build.ptr(left), _build.ptr(right),
        _build.ptr(grad_left), _build.ptr(grad_right),
        b, c, h, w, grad.shape[1], *plan, left.device.index, _build.stream(left),
    )
    _build.count_launch(correlation_cost_volume_backward, form)
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
    """Correlation volume of left/right features [B, C, H, W] -> [B, D, H, W]
    in their dtype (float32 or bfloat16), differentiable in both.

    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels.
    """
    _check(left, right)
    return _Correlation.apply(left, right, max_disp)


correlation_cost_volume.launches = 0
correlation_cost_volume.launches_bf16 = 0
correlation_cost_volume_backward.launches = 0
correlation_cost_volume_backward.launches_bf16 = 0


# ---------------------------------------------------------------------------
# The 4-D volumes: difference and concat
# ---------------------------------------------------------------------------

# The 4-D volume kernels' constants (csrc/volume4d.cu): the forward's block,
# the backward's __launch_bounds__ (MIN_BLOCKS caps a thread's registers)
# and the planes of a stage of its ring
VOL_FWD_THREADS = 256
VOL_BWD_MAX_THREADS = 512
VOL_BWD_MIN_BLOCKS = 2
VOL_BWD_CHUNK = 4
VOL_FWD_SPLITS = (1, 2, 4, 8)  # runs of D the forward's plans consider
VOL_BWD_TILE = 1024  # columns of a backward block where a row is wider than a block's quads
VOL_BWD_WARPS = 16  # resident warps an SM the backward's plan looks for first
SM_THREADS = 2048  # resident threads of one SM


class VolumeForwardPlan(NamedTuple):
    """How ``aanet_{difference,concat}_volume_f32`` cut one volume: a thread
    takes a quad of 4 columns of one (b, c, h) row and a run of ``dchunk``
    planes of D (``ceil(D / dchunk)`` runs), ``VOL_FWD_THREADS`` a block;
    ``blocks`` in the grid."""

    dchunk: int
    blocks: int


class VolumeBackwardPlan(NamedTuple):
    """How ``aanet_{difference,concat}_volume_backward_f32`` cut one
    gradient: a block takes ``rows`` (b, c, h) rows of ``tile`` columns
    (the whole row where ``tile`` >= W; else ``rows`` is 1 and a row has
    ``ceil(W / tile)`` tiles), a thread a quad of 4 columns; the planes of
    grad stream through a ring of two stages of ``VOL_BWD_CHUNK`` planes.
    ``threads`` a block, ``smem_bytes`` of shared memory, ``blocks`` in the
    grid."""

    rows: int
    tile: int
    threads: int
    smem_bytes: int
    blocks: int


def _round4(n: int) -> int:
    return 4 * _ceil_div(n, 4)


def volume_forward_plans(batch: int, channels: int, height: int, width: int,
                         max_disp: int) -> list[VolumeForwardPlan]:
    """Every cut the forward kernel takes at this shape (``max_disp`` > 0)
    that the plan considers: D in 1, 2, 4 or 8 runs of whole quads of
    planes."""
    blocks = _ceil_div(batch * channels * height * _ceil_div(width, 4), VOL_FWD_THREADS)
    dchunks = sorted({_round4(_ceil_div(max_disp, n)) for n in VOL_FWD_SPLITS}, reverse=True)
    return [VolumeForwardPlan(d, blocks * _ceil_div(max_disp, d)) for d in dchunks]


@functools.lru_cache(maxsize=None)
def volume_forward_plan(batch: int, channels: int, height: int, width: int, max_disp: int,
                        sms: int) -> VolumeForwardPlan:
    """The forward kernel's cut for L and R [batch, channels, height,
    width] and ``max_disp`` > 0 planes on a card of ``sms`` SMs: all of D a
    thread, unless the quads are fewer than two waves of the threads the SMs
    hold, then the fewest runs of D that reach it (the inference volumes'
    4: 7 % faster than all of D for the difference volume on an H100).
    ``tools/torch_volume_sweep.py`` times it against the others."""
    quads = batch * channels * height * _ceil_div(width, 4)
    splits = next((n for n in VOL_FWD_SPLITS if quads * n >= 2 * sms * SM_THREADS),
                  VOL_FWD_SPLITS[-1])
    dchunk = _round4(_ceil_div(max_disp, splits))
    return next(p for p in volume_forward_plans(batch, channels, height, width, max_disp)
                if p.dchunk == dchunk)


def _vol_bwd_smem(rows: int, tile: int, whole: bool, concat: bool) -> int:
    """Bytes of the backward's shared memory (``bwd_smem_words`` in the
    kernel): two stages of ``VOL_BWD_CHUNK`` planes of the rows' dL pieces (``tile``
    columns) and their dR pieces: none for the difference volume's whole
    rows (its dR reads the dL pieces), the second channel half's row for
    concat's, ``tile + 4`` columns for a tile of a wider row. The kernel
    refuses a plan whose ``smem_bytes`` differ."""
    piece = (tile if concat else 0) if whole else tile + 4
    return 4 * 2 * VOL_BWD_CHUNK * rows * (tile + piece)


def _vol_bwd_resident(threads: int, smem: int) -> int:
    """Blocks one SM holds by shared memory, threads and the launch bounds'
    registers."""
    registers = 65536 // (VOL_BWD_MAX_THREADS * VOL_BWD_MIN_BLOCKS)
    return min(SM_SMEM_BYTES // (smem + 1024), SM_THREADS // threads,
               65536 // (registers * threads))


def volume_backward_plans(batch: int, channels: int, height: int, width: int,
                          concat: bool) -> list[VolumeBackwardPlan]:
    """Every cut the backward kernel takes at this shape (whatever D): whole rows (as
    many as ``VOL_BWD_MAX_THREADS`` threads hold) where a row's quads fit a
    block, else one row's tiles of ``VOL_BWD_TILE`` columns; within a
    block's shared memory."""
    nrows = batch * channels * height
    whole = _ceil_div(width, 4) <= VOL_BWD_MAX_THREADS
    tile = _round4(width) if whole else VOL_BWD_TILE
    quads = tile // 4
    plans = []
    for rows in range(1, (VOL_BWD_MAX_THREADS // quads if whole else 1) + 1):
        smem = _vol_bwd_smem(rows, tile, whole, concat)
        if smem <= SMEM_BYTES:
            plans.append(VolumeBackwardPlan(rows, tile, 32 * _ceil_div(rows * quads, 32), smem,
                                            _ceil_div(nrows, rows) * _ceil_div(width, tile)))
    return plans


@functools.lru_cache(maxsize=None)
def volume_backward_plan(batch: int, channels: int, height: int, width: int, concat: bool,
                         sms: int) -> VolumeBackwardPlan:
    """The backward kernel's cut for a gradient of L and R [batch,
    channels, height, width] on a card of ``sms`` SMs, of
    ``volume_backward_plans``, by these preferences in turn: at least
    ``VOL_BWD_WARPS`` resident warps an SM (the most, short of that); the
    fewest idle threads (a block's quads in whole warps); the more rows.
    ``tools/torch_volume_sweep.py`` times it against the others."""
    plans = volume_backward_plans(batch, channels, height, width, concat)

    def key(p):
        warps = _vol_bwd_resident(p.threads, p.smem_bytes) * p.threads // 32
        idle = p.threads - p.rows * (p.tile // 4)
        return (-min(warps, VOL_BWD_WARPS), idle / p.threads, -p.rows)
    return min(plans, key=key)


def difference_cost_volume_plain(
    left: torch.Tensor, right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Plain PyTorch difference volume [B, C, D, H, W]: the reference's
    loop over d (nets/cost.py:22-29). For bf16 features, the bf16 form:
    the differences in float32, rounded to bf16 once."""
    if left.dtype == torch.bfloat16:
        return difference_cost_volume_plain(left.float(), right.float(), max_disp).to(left.dtype)
    b, c, h, w = left.shape
    cost = left.new_zeros((b, c, max_disp, h, w))
    for d in range(min(max_disp, w)):
        cost[:, :, d, :, d:] = left[..., d:] - right[..., : w - d]
    return cost


def concat_cost_volume_plain(
    left: torch.Tensor, right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Plain PyTorch concat volume [B, 2C, D, H, W] (nets/cost.py:31-38),
    both halves zero where w < d as in the JAX package; in the features'
    dtype (a copy)."""
    b, c, h, w = left.shape
    cost = left.new_zeros((b, 2 * c, max_disp, h, w))
    for d in range(min(max_disp, w)):
        cost[:, :c, d, :, d:] = left[..., d:]
        cost[:, c:, d, :, d:] = right[..., : w - d]
    return cost


def difference_cost_volume_backward_plain(grad, left, right):
    """dL[w] = sum_d g[d, w] and dR[w'] = -sum_d g[d, w' + d], over the
    pairs with w >= d, added in ascending d. For bf16 features, the bf16
    form: summed in float32, each gradient rounded to bf16 once."""
    if left.dtype == torch.bfloat16:
        return _bf16_backward(difference_cost_volume_backward_plain, grad, left, right)
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
    halves of ``grad`` and with a plus for R (the bf16 form likewise)."""
    if left.dtype == torch.bfloat16:
        return _bf16_backward(concat_cost_volume_backward_plain, grad, left, right)
    c, w = left.shape[1], left.shape[3]
    grad_left = torch.zeros_like(left)
    grad_right = torch.zeros_like(right)
    for d in range(min(grad.shape[2], w)):
        grad_left[..., d:] += grad[:, :c, d, :, d:]
        grad_right[..., : w - d] += grad[:, c:, d, :, d:]
    return grad_left, grad_right


def _bf16_backward(plain, grad, left, right):
    """A volume backward's bf16 form: ``plain`` on float32 copies, each
    gradient rounded to bf16 once."""
    return tuple(g.to(left.dtype) for g in plain(grad.float(), left.float(), right.float()))


def difference_cost_volume_backward(grad, left, right):
    """Gradients (d left, d right) given the volume's gradient ``grad``
    [B, C, D, H, W], in the features' dtype. A CPU tensor takes the plain
    version; a CUDA tensor launches ``aanet_difference_volume_backward_f32``
    or, for bf16 features, ``aanet_difference_volume_backward_bf16``."""
    return _volume_backward("difference", difference_cost_volume_backward_plain, grad, left, right)


def concat_cost_volume_backward(grad, left, right):
    """As ``difference_cost_volume_backward``, for the concat volume's
    ``grad`` [B, 2C, D, H, W] and ``aanet_concat_volume_backward_{f32,bf16}``."""
    return _volume_backward("concat", concat_cost_volume_backward_plain, grad, left, right)


def _volume_backward(kind, plain, grad, left, right):
    _check(left, right, f"{kind} volume backward")
    if left.device.type == "cpu":
        return plain(grad, left, right)
    form = _build.form(f"{kind} volume backward", left.dtype)
    dt = left.dtype
    _build.check_cuda(f"{kind} volume backward", grad=(grad, dt), left=(left, dt), right=(right, dt))
    b, c, h, w = left.shape
    channels = 2 * c if kind == "concat" else c
    if grad.ndim != 5 or grad.shape[:2] != (b, channels) or grad.shape[3:] != (h, w):
        raise ValueError(
            f"{kind} volume backward: grad {tuple(grad.shape)} does not fit {tuple(left.shape)}"
        )
    grad_left = torch.empty_like(left)
    grad_right = torch.empty_like(right)
    plan = (1, 4, 0)  # nothing to sum or write
    if left.numel():
        p = volume_backward_plan(b, c, h, w, kind == "concat", _sms(left))
        plan = (p.rows, p.tile, p.smem_bytes)
    _build.launch(
        "volume4d", f"aanet_{kind}_volume_backward_{form}", _VOL_BWD_ARGTYPES,
        _build.ptr(grad), _build.ptr(grad_left), _build.ptr(grad_right),
        b, c, h, w, grad.shape[2], *plan, left.device.index, _build.stream(left),
    )
    wrapper = {"difference": difference_cost_volume_backward,
               "concat": concat_cost_volume_backward}[kind]
    _build.count_launch(wrapper, form)
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
        form = _build.form(f"{kind} volume", left.dtype)
        _build.check_cuda(f"{kind} volume", left=(left, left.dtype), right=(right, left.dtype))
        b, c, h, w = left.shape
        cost = torch.empty((b, channels * c, max_disp, h, w), dtype=left.dtype, device=left.device)
        dchunk = 4  # an empty volume: nothing to write
        if cost.numel():
            dchunk = volume_forward_plan(b, c, h, w, max_disp, _sms(left)).dchunk
        _build.launch(
            "volume4d", f"aanet_{kind}_volume_{form}", _VOL_ARGTYPES,
            _build.ptr(left), _build.ptr(right), _build.ptr(cost),
            b, c, h, w, max_disp, dchunk, left.device.index, _build.stream(left),
        )
        _build.count_launch(op, form)
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
    [B, C, D, H, W] in their dtype (float32 or bfloat16). A CPU tensor
    takes the plain version; a CUDA tensor launches
    ``aanet_difference_volume_f32`` or ``aanet_difference_volume_bf16``."""
    _check(left, right, "difference volume")
    return _Volume.apply(left, right, max_disp, "difference")


def concat_cost_volume(
    left: torch.Tensor, right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Concat volume of left/right features [B, C, H, W] ->
    [B, 2C, D, H, W] in their dtype (float32 or bfloat16). A CPU tensor
    takes the plain version; a CUDA tensor launches
    ``aanet_concat_volume_f32`` or ``aanet_concat_volume_bf16``."""
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
difference_cost_volume.launches_bf16 = 0
concat_cost_volume.launches = 0
concat_cost_volume.launches_bf16 = 0
difference_cost_volume_backward.launches = 0
difference_cost_volume_backward.launches_bf16 = 0
concat_cost_volume_backward.launches = 0
concat_cost_volume_backward.launches_bf16 = 0
