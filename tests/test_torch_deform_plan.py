"""The tilings and weight layouts of the deformable conv's forward and
input/offset/mask gradient kernels (``aanet_torch/csrc/deform_conv.cu``),
on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain twins there). What surrounds them is Python: the
wrappers pick the tile, the channel tile or chunk, the splits and the input
window per shape (``ops.deform.forward_plan``, ``backward_data_plan``) and
lay the weight out ([tap, cin, cout]: ``weight_taps_cin_major``; [tap,
cout, cin]: ``weight_taps_major``). Here the plans are checked for every
deformable conv that ``chip_smoke.py``'s paths run: they fit a block's
shared memory, leave no channel idle, fill the card, and their windows
cover the tile's zero-offset footprint with the halo.
"""
import collections
import pathlib
import re
from unittest import mock

import numpy as np
import pytest
import torch

from aanet_torch.config import preset
from aanet_torch.ops import deform

K, DIL, PAD, GROUPS = 3, 2, 2, 2  # every deformable conv of the port's models
SMS = 132  # an H100 SXM's SMs
# (x shape, cout, stride) of each deformable conv of the aanet and
# stereonet-aa train steps (batch 16, 288x576) and inference forwards
# (384x1248; aanet's layer3 sees both views at once)
PATH_SHAPES = [
    ((16, 128, 48, 96), 128, 2), ((16, 128, 24, 48), 128, 1), ((16, 64, 96, 192), 64, 1),
    ((16, 32, 48, 96), 32, 1), ((16, 16, 24, 48), 16, 1), ((16, 48, 72, 144), 48, 1),
    ((2, 128, 64, 208), 128, 2), ((2, 128, 32, 104), 128, 1), ((1, 64, 128, 416), 64, 1),
    ((1, 32, 64, 208), 32, 1), ((1, 16, 32, 104), 16, 1), ((1, 48, 96, 312), 48, 1),
]


def _out(size, stride):
    return (size + 2 * PAD - DIL * (K - 1) - 1) // stride + 1


def _recorded_convs(name, hw):
    """The deformable convs of one CPU forward of preset ``name`` at ``hw``:
    {(cin, cout, kh, kw, stride, dilation, groups): calls}."""
    seen = collections.Counter()
    real = deform.modulated_deform_conv2d

    def record(x, offset, mask, weight, bias=None, **kw):
        cout, cin, kh, kw_ = weight.shape
        seen[(cin, cout, kh, kw_, kw["stride"], kw["dilation"], kw["deformable_groups"])] += 1
        return real(x, offset, mask, weight, bias, **kw)

    torch.manual_seed(0)
    model = preset(name).build().eval()
    with mock.patch.object(deform, "modulated_deform_conv2d", record), torch.no_grad():
        model(torch.randn(1, 3, *hw), torch.randn(1, 3, *hw))
    return seen


def _assert_window_covers(h, w, stride, tile_h, win_h, win_w):
    """The window of every tile holds both bilinear corners of every tap of
    every pixel at any offset within the halo."""
    ho, wo = _out(h, stride), _out(w, stride)
    for ho0 in range(0, ho, tile_h):
        win_y = ho0 * stride - PAD - deform.HALO
        for r in range(min(tile_h, ho - ho0)):
            for ki in range(K):
                for dy in (-deform.HALO, 0.0, 0.5, deform.HALO):
                    y0 = int(np.floor((ho0 + r) * stride - PAD + ki * DIL + dy))
                    assert win_y <= y0 and y0 + 1 < win_y + win_h
    for wo0 in range(0, wo, deform.TILE_W):
        win_x = wo0 * stride - PAD - deform.HALO
        for c in range(min(deform.TILE_W, wo - wo0)):
            for kj in range(K):
                for dx in (-deform.HALO, 0.0, 0.5, deform.HALO):
                    x0 = int(np.floor((wo0 + c) * stride - PAD + kj * DIL + dx))
                    assert win_x <= x0 and x0 + 1 < win_x + win_w


@pytest.mark.parametrize("name,calls", [("aanet", 15), ("stereonet-aa", 4)])
def test_path_shapes_are_the_models_convs(name, calls):
    """The list above holds every deformable conv configuration the two
    presets run (the plan depends on channels and geometry, not on the
    image size, so a small forward finds them all)."""
    seen = _recorded_convs(name, (48, 96))
    assert sum(seen.values()) == calls
    listed = {(x[1], cout, K, K, stride, DIL, GROUPS) for x, cout, stride in PATH_SHAPES}
    assert set(seen) <= listed


@pytest.mark.parametrize("x_shape,cout,stride", PATH_SHAPES)
def test_backward_data_plan_fits_and_covers(x_shape, cout, stride):
    b, cin, h, w = x_shape
    plan = deform.backward_data_plan(cin, cout, K, K, stride, DIL, GROUPS)
    cg = cin // GROUPS
    # shared memory: the gout tile, a tap's weights, the x and grad_x
    # windows and the per-pixel table and sums fit one block
    pixels = plan.tile_h * deform.TILE_W
    assert plan.smem_bytes <= deform.SMEM_BYTES == 227 * 1024
    assert plan.smem_bytes >= 4 * (cout * (pixels + plan.chunk) + 2 * plan.chunk * plan.win_h * plan.win_w)
    # a register budget the kernel is built for, and as many blocks as it
    # budgets for fit one SM's shared memory where that is more than two
    assert plan.blocks in (2, deform.MAX_BLOCKS)
    assert plan.blocks == 2 or plan.blocks * (plan.smem_bytes + 1024) <= deform.SM_SMEM_BYTES
    # every channel of the group in a chunk the kernel takes, none idle
    assert (plan.chunk, plan.tile_h) in deform.TILINGS
    assert plan.chunk * plan.chunks == cg
    assert deform.HALO >= 3  # chip_smoke's narrow offsets lie in (-3, 3)
    _assert_window_covers(h, w, stride, plan.tile_h, plan.win_h, plan.win_w)


@pytest.mark.parametrize("stride", [1, 2])
def test_backward_data_plan_takes_any_channel_count(stride):
    """Channel counts off the paths: chunks of 8 or 16 channels cover the
    group; fewer than 8 channels idle in a chunk; one block fits."""
    for cin, groups in [(c, g) for c in range(1, 129) for g in (1, 2, 4) if c % g == 0]:
        for cout in (1, 16, 128):
            plan = deform.backward_data_plan(cin, cout, K, K, stride, DIL, groups)
            cg = cin // groups
            assert (plan.chunk, plan.tile_h) in deform.TILINGS and plan.smem_bytes <= deform.SMEM_BYTES
            assert 0 <= plan.chunk * plan.chunks - cg < 8 * plan.chunks


def test_backward_data_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        deform.backward_data_plan(64, 4096, K, K, 1, DIL, 2)


@pytest.mark.parametrize("kh,kw", [(3, 3), (1, 3), (2, 1)])
def test_weight_taps_major_is_the_kernel_layout(kh, kw):
    """wt[k, co, c] = weight[co, c, k // kw, k % kw], contiguous."""
    weight = torch.from_numpy(np.random.RandomState(0).randn(5, 7, kh, kw).astype(np.float32))
    wt = deform.weight_taps_major(weight)
    assert wt.shape == (kh * kw, 5, 7) and wt.is_contiguous()
    for k in range(kh * kw):
        assert torch.equal(wt[k], weight[:, :, k // kw, k % kw])


def _forward_plan(x_shape, cout, stride, sms=SMS):
    b, cin, h, w = x_shape
    return deform.forward_plan(b, cin, cout, _out(h, stride), _out(w, stride), K, K, stride, DIL,
                               GROUPS, sms)


@pytest.mark.parametrize("x_shape,cout,stride", PATH_SHAPES)
def test_forward_plan_fits_and_fills(x_shape, cout, stride):
    b, cin, h, w = x_shape
    plan = _forward_plan(x_shape, cout, stride)
    pixels = plan.tile_h * deform.TILE_W
    # every output channel in one tile: no idle channel, no column sampled twice
    assert plan.co_tile == cout
    # the block: an 8 x 8 register tile per thread, whole warps
    assert plan.threads == (plan.co_tile // 8) * (pixels // 8) * plan.ksplit
    assert plan.threads % 32 == 0 and plan.threads <= deform.FWD_MAX_THREADS
    # shared memory (its layout is ``_fwd_smem``'s, held against the
    # kernel's own by the kernel): within a block's limit, and ``resident``
    # blocks within an SM's shared memory, threads and registers
    assert plan.smem_bytes <= deform.SMEM_BYTES == 227 * 1024
    assert plan.resident >= 1 and plan.resident * (plan.smem_bytes + 1024) <= deform.SM_SMEM_BYTES
    assert plan.resident * plan.threads <= deform.SM_THREADS
    assert plan.resident * plan.threads * deform.FWD_REGISTERS <= 65536
    # the grid: two waves of resident blocks, the tiles' chunks split
    # over blocks where the tiles alone are fewer, as far as each block
    # keeps min(8, chunks / 2) chunks of one group
    chunks = GROUPS * -(-(cin // GROUPS) // deform.FWD_CHUNK)
    floor = min(8, chunks // 2)
    tiles = -(-_out(h, stride) // plan.tile_h) * -(-_out(w, stride) // deform.TILE_W) * b
    assert plan.blocks == tiles * plan.splits
    assert plan.splits == 1 or (plan.splits % GROUPS == 0 and chunks % plan.splits == 0
                                and chunks // plan.splits >= floor)
    further = [s for s in range(plan.splits + 1, chunks + 1)
               if s % GROUPS == 0 and chunks % s == 0 and chunks // s >= floor]
    assert plan.blocks >= 2 * SMS * plan.resident or not further
    assert plan.blocks < 2 * SMS * plan.resident * plan.splits or plan.splits == 1  # the fewest
    _assert_window_covers(h, w, stride, plan.tile_h, plan.win_h, plan.win_w)


@pytest.mark.parametrize("name", ["TILE_W", "HALO", "FWD_MAX_THREADS", "FWD_MIN_BLOCKS",
                                  "FWD_CHUNK"])
def test_forward_constants_are_the_kernels(name):
    """The plan's constants are the kernel's: its tile width, halo,
    largest block, the blocks its launch bounds promise an SM (which cap
    a thread's registers at ``FWD_REGISTERS``) and its chunk."""
    source = (pathlib.Path(deform.__file__).parents[1] / "csrc" / "deform_conv.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", source)
    assert found == [str(getattr(deform, name))]
    if name == "FWD_MIN_BLOCKS":
        assert "__launch_bounds__(FWD_MAX_THREADS, FWD_MIN_BLOCKS)\ndeform_fwd_kernel" in source
        assert deform.FWD_REGISTERS * deform.FWD_MAX_THREADS * deform.FWD_MIN_BLOCKS == 65536


@pytest.mark.parametrize("cout", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("batch,size", [(16, (24, 48)), (1, (32, 104)), (2, (37, 53))])
def test_forward_plan_leaves_no_channel_idle(cout, batch, size):
    plan = deform.forward_plan(batch, cout, cout, *size, K, K, 1, DIL, GROUPS, SMS)
    assert plan.co_tile == cout and cout % plan.co_tile == 0
    wide = deform.forward_plan(batch, 64, 256, *size, K, K, 1, DIL, GROUPS, SMS)
    assert wide.co_tile == 128  # beyond 128: the largest tile that divides them


def test_forward_plan_is_deterministic():
    """The same shapes give the same plan, also without the cache, and the
    plan depends on the batch and the SM count (more tiles, or fewer SMs,
    split less)."""
    plans = [_forward_plan(x, cout, stride) for x, cout, stride in PATH_SHAPES]
    deform.forward_plan.cache_clear()
    assert [_forward_plan(x, cout, stride) for x, cout, stride in PATH_SHAPES] == plans
    layer3 = _forward_plan((16, 128, 24, 48), 128, 1)
    assert layer3.splits > 1
    assert _forward_plan((16, 128, 24, 48), 128, 1, sms=16).splits < layer3.splits
    assert _forward_plan((64, 128, 24, 48), 128, 1).splits < layer3.splits


def test_forward_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="output channels"):
        deform.forward_plan(1, 16, 12, 32, 32, K, K, 1, DIL, GROUPS, SMS)  # no tile divides 12
    with pytest.raises(ValueError, match="shared memory"):
        deform.forward_plan(1, 16, 128, 32, 32, 15, 15, 1, 4, GROUPS, SMS)  # 225 taps
    with pytest.raises(ValueError, match="groups"):
        deform.forward_plan(1, 15, 16, 32, 32, K, K, 1, DIL, GROUPS, SMS)


@pytest.mark.parametrize("kh,kw", [(3, 3), (1, 3), (2, 1)])
def test_weight_taps_cin_major_is_the_forward_layout(kh, kw):
    """wt[k, c, co] = weight[co, c, k // kw, k % kw], contiguous."""
    weight = torch.from_numpy(np.random.RandomState(1).randn(5, 7, kh, kw).astype(np.float32))
    wt = deform.weight_taps_cin_major(weight)
    assert wt.shape == (kh * kw, 7, 5) and wt.is_contiguous()
    for k in range(kh * kw):
        for c in range(7):
            for co in range(5):
                assert wt[k, c, co] == weight[co, c, k // kw, k % kw]
