"""The tilings and weight layouts of the deformable conv's kernels
(``aanet_torch/csrc/deform_conv.cu``: the forward, the input/offset/mask
gradient and the weight gradient), on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain twins there). What surrounds them is Python: the
wrappers pick the tile, the channel tile or chunk, the splits and the input
window per shape (``ops.deform.forward_plan``, ``backward_data_plan``,
``backward_weight_plan``) and lay the weight out ([tap, cin, cout]:
``weight_taps_cin_major``; [tap, cout, cin]: ``weight_taps_major``). Here
the plans are checked for every deformable conv that ``chip_smoke.py``'s
paths run: they fit a block's shared memory and registers, leave no
channel idle, fill the card, cover every tile once, and their windows cover
the tile's zero-offset footprint with the halo. Output-channel counts that
no multiple of 8 up to 128 divides get zero-padded channel tiles; the plans
at the path shapes are pinned, so that the padding rule changed none.
"""
import collections
import dataclasses
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


def _unet_convs(batch, h, w):
    """(x shape, cout, stride) of the five deformable convs of the UNet that
    GANet's extractor and the hourglass refinement share, on a 32-channel
    input of h x w: its own, the two deepest downsamplings and two merges."""
    return [((batch, 32, h, w), 32, 1), ((batch, 64, h // 4, w // 4), 96, 2),
            ((batch, 96, h // 8, w // 8), 128, 2), ((batch, 192, h // 8, w // 8), 96, 1),
            ((batch, 256, h // 16, w // 16), 128, 1)]


# aanet+'s UNet convs beside its ISA convs (those of the list above): GANet's
# extractor at H/3 (both views at once at inference), the hourglasses at
# H/2 and H, in the inference forward (384x1248) and the train step (batch
# 16, 288x576); ganet-aa runs the extractor's
UNET_SHAPES = [shape for (h, w), batches in (((384, 1248), (2, 1, 1)), ((288, 576), (16, 16, 16)))
               for k, b in zip((3, 2, 1), batches) for shape in _unet_convs(b, h // k, w // k)]


@pytest.mark.parametrize("name,calls", [("aanet", 15), ("stereonet-aa", 4), ("aanet+", 24),
                                        ("ganet-aa", 14)])
def test_path_shapes_are_the_models_convs(name, calls):
    """The lists above hold every deformable conv configuration the
    presets run (the plan depends on channels and geometry, not on the
    image size, so a small forward finds them all)."""
    seen = _recorded_convs(name, (96, 192) if "+" in name else (48, 96))
    assert sum(seen.values()) == calls
    listed = {(x[1], cout, K, K, stride, DIL, GROUPS) for x, cout, stride in
              PATH_SHAPES + UNET_SHAPES}
    assert set(seen) <= listed


@pytest.mark.parametrize("x_shape,cout,stride", UNET_SHAPES)
def test_unet_path_shapes_plan(x_shape, cout, stride):
    """Each of aanet+'s UNet convs plans at its path shape, forward,
    input/offset/mask gradient and weight gradient: every channel in one
    tile, a block's and an SM's shared memory, windows covering the taps
    at any offset within the halo."""
    b, cin, h, w = x_shape
    forward, weight = _forward_plan(x_shape, cout, stride), _weight_plan(x_shape, cout, stride)
    data = deform.backward_data_plan(cin, cout, K, K, stride, DIL, GROUPS)
    assert forward.co_tile == weight.co_tile == cout
    for plan in (forward, weight, data):
        assert plan.smem_bytes <= deform.SMEM_BYTES
    for plan in (forward, weight):
        assert plan.resident >= 1 and plan.resident * (plan.smem_bytes + 1024) <= deform.SM_SMEM_BYTES
        _assert_window_covers(h, w, stride, plan.tile_h, plan.win_h, plan.win_w)
    assert weight.workspace == weight.splits * cout * cin * K * K


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
    # no multiple of 8 divides 12: one zero-padded tile of 16, 4 channels idle
    twelve = deform.forward_plan(1, 16, 12, 32, 32, K, K, 1, DIL, GROUPS, SMS)
    assert twelve.co_tile == 16 and twelve.co_tile - 12 == 4
    assert twelve.blocks == -(-32 // twelve.tile_h) * -(-32 // deform.TILE_W) * twelve.splits
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


# The weight gradient (``backward_weight_plan``): the step shapes above and
# chip_smoke phase 6b's cases beyond them: an odd stride-2 shape, with two
# groups and mask-less with one, and the step's largest shape with one
# group.
WG_SHAPES = PATH_SHAPES + [((2, 24, 37, 53), 24, 2)]
WG_GROUPS = [(x, cout, stride, GROUPS) for x, cout, stride in WG_SHAPES] + [
    ((2, 24, 37, 53), 24, 2, 1), ((16, 64, 96, 192), 64, 1, 1)]


def _weight_plan(x_shape, cout, stride, groups=GROUPS, sms=SMS):
    b, cin, h, w = x_shape
    return deform.backward_weight_plan(b, cin, cout, _out(h, stride), _out(w, stride), K, K,
                                       stride, DIL, groups, sms)


@pytest.mark.parametrize("x_shape,cout,stride,groups", WG_GROUPS)
def test_backward_weight_plan_fits(x_shape, cout, stride, groups):
    b, cin, h, w = x_shape
    plan = _weight_plan(x_shape, cout, stride, groups)
    # the register tile: WG_TM output channels by all taps of one channel
    # a thread; whole warps, at most the launch bound
    assert plan.co_tile == cout and cout % deform.WG_TM == 0
    assert plan.threads == cout // deform.WG_TM * plan.chunk * plan.ksplit
    assert plan.threads % 32 == 0 and plan.threads <= deform.WG_MAX_THREADS
    # a step's pixel quads for each of the ksplit groups, a step within a tile
    assert plan.step_h in deform.WG_STEP_H and plan.tile_h % plan.step_h == 0
    assert plan.ksplit <= plan.step_h * deform.TILE_W // 4
    # shared memory: a block's and, for ``resident`` blocks, an SM's; at
    # least the two windows, gout tiles and column tiles
    rs = plan.step_h * deform.TILE_W + deform.WG_PAD
    assert plan.smem_bytes <= deform.SMEM_BYTES == 227 * 1024
    assert plan.smem_bytes >= 4 * 2 * (plan.chunk * plan.win_h * plan.win_w + cout * rs
                                       + plan.chunk * deform.WG_MAX_TAPS * rs)
    assert plan.resident >= 1 and plan.resident * (plan.smem_bytes + 1024) <= deform.SM_SMEM_BYTES
    # registers: the build's, for ``resident`` blocks of these threads
    assert plan.build in deform.WG_BUILDS
    registers = 65536 // (plan.build * deform.WG_MAX_THREADS)
    assert plan.resident * plan.threads * registers <= 65536
    assert plan.resident * plan.threads <= deform.SM_THREADS
    # the window of a tile covers its taps' reach at any offset within the halo
    if groups == GROUPS:
        _assert_window_covers(h, w, stride, plan.tile_h, plan.win_h, plan.win_w)
    # the workspace: one slab of the weight per split
    assert plan.workspace == plan.splits * cout * cin * K * K


@pytest.mark.parametrize("x_shape,cout,stride,groups", WG_GROUPS)
def test_backward_weight_plan_splits_cover_every_tile_once(x_shape, cout, stride, groups):
    """Split s takes units [s * U // splits, (s + 1) * U // splits) of the
    batch's U (batch, tile) units, as the kernel does: every unit once,
    none empty, and the grid within one wave of resident blocks."""
    b, _, h, w = x_shape
    plan = _weight_plan(x_shape, cout, stride, groups)
    units = b * -(-_out(h, stride) // plan.tile_h) * -(-_out(w, stride) // deform.TILE_W)
    assert 1 <= plan.splits <= units
    ranges = [range(s * units // plan.splits, (s + 1) * units // plan.splits)
              for s in range(plan.splits)]
    assert all(len(r) > 0 for r in ranges)
    assert sorted(u for r in ranges for u in r) == list(range(units))
    assert plan.blocks <= SMS * plan.resident * deform.WG_WAVES or plan.splits == 1


@pytest.mark.parametrize("cg", [8, 12, 16, 24, 32, 64])
@pytest.mark.parametrize("groups", [1, 2])
def test_backward_weight_plan_leaves_no_channel_idle(cg, groups):
    """A chunk divides the group's channels: no channel idles and no chunk
    straddles two groups; chunks are whole channel quads (the window's)."""
    cin = cg * groups
    for cout in (16, 48, 128):
        plan = deform.backward_weight_plan(16, cin, cout, 24, 48, K, K, 1, DIL, groups, SMS)
        assert plan.chunk % 4 == 0 and cg % plan.chunk == 0
        chunks = [(g * cg + j * plan.chunk, g * cg + (j + 1) * plan.chunk)
                  for g in range(groups) for j in range(cg // plan.chunk)]
        assert all(c0 // cg == (c1 - 1) // cg for c0, c1 in chunks)  # within one group
        assert sorted(c for c0, c1 in chunks for c in range(c0, c1)) == list(range(cin))


def test_backward_weight_plan_is_deterministic():
    """The same shapes give the same plan, also without the cache; the
    tiling depends on the conv, not on the batch or the SM count, while the
    splits fill one wave of the card's SMs, capped only by a batch too
    small for it."""
    plans = [_weight_plan(x, cout, stride) for x, cout, stride in WG_SHAPES]
    deform.backward_weight_plan.cache_clear()
    assert [_weight_plan(x, cout, stride) for x, cout, stride in WG_SHAPES] == plans
    layer3 = _weight_plan((16, 128, 24, 48), 128, 1)
    fewer_sms = _weight_plan((16, 128, 24, 48), 128, 1, sms=16)
    assert fewer_sms.splits < layer3.splits
    assert fewer_sms._replace(splits=0, blocks=0, workspace=0) == layer3._replace(
        splits=0, blocks=0, workspace=0)
    assert _weight_plan((64, 128, 24, 48), 128, 1).splits == layer3.splits
    tiny = _weight_plan((1, 128, 8, 16), 128, 1)  # one tile: one split
    assert tiny.splits == 1


def test_backward_weight_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="taps"):
        deform.backward_weight_plan(1, 16, 16, 32, 32, 5, 5, 1, 1, GROUPS, SMS)
    # no multiple of 8 divides 12: one zero-padded tile of 16, 4 channels
    # idle, the workspace of the real channels only
    twelve = deform.backward_weight_plan(1, 16, 12, 32, 32, K, K, 1, DIL, GROUPS, SMS)
    assert twelve.co_tile == 16 and twelve.co_tile - 12 == 4
    assert twelve.workspace == twelve.splits * 12 * 16 * K * K
    with pytest.raises(ValueError, match="groups"):
        deform.backward_weight_plan(1, 15, 16, 32, 32, K, K, 1, DIL, GROUPS, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        deform.backward_weight_plan(1, 64, 128, 32, 32, K, K, 4, 64, GROUPS, SMS)


@pytest.mark.parametrize("name", ["TILE_W", "HALO", "WG_MAX_THREADS", "WG_TM", "WG_MAX_TAPS",
                                  "WG_PAD"])
def test_backward_weight_constants_are_the_kernels(name):
    """The plan's constants are the kernel's: its tile width, halo, largest
    block, register tile and row padding; and the kernel is built for each
    step height and register budget the plan may name."""
    source = (pathlib.Path(deform.__file__).parents[1] / "csrc" / "deform_conv.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", source)
    assert found == [str(getattr(deform, name))]
    if name == "WG_MAX_THREADS":
        assert ("template <int STEP_H, int BLOCKS, typename T>\n__global__ void __launch_bounds__("
                "WG_MAX_THREADS, BLOCKS)\ndeform_wgrad_kernel") in source
        built = set(re.findall(r"deform_wgrad_kernel<(\d+), (\d+), T>", source))
        assert built == {(str(s), str(b)) for s in deform.WG_STEP_H for b in deform.WG_BUILDS}


# --- output-channel counts off the multiples of 8: zero-padded channel tiles

# the parent tree's plans at the path shapes (forward, weight gradient), pinned
PINNED = {
    ((16, 128, 48, 96), 128, 2): ((8, 128, 1, 4, 256, 26, 42, 108672, 2, 576),
        (8, 2, 128, 16, 1, 16, 256, 26, 42, 225024, 1, 1, 128, 2359296)),
    ((16, 128, 24, 48), 128, 1): ((8, 128, 1, 4, 256, 19, 27, 90144, 2, 576),
        (8, 4, 128, 16, 1, 16, 256, 19, 27, 227456, 1, 1, 128, 2359296)),
    ((16, 64, 96, 192), 64, 1): ((16, 64, 1, 1, 256, 27, 27, 115488, 2, 1152),
        (16, 4, 64, 16, 2, 33, 256, 27, 27, 220288, 1, 1, 132, 1216512)),
    ((16, 32, 48, 96), 32, 1): ((8, 32, 2, 2, 128, 19, 27, 62496, 3, 1152),
        (16, 4, 32, 16, 4, 66, 256, 27, 27, 202880, 1, 1, 132, 608256)),
    ((16, 16, 24, 48), 16, 1): ((8, 16, 4, 2, 128, 19, 27, 57888, 3, 288),
        (16, 8, 16, 8, 16, 66, 256, 27, 27, 167232, 1, 1, 132, 152064)),
    ((16, 48, 72, 144), 48, 1): ((16, 48, 1, 1, 192, 27, 27, 110880, 2, 720),
        (8, 4, 48, 8, 4, 44, 192, 19, 27, 111936, 2, 2, 264, 912384)),
    ((2, 128, 64, 208), 128, 2): ((8, 128, 1, 4, 256, 26, 42, 108672, 2, 224),
        (8, 2, 128, 16, 1, 16, 256, 26, 42, 225024, 1, 1, 128, 2359296)),
    ((2, 128, 32, 104), 128, 1): ((8, 128, 1, 4, 256, 19, 27, 90144, 2, 224),
        (8, 4, 128, 16, 1, 16, 256, 19, 27, 227456, 1, 1, 128, 2359296)),
    ((1, 64, 128, 416), 64, 1): ((16, 64, 1, 2, 256, 27, 27, 115488, 2, 416),
        (16, 4, 64, 16, 2, 33, 256, 27, 27, 220288, 1, 1, 132, 1216512)),
    ((1, 32, 64, 208), 32, 1): ((8, 32, 2, 2, 128, 19, 27, 62496, 3, 208),
        (16, 4, 32, 16, 4, 52, 256, 27, 27, 202880, 1, 1, 104, 479232)),
    ((1, 16, 32, 104), 16, 1): ((8, 16, 4, 2, 128, 19, 27, 57888, 3, 56),
        (16, 8, 16, 8, 16, 14, 256, 27, 27, 167232, 1, 1, 28, 32256)),
    ((1, 48, 96, 312), 48, 1): ((16, 48, 1, 2, 192, 27, 27, 110880, 2, 240),
        (8, 4, 48, 8, 4, 44, 192, 19, 27, 111936, 2, 2, 264, 912384)),
}


@pytest.mark.parametrize("x_shape,cout,stride", PATH_SHAPES)
def test_path_plans_are_pinned(x_shape, cout, stride):
    """The padding rule leaves every plan that planned before it as it was:
    at the path shapes, the same forward and weight-gradient plans."""
    assert set(PINNED) == {(x, c, s) for x, c, s in PATH_SHAPES}
    forward, weight = PINNED[(x_shape, cout, stride)]
    assert tuple(_forward_plan(x_shape, cout, stride)) == forward
    assert tuple(_weight_plan(x_shape, cout, stride)) == weight


def _covers(cout, co_tile):
    """The grid's ceil(cout / co_tile) tiles cover cout once, the last one's
    channels at or above cout idle, fewer than 8 a tile."""
    tiles = -(-cout // co_tile)
    assert co_tile % 8 == 0 and 8 <= co_tile <= 128
    assert (tiles - 1) * co_tile < cout <= tiles * co_tile
    assert tiles * co_tile - cout < 8 * tiles
    return tiles


@pytest.mark.parametrize("cout", range(1, 261))
def test_every_output_channel_count_plans(cout):
    """Every cout from 1 to 260 gets a forward and a weight-gradient plan
    (cin = 64 in two groups, the step's 96x192 at batch 16): a multiple of
    8 up to 128 that divides cout where one fits a tiling (no idle
    channel), else zero-padded tiles; the same tile for both kernels."""
    forward = deform.forward_plan(16, 64, cout, 96, 192, K, K, 1, DIL, GROUPS, SMS)
    weight = deform.backward_weight_plan(16, 64, cout, 96, 192, K, K, 1, DIL, GROUPS, SMS)
    tiles = _covers(cout, forward.co_tile)
    assert forward.co_tile == weight.co_tile
    assert forward.blocks == -(-96 // forward.tile_h) * -(-192 // deform.TILE_W) * tiles * 16 \
        * forward.splits
    assert weight.blocks == GROUPS * -(-32 // weight.chunk) * tiles * weight.splits
    assert weight.workspace == weight.splits * cout * 64 * K * K  # the real channels' rows
    divisors = [c for c in range(8, min(cout, 128) + 1, 8) if cout % c == 0]
    if divisors and (divisors[-1] // 8) not in (9, 11, 13, 15):
        assert forward.co_tile == divisors[-1]
    assert forward.co_tile in deform.channel_tiles("deform conv", cout)


def _isa_convs(name, max_disp):
    """The deformable convs of preset ``name`` at ``max_disp``: (cout, cin,
    stride, dilation, groups) of each."""
    from aanet_torch.models.layers import DeformConv2dLayer

    model = dataclasses.replace(preset(name), max_disp=max_disp).build()
    return sorted({(m.weight.shape[0], m.weight.shape[1], m.stride, m.dilation, m.groups)
                   for m in model.modules() if isinstance(m, DeformConv2dLayer)})


def _plans(convs):
    """Each conv's forward, input/offset/mask-gradient and weight-gradient
    plans at the step's batch and the ISA scales of 288x576 (/3, /12)."""
    for cout, cin, stride, dil, groups in convs:
        for h, w in ((96, 192), (24, 48)):
            forward = deform.forward_plan(16, cin, cout, h // stride, w // stride, K, K, stride, dil,
                                          groups, SMS)
            weight = deform.backward_weight_plan(16, cin, cout, h // stride, w // stride, K, K,
                                                 stride, dil, groups, SMS)
            _covers(cout, forward.co_tile)
            _covers(cout, weight.co_tile)
        deform.backward_data_plan(cin, cout, K, K, stride, dil, groups)


@pytest.mark.parametrize("max_disp", [48, 96, 144, 192])
@pytest.mark.parametrize("name", ["aanet", "stereonet-aa"])
def test_presets_deform_convs_plan(name, max_disp):
    """Each preset's deformable convs at max_disp 48 to 192 plan, forward,
    input/offset/mask gradient and weight gradient: the ISA convs have
    max_disp / scale / 2^i channels (aanet at 48: 16, 8 and 4; stereonet-aa
    at 48: 12)."""
    convs = _isa_convs(name, max_disp)
    if max_disp == 48:
        assert {c[0] for c in convs} >= ({16, 8, 4} if name == "aanet" else {12})
    _plans(convs)


@pytest.mark.parametrize("counts", [(48, 24, 12), (96, 48, 24)])
def test_adaptive_baselines_isa_counts_plan(counts):
    """The ISA channel counts of psmnet-aa and gcnet-aa at max_disp 192
    (max_disp / 4 and / 2 over three scales), with their two deformable
    groups."""
    _plans([(c, c, 1, DIL, GROUPS) for c in counts])


@pytest.mark.parametrize("cout,pad", [(12, 16), (20, 24), (4, 8), (16, 16)])
def test_weight_taps_cin_major_pads_the_channels(cout, pad):
    """The forward's weight [tap, cin, cout_pad]: the weight's channels,
    then zeros up to the tiles' channels."""
    weight = torch.from_numpy(np.random.RandomState(2).randn(cout, 6, K, K).astype(np.float32))
    wt = deform.weight_taps_cin_major(weight, pad)
    assert wt.shape == (K * K, 6, pad) and wt.is_contiguous()
    assert torch.equal(wt[..., :cout], deform.weight_taps_cin_major(weight))
    assert not wt[..., cout:].any()
