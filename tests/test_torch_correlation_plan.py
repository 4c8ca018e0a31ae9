"""The tilings of the correlation cost volume's kernels
(``aanet_torch/csrc/correlation.cu``: the forward and the backward), on the
CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain twins there). What surrounds them is Python: the wrappers pick
the tile width, the disparity tile, the channel split and chunk per shape
and SM count (``ops.cost_volume.forward_plan``, ``backward_plan``). Here the
plans are checked for every correlation that ``chip_smoke.py``'s paths run:
they fit a block's shared memory and registers, and the kernels' thread
mappings, replayed in numpy, cover every output once and spend no tile on
disparities beyond D.
"""
import collections
import pathlib
import re
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from aanet_torch._build import SM_SMEM_BYTES
from aanet_torch.config import preset
from aanet_torch.ops import cost_volume as cv

SMS = 132  # an H100 SXM's SMs
# (L and R shape, max_disp) of each correlation of the aanet, stereonet-aa,
# psmnet-aa and aanet+ train steps (batch 16, 288x576) and of their,
# gcnet-aa's and ganet-aa's inference forwards (384x1248), and
# chip_smoke.py phase 6b's shapes beyond them: widths that are not a
# multiple of 4, channels off the chunks, D > W, D = 1, 24 and 40, batch 3
PATH_SHAPES = chip_smoke.CORR_PATH_SHAPES
EDGE_SHAPES = chip_smoke.CORR_EDGE_SHAPES
INPUTS = {"aanet": [(288, 576), (384, 1248)], "stereonet-aa": [(288, 576), (384, 1248)],
          "psmnet-aa": [(288, 576), (384, 1248)], "gcnet-aa": [(384, 1248)],
          "aanet+": [(288, 576), (384, 1248)], "ganet-aa": [(384, 1248)]}
# the small input each preset's CPU forward runs at (psmnet-aa's SPP pools
# 64-px windows at H/4; aanet+ pads to multiples of 96)
SMALL = {"aanet": (48, 96), "stereonet-aa": (48, 96), "psmnet-aa": (256, 256),
         "gcnet-aa": (48, 96), "aanet+": (96, 192), "ganet-aa": (48, 96)}
SOURCE = (pathlib.Path(cv.__file__).parents[1] / "csrc" / "correlation.cu").read_text()


def _recorded_volumes(name, hw):
    """The correlations of one CPU forward of preset ``name`` at ``hw``:
    {(channels, max_disp, height, width): calls}."""
    seen = collections.Counter()
    real = cv.correlation_cost_volume

    def record(left, right, max_disp):
        seen[(left.shape[1], max_disp) + tuple(left.shape[2:])] += 1
        return real(left, right, max_disp)

    torch.manual_seed(0)
    model = preset(name).build().eval()
    with mock.patch.object(cv, "correlation_cost_volume", record), torch.no_grad():
        model(torch.randn(1, 3, *hw), torch.randn(1, 3, *hw))
    return seen


@pytest.mark.parametrize("name,calls", [("aanet", 3), ("stereonet-aa", 1), ("psmnet-aa", 3),
                                        ("gcnet-aa", 3), ("aanet+", 3), ("ganet-aa", 3)])
def test_path_shapes_are_the_models_volumes(name, calls):
    """chip_smoke.py's list holds every correlation the presets run: a small
    forward finds their channels, disparities and the scales of the input
    they run at, and those at the paths' sizes are the listed ones."""
    hw = SMALL[name]
    seen = _recorded_volumes(name, hw)
    assert sum(seen.values()) == calls
    listed = {(s[1], d, s[2], s[3]) for s, d in PATH_SHAPES}
    for c, d, h, w in seen:
        for full in INPUTS[name]:
            scale = hw[0] // h
            assert hw[1] // w == scale
            assert (c, d, full[0] // scale, full[1] // scale) in listed


def _registers(max_threads, min_blocks):
    """A thread's registers under __launch_bounds__(max_threads,
    min_blocks): an SM's 64K over the threads it must hold."""
    return 65536 // (max_threads * min_blocks)


def _forward_cover(plan, width, max_disp, channels):
    """Replays the forward kernel's thread mapping on one row: how often each
    (disparity, column) is stored, and how often each channel of each chunk
    is contracted for each (disparity, column)."""
    nx, dd, ny, ks = plan.tile_w // cv.FWD_CW, plan.dd, plan.ny, plan.ksplit
    group = nx * ny
    stores = np.zeros((max_disp, width), int)
    contracted = np.zeros((channels, max_disp, width), int)
    for w0 in range(0, width, plan.tile_w):
        for tid in range(plan.threads):
            k, t = divmod(tid, group)
            y = (t // cv.FWD_LX) % ny
            x = t % cv.FWD_LX + cv.FWD_LX * (t // (cv.FWD_LX * ny))
            ds = [y * dd + j for j in range(dd) if y * dd + j < max_disp]
            ws = [w0 + cv.FWD_CW * x + i for i in range(cv.FWD_CW) if w0 + cv.FWD_CW * x + i < width]
            if k == 0:
                stores[np.ix_(ds, ws)] += 1
            for n in range(-(-channels // plan.chunk)):
                for cc in range(k, min(plan.chunk, channels - n * plan.chunk), ks):
                    contracted[np.ix_([n * plan.chunk + cc], ds, ws)] += 1
    return stores, contracted


def _backward_cover(plan, width, channels):
    """Replays the backward kernel's thread mapping on one row: how often
    each (channel, column) of dL and of dR is stored."""
    nx, ncg = plan.tile_w // cv.BWD_CW, plan.chunk // cv.BWD_CC
    per_side = nx * ncg
    stores = np.zeros((2, channels, width), int)
    for w0 in range(0, width, plan.tile_w):
        for tid in range(plan.threads):
            side, t = divmod(tid, per_side)
            cg = (t // cv.BWD_LX) % ncg
            x = t % cv.BWD_LX + cv.BWD_LX * (t // (cv.BWD_LX * ncg))
            w = w0 + cv.BWD_CW * x
            for n in range(-(-channels // plan.chunk)):
                cs = [n * plan.chunk + cg * cv.BWD_CC + q for q in range(cv.BWD_CC)]
                cs = [c for c in cs if c < channels]
                ws = [w + i for i in range(cv.BWD_CW) if w + i < width]
                if w < width:
                    stores[np.ix_([side], cs, ws)] += 1
    return stores


@pytest.mark.parametrize("shape,max_disp", PATH_SHAPES + EDGE_SHAPES)
def test_forward_plan_fits_and_covers(shape, max_disp):
    b, c, h, w = shape
    plan = cv.forward_plan(b, c, h, w, max_disp, SMS)
    # the block: whole warps within the launch bounds; the tile's
    # disparity groups cover D
    assert plan.dd in cv.FWD_DD and plan.ny == -(-max_disp // plan.dd)
    assert plan.threads == plan.tile_w // cv.FWD_CW * plan.ny * plan.ksplit
    assert plan.threads % 32 == 0 and plan.threads <= cv.FWD_MAX_THREADS
    assert plan.tile_w % (cv.FWD_CW * cv.FWD_LX) == 0 and plan.ksplit <= plan.chunk
    # shared memory: two chunks' left tiles and right windows (the partial
    # tiles of the channel split reuse them), within a block's limit; a
    # block fits an SM by shared memory and by the registers its launch
    # bounds allow a thread
    dtot = plan.ny * plan.dd
    assert plan.smem_bytes == 4 * max(2 * plan.chunk * (2 * plan.tile_w + dtot),
                                      (plan.ksplit - 1) * plan.tile_w * dtot)
    assert plan.smem_bytes <= cv.SMEM_BYTES == 227 * 1024
    assert plan.smem_bytes + 1024 <= SM_SMEM_BYTES
    assert plan.threads * _registers(cv.FWD_MAX_THREADS, cv.FWD_MIN_BLOCKS) <= 65536
    assert plan.blocks == b * h * -(-w // plan.tile_w)
    # every (disparity, column) stored once; every channel contracted once
    # into each of them
    stores, contracted = _forward_cover(plan, w, max_disp, c)
    assert (stores == 1).all() and (contracted == 1).all()


@pytest.mark.parametrize("shape,max_disp", PATH_SHAPES + EDGE_SHAPES)
def test_backward_plan_fits_and_covers(shape, max_disp):
    b, c, h, w = shape
    plan = cv.backward_plan(b, c, h, w, max_disp, SMS)
    # the block: whole warps for each gradient within the launch bounds;
    # the slide's trips cover D
    assert plan.dtot % cv.BWD_DSTEP == 0 and 0 <= plan.dtot - max_disp < cv.BWD_DSTEP
    per_side = plan.tile_w // cv.BWD_CW * (plan.chunk // cv.BWD_CC)
    assert plan.chunk % cv.BWD_CC == 0 and per_side % 32 == 0
    assert plan.threads == 2 * per_side <= cv.BWD_MAX_THREADS
    assert plan.tile_w % (cv.BWD_CW * cv.BWD_LX) == 0
    # shared memory: the gradient tiles and two chunks' windows, within a
    # block's limit; a block fits an SM by shared memory and registers
    assert plan.smem_bytes == 4 * (2 * plan.dtot * plan.tile_w
                                   + 4 * plan.chunk * (plan.tile_w + plan.dtot))
    assert plan.smem_bytes <= cv.SMEM_BYTES
    assert plan.smem_bytes + 1024 <= SM_SMEM_BYTES
    assert plan.threads * _registers(cv.BWD_MAX_THREADS, cv.BWD_MIN_BLOCKS) <= 65536
    assert plan.blocks == b * h * -(-w // plan.tile_w)
    # every (channel, column) of dL and of dR stored once
    assert (_backward_cover(plan, w, c) == 1).all()


@pytest.mark.parametrize("shape,max_disp", [s for s in PATH_SHAPES if s[1] % 16 == 0])
def test_plans_spend_no_tile_beyond_d(shape, max_disp):
    """Where D is a multiple of 16 the disparity groups of the forward and
    the slide of the backward end at D."""
    b, c, h, w = shape
    fwd = cv.forward_plan(b, c, h, w, max_disp, SMS)
    assert fwd.ny * fwd.dd == max_disp
    assert cv.backward_plan(b, c, h, w, max_disp, SMS).dtot == max_disp


def test_every_plan_of_the_lists_fits():
    """The lists the plans are picked from (and the sweep times) hold only
    tilings the kernels take: whole warps, the launch bounds, a block's
    shared memory."""
    for (b, c, h, w), d in PATH_SHAPES + EDGE_SHAPES:
        for p in cv.forward_plans(b, c, h, w, d):
            assert p.threads % 32 == 0 and p.threads <= cv.FWD_MAX_THREADS
            assert p.smem_bytes <= cv.SMEM_BYTES and p.ksplit <= p.chunk
        for p in cv.backward_plans(b, c, h, w, d):
            assert p.threads % 64 == 0 and p.threads <= cv.BWD_MAX_THREADS
            assert p.smem_bytes <= cv.SMEM_BYTES and p.chunk % cv.BWD_CC == 0


def test_plans_are_deterministic():
    """The same shapes give the same plans, also without the cache; a grid
    short of the card splits the channels more, and a card of fewer SMs
    less."""
    plans = [(cv.forward_plan(*s, d, SMS), cv.backward_plan(*s, d, SMS)) for s, d in PATH_SHAPES]
    cv.forward_plan.cache_clear()
    cv.backward_plan.cache_clear()
    assert [(cv.forward_plan(*s, d, SMS), cv.backward_plan(*s, d, SMS))
            for s, d in PATH_SHAPES] == plans
    short = cv.forward_plan(1, 128, 32, 104, 16, SMS)
    assert short.ksplit > cv.forward_plan(16, 128, 24, 48, 16, SMS).ksplit > 1
    assert cv.forward_plan(1, 128, 32, 104, 16, 16).ksplit < short.ksplit
    assert cv.forward_plan(16, 128, 96, 192, 64, SMS).ksplit == 1


def test_plans_raise_when_nothing_fits():
    # 1024 disparities: 64 groups of 16 need more than a block's threads
    with pytest.raises(ValueError, match="no forward tiling"):
        cv.forward_plan(1, 32, 8, 64, 1024, SMS)
    # 4096 disparities: the gradient tiles alone exceed a block's shared memory
    with pytest.raises(ValueError, match="no tiling"):
        cv.backward_plan(1, 32, 8, 64, 4096, SMS)


@pytest.mark.parametrize("name", ["FWD_CW", "FWD_LX", "FWD_MAX_THREADS", "FWD_MIN_BLOCKS",
                                  "BWD_CW", "BWD_CC", "BWD_LX", "BWD_DSTEP", "BWD_MAX_THREADS",
                                  "BWD_MIN_BLOCKS"])
def test_constants_are_the_kernels(name):
    """The plans' constants are the kernels': tiles, warp layout, the slide's
    step and the launch bounds (which cap a thread's registers)."""
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found == [str(getattr(cv, name))]
    if name == "FWD_MIN_BLOCKS":  # the float32 form's float64 tile takes one block an SM
        assert "__launch_bounds__(FWD_MAX_THREADS, FWD_MIN_BLOCKS)\ncorr_fwd_kernel" in SOURCE
        assert "constexpr int FWD_MIN_BLOCKS = 1;" in SOURCE
    if name == "BWD_MIN_BLOCKS":
        assert "__launch_bounds__(BWD_MAX_THREADS, BWD_MIN_BLOCKS)\ncorr_bwd_kernel" in SOURCE


def test_builds_and_layouts_are_the_kernels():
    """The forward is built for each disparity tile the plans name, and both
    kernels' shared-memory layouts are the plans' formulas."""
    assert set(re.findall(r"corr_fwd_kernel<(\d+)>", SOURCE)) == {str(d) for d in cv.FWD_DD}
    assert "const int stage = 2 * chunk * (2 * tw + dtot);" in SOURCE
    assert "const int partial = (ksplit - 1) * tw * dtot;" in SOURCE
    assert "return 2 * dtot * bw + 2 * 2 * chunk * (bw + dtot);" in SOURCE
    assert "bwd_smem_words(bw, dtot, chunk) * static_cast<int>(sizeof(float)) != smem_bytes" in SOURCE


# --- ``widen4`` (common.cuh), which the bf16 kernels' loads of raw quads use


def test_bf16_quad_widening_is_exact():
    """``widen4``: four bf16 values in 8 bytes (the first in the low half of
    the first word) become their float32 values exactly, subnormals, inf and
    NaN included."""
    rng = np.random.RandomState(3)
    bits = rng.randint(0, 2**16, size=4 * 4096, dtype=np.int64).astype(np.uint16)
    bits[:8] = [0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0x0001, 0x807F, 0x3F80]
    words = bits.reshape(-1, 2).astype(np.uint32)
    packed = words[:, 0] | (words[:, 1] << 16)  # the 8-byte quad as two little-endian words
    lo = (packed << 16).view(np.float32)
    hi = (packed & 0xFFFF0000).view(np.float32)
    widened = np.stack([lo, hi], 1).ravel()
    want = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16).float().numpy()
    assert np.array_equal(widened.view(np.uint32), want.view(np.uint32))
