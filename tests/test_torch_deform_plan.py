"""The tiling and weight layout of the deformable conv's input/offset/mask
gradient kernel (``aanet_torch/csrc/deform_conv.cu``), on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
its plain twin there). What surrounds it is Python: the wrapper picks the
channel chunk, the tile and the input window per shape
(``ops.deform.backward_data_plan``) and lays the weight out tap-major
(``ops.deform.weight_taps_major``). Here the plan is checked for every
deformable conv that ``chip_smoke.py``'s paths run: it fits a block's
shared memory, its chunks cover the group's channels with none idle, and
its window covers the tile's zero-offset footprint with the halo.
"""
import collections
from unittest import mock

import numpy as np
import pytest
import torch

from aanet_torch.config import preset
from aanet_torch.ops import deform

K, DIL, PAD, GROUPS = 3, 2, 2, 2  # every deformable conv of the port's models
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
    # the window of every tile holds both bilinear corners of every tap
    # of every pixel at any offset within the halo
    ho, wo = _out(h, stride), _out(w, stride)
    for ho0 in range(0, ho, plan.tile_h):
        win_y = ho0 * stride - PAD - deform.HALO
        for r in range(min(plan.tile_h, ho - ho0)):
            for ki in range(K):
                for dy in (-deform.HALO, 0.0, 0.5, deform.HALO):
                    y0 = int(np.floor((ho0 + r) * stride - PAD + ki * DIL + dy))
                    assert win_y <= y0 and y0 + 1 < win_y + plan.win_h
    for wo0 in range(0, wo, deform.TILE_W):
        win_x = wo0 * stride - PAD - deform.HALO
        for c in range(min(deform.TILE_W, wo - wo0)):
            for kj in range(K):
                for dx in (-deform.HALO, 0.0, 0.5, deform.HALO):
                    x0 = int(np.floor((wo0 + c) * stride - PAD + kj * DIL + dx))
                    assert win_x <= x0 and x0 + 1 < win_x + plan.win_w


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
