"""The bf16 deformable conv's weight gradient on the tensor cores
(``aanet_torch/csrc/deform_conv.cu``: ``deform_wgrad_mma_kernel``, behind
``aanet_deform_conv_backward_weight_bf16``), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain twin there). Here: its plan (``ops.deform.backward_weight_plan_bf16``)
at every path shape and every output-channel count from 1 to 260 (a
block's and an SM's shared memory, every output channel, input channel and
pixel once); the plan's constants and shared-memory formula against the
kernel source; and numpy replays of what the kernel does in shared memory:
the channel-minor copy of the raw x window and the corners it reads, the
lanes' column stores, and the contraction lane by lane (``ldmatrix`` and
``mma.sync.m16n8k16`` as PTX defines their fragments, the column split
into three bf16 planes where the fragments are built, the epilogue's
hi + 2^-8 (mid + 2^-8 lo) and the fixed-order sum of the splits' slabs),
against the product in float64.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from aanet_torch.ops import deform
from test_torch_deform_bf16_mma import _ldmatrix, _mma
from test_torch_deform_plan import PATH_SHAPES, UNET_SHAPES, _assert_window_covers, _isa_convs

K, DIL, PAD, GROUPS = 3, 2, 2, 2  # every deformable conv of the port's models
SMS = 132
SOURCE = (pathlib.Path(deform.__file__).parents[1] / "csrc" / "deform_conv.cu").read_text()
PLAN_SHAPES = PATH_SHAPES + UNET_SHAPES
P = deform.MMA_WG_STEP_H * deform.TILE_W  # a step's pixels


def _out(size, stride):
    return (size + 2 * PAD - DIL * (K - 1) - 1) // stride + 1


def _plan(b, cin, cout, h, w, stride=1, groups=GROUPS, sms=SMS):
    return deform.backward_weight_plan_bf16(b, cin, cout, _out(h, stride), _out(w, stride), K, K,
                                            stride, PAD, DIL, groups, sms)


def _check_plan(plan, b, cin, cout, ho, wo, groups=GROUPS, sms=SMS):
    """The plan fits a block's and, for its resident blocks, an SM's shared
    memory; its channel tiles cover cout once and its chunks every input
    channel of a group once; its splits take every (batch, tile) unit once,
    none empty, within one wave of resident blocks."""
    assert plan.co_tile in deform.MMA_WG_BUILDS and plan.build == deform.MMA_WG_BUILDS[plan.co_tile]
    assert plan.co_tile >= min(cout, 128) and (plan.co_tile == 16 or plan.co_tile // 2 < cout)
    tiles = -(-cout // plan.co_tile)
    assert (tiles - 1) * plan.co_tile < cout <= tiles * plan.co_tile
    assert plan.tile_h in deform.MMA_WG_TILE_H and plan.tile_h % deform.MMA_WG_STEP_H == 0
    assert plan.smem_bytes <= deform.SMEM_BYTES
    assert 1 <= plan.resident <= plan.build
    assert plan.resident * (plan.smem_bytes + 1024) <= deform.SM_SMEM_BYTES
    cg = cin // groups
    chunks = -(-cg // deform.MMA_WG_CHUNK)
    covered = sorted(c for g in range(groups) for j in range(chunks)
                     for c in range(g * cg + j * deform.MMA_WG_CHUNK,
                                    min((g + 1) * cg, g * cg + (j + 1) * deform.MMA_WG_CHUNK)))
    assert covered == list(range(cin))
    units = b * -(-ho // plan.tile_h) * -(-wo // deform.TILE_W)
    assert 1 <= plan.splits <= units
    runs = [range(s * units // plan.splits, (s + 1) * units // plan.splits)
            for s in range(plan.splits)]
    assert all(len(r) > 0 for r in runs) and sorted(u for r in runs for u in r) == list(range(units))
    base = groups * chunks * tiles
    assert plan.blocks == base * plan.splits
    assert plan.blocks <= sms * plan.resident or plan.splits == 1
    assert plan.workspace == plan.splits * cout * cin * K * K


@pytest.mark.parametrize("x_shape,cout,stride", PLAN_SHAPES)
def test_plan_fits_and_covers(x_shape, cout, stride):
    """At every deformable conv of the presets' paths (aanet's, stereonet-aa's
    and aanet+'s ISA convs, aanet+'s UNet convs): the plan fits and covers,
    and the tile's window holds both corners of every tap at any offset
    within the halo."""
    b, cin, h, w = x_shape
    plan = _plan(b, cin, cout, h, w, stride)
    _check_plan(plan, b, cin, cout, _out(h, stride), _out(w, stride))
    _assert_window_covers(h, w, stride, plan.tile_h, plan.win_h, plan.win_w)


@pytest.mark.parametrize("x_shape,cout,stride", [s for s in PATH_SHAPES if s[0][0] == 16])
def test_plan_keeps_the_builds_resident_blocks(x_shape, cout, stride):
    """At the train steps' shapes every conv keeps the resident blocks its
    build's registers allow (the tile height gives way first)."""
    b, cin, h, w = x_shape
    plan = _plan(b, cin, cout, h, w, stride)
    assert plan.resident == plan.build


@pytest.mark.parametrize("cout", range(1, 261))
def test_plan_takes_every_output_channel_count(cout):
    """Every cout from 1 to 260 (cin 64 in two groups, the step's 96x192 at
    batch 16) plans, its tiles covering cout once."""
    plan = deform.backward_weight_plan_bf16(16, 64, cout, 96, 192, K, K, 1, PAD, DIL, GROUPS, SMS)
    _check_plan(plan, 16, 64, cout, 96, 192)


@pytest.mark.parametrize("name,max_disp", [("aanet", 48), ("aanet", 192), ("stereonet-aa", 48),
                                           ("stereonet-aa", 192)])
def test_plan_at_the_presets_convs(name, max_disp):
    """The presets' deformable convs (every output-channel count they have)
    plan at the step's ISA scales, with one group and with two."""
    for cout, cin, stride, dil, groups in _isa_convs(name, max_disp):
        for h, w in ((96, 192), (24, 48)):
            plan = deform.backward_weight_plan_bf16(16, cin, cout, h // stride, w // stride, K, K,
                                                    stride, PAD, dil, groups, SMS)
            _check_plan(plan, 16, cin, cout, h // stride, w // stride, groups)


@pytest.mark.parametrize("shape", [(2, 24, 37, 53, 24, 2, 2), (2, 24, 37, 53, 24, 2, 1),
                                   (16, 64, 96, 192, 64, 1, 1), (3, 40, 23, 41, 17, 1, 2),
                                   (1, 130, 20, 30, 260, 1, 2)])
def test_plan_at_the_edge_cases(shape):
    """chip_smoke.py's cases beyond the path: an odd stride-2 shape with two
    groups and with one, one group at the step's largest shape, odd
    channel counts (a group's last chunk short), several channel tiles."""
    b, cin, h, w, cout, stride, groups = shape
    plan = _plan(b, cin, cout, h, w, stride, groups)
    _check_plan(plan, b, cin, cout, _out(h, stride), _out(w, stride), groups)


def test_plan_depends_on_the_card():
    """The tiling depends on the conv, the splits on the SM count (one wave),
    capped only by a batch too small for them; the same shapes give the
    same plan without the cache."""
    plans = [_plan(*x, cout, stride=s) for x, cout, s in PATH_SHAPES]
    deform.backward_weight_plan_bf16.cache_clear()
    assert [_plan(*x, cout, stride=s) for x, cout, s in PATH_SHAPES] == plans
    layer3 = _plan(16, 128, 128, 24, 48)
    fewer = _plan(16, 128, 128, 24, 48, sms=16)
    assert fewer.splits < layer3.splits
    assert fewer._replace(splits=0, blocks=0, workspace=0) == layer3._replace(
        splits=0, blocks=0, workspace=0)
    assert _plan(1, 128, 128, 8, 16).splits == 1  # one tile: one split


def test_plan_raises_when_it_cannot_plan():
    with pytest.raises(ValueError, match="taps"):
        deform.backward_weight_plan_bf16(1, 16, 16, 32, 32, 5, 5, 1, 2, 1, GROUPS, SMS)
    with pytest.raises(ValueError, match="groups"):
        deform.backward_weight_plan_bf16(1, 15, 16, 32, 32, K, K, 1, PAD, DIL, GROUPS, SMS)
    with pytest.raises(ValueError, match="output channels"):
        deform.backward_weight_plan_bf16(1, 16, 0, 32, 32, K, K, 1, PAD, DIL, GROUPS, SMS)
    with pytest.raises(ValueError, match="shared memory"):  # a window of 5 x 5 taps 64 apart
        deform.backward_weight_plan_bf16(1, 64, 128, 32, 32, K, K, 4, 64, 64, GROUPS, SMS)


# ---------------------------------------------------------------------------
# The plan against the kernel source
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["MMA_WG_WARPS", "MMA_WG_CHUNK", "MMA_WG_STEP_H", "MMA_WG_RS",
                                  "MMA_WG_CS"])
def test_constants_are_the_kernels(name):
    """The plan's constants are the kernel's: a warp a tap, the chunk, the
    step's rows and the rows of its tiles; and the kernel is built for each
    channel tile and register budget the plan may name."""
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found == [str(getattr(deform, name))]
    builds = set(re.findall(r"AANET_WGRAD_MMA\((\d+), (\d+)\)", SOURCE))
    assert builds == {(str(c // 16), str(b)) for c, b in deform.MMA_WG_BUILDS.items()}


def test_the_bf16_entry_runs_the_tensor_core_kernel_only():
    """``aanet_deform_conv_backward_weight_bf16`` launches
    ``deform_wgrad_mma_kernel`` and the slab sum; the float32 kernel's
    template is launched for float32 values only."""
    entry = SOURCE[SOURCE.index('extern "C" int aanet_deform_conv_backward_weight_bf16('):]
    entry = entry[:entry.index("\n}\n")]
    assert "AANET_WGRAD_MMA(" in entry and "sum_slabs(ws, grad_w, splits, n, s)" in entry
    assert "launch_wgrad" not in entry.replace("launch_wgrad_mma", "")
    assert SOURCE.count("return launch_wgrad(") == 1  # the float32 entry's
    assert "aanet_deform_conv_backward_weight_bf16" not in SOURCE[:SOURCE.index("Kernel C")]


@pytest.mark.parametrize("padding", [0, 1, 2, 5])
def test_shared_memory_is_the_kernels(padding):
    """The plan's shared memory is the kernel's layout, from the source's
    own expression (``wgrad_mma_smem_bytes``) and the raw window's
    geometry (``raw_row``, ``raw_channel`` with unit 8)."""
    body = re.search(r"inline long long wgrad_mma_smem_bytes\((.*?)\) \{(.*?)\n\}", SOURCE, re.S)
    expr = " ".join(body.group(2).split())
    assert expr == (
        "return 4LL * MMA_WG_WARPS * 2 * MMA_WG_CHUNK * MMA_WG_CS + 2LL * 2 * co_tile * MMA_WG_RS + "
        "2LL * 2 * MMA_WG_CHUNK * xcs + 2LL * 16 * win_h * win_wa + "
        "2LL * MMA_WG_WARPS * MMA_WG_STEP_H * TILE_W * (2 * 4 + 2);")
    assert "const int xcs = raw_channel(win_h, win_wa, 8);" in SOURCE
    for stride in (1, 2):
        win_w = (deform.TILE_W - 1) * stride + 2 * DIL + 2 * deform.HALO + 2
        for tile_h in deform.MMA_WG_TILE_H:
            win_h = (tile_h - 1) * stride + 2 * DIL + 2 * deform.HALO + 2
            _, win_wa, xcs = deform._raw_geometry(win_h, win_w, padding, 8)
            for co_tile in deform.MMA_WG_BUILDS:
                want = (4 * 9 * 2 * 8 * 72 + 2 * 2 * co_tile * 72 + 2 * 2 * 8 * xcs
                        + 2 * 16 * win_h * win_wa + 2 * 9 * 4 * 16 * (2 * 4 + 2))
                assert deform._wgrad_mma_smem(co_tile, win_h, win_w, padding) == want


# ---------------------------------------------------------------------------
# Replays of the kernel's shared-memory work
# ---------------------------------------------------------------------------


def _bf16_values(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("stride,padding,height,width", [(1, 2, 9, 20), (2, 2, 13, 37), (1, 0, 30, 24)])
def test_channel_minor_window_replay(stride, padding, height, width):
    """``stage_raw_window`` (channel-major raw rows of whole 16-byte pieces
    from column win_x - xoff, zero outside the image and past the chunk's
    channels), the block's channel-minor copy (position e holds sr[c * xcs +
    e] of the 8 channels, channel c at bits 16 (c % 2) of word c // 2) and
    the sampler's corner at (ry, rx), position ry * win_wa + rx + xoff,
    read x[c, win_y + ry, win_x + rx]."""
    rng = np.random.RandomState(stride + height)
    nc = 6  # channels that exist in the chunk; the last two are past its end
    x = _bf16_values(rng, nc, height, width).view(torch.int16).numpy().astype(np.uint16)
    tile_h, cc = 8, deform.MMA_WG_CHUNK
    win_h = (tile_h - 1) * stride + 2 * DIL + 2 * deform.HALO + 2
    win_w = (deform.TILE_W - 1) * stride + 2 * DIL + 2 * deform.HALO + 2
    xoff, win_wa, xcs = deform._raw_geometry(win_h, win_w, padding, 8)
    for ho0, wo0 in ((0, 0), (tile_h, deform.TILE_W)):
        win_y = ho0 * stride - padding - deform.HALO
        win_x = wo0 * stride - padding - deform.HALO
        assert (win_x - xoff) % 8 == 0  # whole 16-byte pieces of x's rows
        raw = np.zeros(cc * xcs, np.uint16)
        for cl in range(cc):
            for r in range(win_h):
                for col in range(win_wa):
                    yy, xx = win_y + r, win_x - xoff + col
                    if cl < nc and 0 <= yy < height and 0 <= xx < width:
                        raw[cl * xcs + r * win_wa + col] = x[cl, yy, xx]
        words = np.zeros((win_h * win_wa, 4), np.uint32)
        for e in range(win_h * win_wa):
            v = raw[np.arange(cc) * xcs + e].astype(np.uint32)
            words[e] = v[0::2] | (v[1::2] << 16)
        for ry in range(win_h - 1):
            for rx in range(win_w - 1):
                q = words[ry * win_wa + rx + xoff]
                for c in range(cc):
                    w = int(q[c // 2])
                    bits = (w & 0xFFFF0000) if c % 2 else (w << 16) & 0xFFFFFFFF
                    yy, xx = win_y + ry, win_x + rx
                    want = x[c, yy, xx] if c < nc and 0 <= yy < height and 0 <= xx < width else 0
                    assert bits == int(want) << 16


def test_column_stores_cover_the_tile_once():
    """A warp's lanes store its column tile [8 channels][MMA_WG_CS]: lane
    (pr, pc) = (lane >> 3, 2 (lane & 7)), pixel pc + e of row pr at 16 pr +
    pc + e, each channel's row: every pixel of the step once, in the first
    64 floats of a row, and the fragments' reads (channel g, pixels 16 ks +
    2 t (+ 1) and + 8) take each once; rows 8 words past a multiple of 32
    put a half-warp's 64-bit reads in distinct banks."""
    stores = np.zeros((deform.MMA_WG_CHUNK, deform.MMA_WG_CS), int)
    for lane in range(32):
        pr, pc = lane >> 3, 2 * (lane & 7)
        for e in range(2):
            stores[:, 16 * pr + pc + e] += 1
    assert (stores[:, :P] == 1).all() and not stores[:, P:].any()
    reads = np.zeros((deform.MMA_WG_CHUNK, P), int)
    for ks in range(deform.MMA_WG_STEP_H):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for base in (16 * ks + 2 * t, 16 * ks + 8 + 2 * t):
                reads[g, base:base + 2] += 1
        half = [((lane >> 2) * deform.MMA_WG_CS + 2 * (lane & 3)) % 32 for lane in range(16)]
        assert len({b // 2 for b in half}) == 16  # 16 lanes, 16 distinct 8-byte bank pairs
    assert (reads == 1).all()


def _slab_sum(slabs):
    """``sum_slabs``' fixed order: rows of a sum block (the fewest powers of
    two up to 32 and the slab count, while n * rows < 2^18); row y adds slabs
    y, y + rows, ... in float32, then row 0 adds the rows' sums in order."""
    count, n = slabs.shape
    rows = 1
    while rows < 32 and rows < count and n * rows < (1 << 18):
        rows *= 2
    part = np.zeros((rows, n), np.float32)
    for y in range(rows):
        for i in range(y, count, rows):
            part[y] = part[y] + slabs[i]
    total = part[0].copy()
    for y in range(1, rows):
        total = total + part[y]
    return total


def _block_replay(gout, col, cout, taps):
    """One block of ``deform_wgrad_mma_kernel`` over gout [cout, pixels] (bf16
    values) and the sampled column [taps, 8 channels, pixels] (float32), in
    steps of 64 pixels: the staged gout tile [co_tile][MMA_WG_RS], each
    warp's column tile, A by ldmatrix.x4, B built from the column split into
    three planes, mma.sync per plane; returns the epilogue's sums [cout, 8,
    taps] (float64)."""
    rs, cs, cc = deform.MMA_WG_RS, deform.MMA_WG_CS, deform.MMA_WG_CHUNK
    co_tile = next(c for c in sorted(deform.MMA_WG_BUILDS) if c >= cout)
    mt = co_tile // 16
    lane = np.arange(32)
    arow = ((lane & 7) + 8 * ((lane >> 3) & 1)) * rs + 8 * (lane >> 4)
    g8, t4 = lane >> 2, lane & 3
    acc = np.zeros((taps, mt, 3, 32, 4))
    for s in range(gout.shape[1] // P):
        tile = np.zeros(co_tile * rs)
        for co in range(cout):
            tile[co * rs: co * rs + P] = gout[co, s * P:(s + 1) * P]
        for w in range(taps):
            colw = np.zeros(cc * cs, np.float32)
            for c in range(cc):
                colw[c * cs: c * cs + P] = col[w, c, s * P:(s + 1) * P]
            for ks in range(deform.MMA_WG_STEP_H):
                lo = np.stack([colw[g8 * cs + 16 * ks + 2 * t4 + e] for e in (0, 1)], 1)
                hi = np.stack([colw[g8 * cs + 16 * ks + 8 + 2 * t4 + e] for e in (0, 1)], 1)
                planes = [deform.split_planes(torch.from_numpy(v)) for v in (lo, hi)]
                for i in range(mt):
                    a = _ldmatrix(tile, arow + 16 * i * rs + 16 * ks, 4)
                    for pl in range(3):
                        b = np.stack([planes[0][pl].double().numpy(),
                                      planes[1][pl].double().numpy()], 1)
                        _mma(acc[w, i, pl], a, b)
    out = np.zeros((cout, cc, taps))
    for w in range(taps):
        for i in range(mt):
            for rr in range(2):
                for e in range(2):
                    co, c, j = 16 * i + g8 + 8 * rr, 2 * t4 + e, 2 * rr + e
                    v = (acc[w, i, 2, :, j] * 2.0**-8 + acc[w, i, 1, :, j]) * 2.0**-8 + acc[w, i, 0, :, j]
                    keep = co < cout
                    out[co[keep], c[keep], w] = v[keep]
    return out


@pytest.mark.parametrize("cout,taps,steps", [(24, 9, 2), (16, 4, 3), (40, 9, 1), (5, 2, 2)])
def test_contraction_replay(cout, taps, steps):
    """One block's products, lane by lane: equal to sum_p gout . col in
    float64 (bf16 x bf16 products of exact planes, float64 sums); the
    column's values over the whole float32 exponent range its samples
    take."""
    rng = np.random.RandomState(cout * taps)
    pixels = steps * P
    gout = _bf16_values(rng, cout, pixels).double().numpy()
    col = (rng.standard_normal((taps, deform.MMA_WG_CHUNK, pixels))
           * np.exp2(rng.randint(-12, 12, (taps, deform.MMA_WG_CHUNK, pixels)))).astype(np.float32)
    got = _block_replay(gout, col, cout, taps)
    want = np.einsum("op,kcp->ock", gout, col.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_split_k_replay():
    """The splits' blocks, each over its run of pixels, store float32 slabs
    that the slab sum adds in its fixed order: the same bits from any two
    runs, and within the float32 sums' rounding of the float64 product."""
    rng = np.random.RandomState(7)
    cout, taps, splits, steps = 16, 9, 3, 2
    gout = _bf16_values(rng, cout, splits * steps * P).double().numpy()
    col = rng.standard_normal((taps, deform.MMA_WG_CHUNK, splits * steps * P)).astype(np.float32)
    run = steps * P
    slabs = np.stack([_block_replay(gout[:, s * run:(s + 1) * run], col[..., s * run:(s + 1) * run],
                                    cout, taps).astype(np.float32).ravel() for s in range(splits)])
    total = _slab_sum(slabs)
    assert np.array_equal(total, _slab_sum(slabs.copy()))
    want = np.einsum("op,kcp->ock", gout, col.astype(np.float64)).ravel()
    scale = np.einsum("op,kcp->ock", np.abs(gout), np.abs(col).astype(np.float64)).ravel()
    assert (np.abs(total - want) <= (splits + 1) * 2.0**-24 * scale).all()
