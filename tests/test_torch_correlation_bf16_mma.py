"""The bf16 correlation forward on the tensor cores
(``aanet_torch/csrc/correlation.cu``: ``corr_fwd_mma_kernel``), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain twin there). Here: its plan (``ops.cost_volume.forward_plan_bf16``) at
every correlation of the paths and at the shapes beyond them, within a
block's and an SM's shared memory and the launch bounds, covering every
column, disparity and channel once; the plan's constants, builds and
shared-memory formula against the kernel source; and a numpy replay of the
kernel: the raw staging of each chunk's left tile and right window (zeros
outside the image and beyond C), each warp's contraction lane by lane with
``ldmatrix.trans`` and ``mma.sync.m16n8k16`` as PTX lays out their fragments
(``_ldmatrix`` and ``_mma`` of ``test_torch_deform_bf16_mma.py``), and the
epilogue's band map (m, n) -> (d, w), against the banded product in float64
with its zeros at w < d.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from aanet_torch._build import SM_SMEM_BYTES, SMEM_BYTES
from aanet_torch.ops import cost_volume as cv
from test_torch_deform_bf16_mma import _ldmatrix, _mma

SMS = 132  # an H100 SXM's SMs
SOURCE = (pathlib.Path(cv.__file__).parents[1] / "csrc" / "correlation.cu").read_text()
SHAPES = chip_smoke.CORR_PATH_SHAPES + chip_smoke.CORR_EDGE_SHAPES
# beyond the paths: n-tiles split over warps (D > 113), 8-byte quads, odd widths
WIDE_D = [((2, 32, 6, 64), 113), ((2, 32, 6, 96), 130), ((2, 48, 7, 100), 200),
          ((1, 16, 5, 40), 64)]


def _registers(max_threads, min_blocks):
    return 65536 // (max_threads * min_blocks)


def _warps(plan, max_disp):
    """Each warp's (first column of its 16 in the tile, its first n-tile,
    its n-tiles), as the kernel derives them from its index."""
    nt = -(-(max_disp + 15) // 8)
    nx = plan.tile_w // cv.MMA_CW
    out = []
    for warp in range(plan.threads // 32):
        j0 = plan.ntg * (warp // nx)
        out.append((cv.MMA_CW * (warp % nx), j0, min(plan.ntg, nt - j0)))
    return out


@pytest.mark.parametrize("shape,max_disp", SHAPES + WIDE_D)
def test_forward_plan_bf16_fits_and_covers(shape, max_disp):
    """The plan fits a block's and an SM's shared memory and the launch
    bounds' registers; its tiles cover every column once, each warp's
    n-tiles every disparity of its 16 columns once (the band 0 <= d < D
    inside its window slots), and its chunks every channel once."""
    b, c, h, w = shape
    plan = cv.forward_plan_bf16(b, c, h, w, max_disp, SMS)
    nt, ny, ntg = cv.mma_tiles(max_disp)
    assert (plan.ntg, plan.ny) == (ntg, ny) and plan.ntg in cv.MMA_NTGS
    assert (ny - 1) * ntg < nt <= ny * ntg
    assert plan.tile_w % cv.MMA_CW == 0 and plan.chunk % cv.MMA_K == 0
    assert plan.threads == 32 * plan.tile_w // cv.MMA_CW * ny <= cv.MMA_MAX_THREADS
    assert plan.threads * _registers(cv.MMA_MAX_THREADS, cv.MMA_MIN_BLOCKS) <= 65536
    assert plan.smem_bytes == cv._fwd_mma_smem(plan.tile_w, max_disp, plan.chunk)
    assert plan.smem_bytes <= SMEM_BYTES and plan.smem_bytes + 1024 <= SM_SMEM_BYTES
    assert plan.blocks == b * h * -(-w // plan.tile_w)
    tiles = -(-w // plan.tile_w)
    assert (tiles - 1) * plan.tile_w < w <= tiles * plan.tile_w
    chunks = -(-c // plan.chunk)
    assert (chunks - 1) * plan.chunk < c <= chunks * plan.chunk
    dtot = 8 * -(-max_disp // 8)
    covered = np.zeros((max_disp, plan.tile_w), int)
    for wl, j0, ntw in _warps(plan, max_disp):
        assert ntw >= 1
        s0 = wl + dtot + cv.MMA_CW - 8 * nt
        assert 0 <= s0 + 8 * j0 and s0 + 8 * (j0 + ntw) <= plan.tile_w + dtot
        m, s = np.meshgrid(np.arange(16), s0 + 8 * j0 + np.arange(8 * ntw), indexing="ij")
        d = wl + m + dtot - s
        ok = (d >= 0) & (d < max_disp)
        np.add.at(covered, (d[ok], (wl + m)[ok]), 1)
    assert (covered == 1).all()


def test_forward_plan_bf16_picks():
    """At the aanet step's largest volume: tiles of 64 columns (the row in
    three), chunks of 32 channels, one warp a 16-column group with the
    10-tile build (D = 64); a row of up to 96 columns is one tile; a grid
    short of the card stages 64 channels at a time where C allows it, 16
    where C is 32; the plans are the same without the cache; D beyond
    every build's reach raises."""
    plan = cv.forward_plan_bf16(16, 128, 96, 192, 64, SMS)
    assert (plan.tile_w, plan.chunk, plan.ntg, plan.ny, plan.threads) == (64, 32, 10, 1, 128)
    assert cv.forward_plan_bf16(16, 128, 48, 96, 32, SMS).tile_w == 96
    assert cv.forward_plan_bf16(1, 128, 32, 104, 16, SMS)[:2] == (64, 64)
    assert cv.forward_plan_bf16(1, 32, 128, 416, 64, SMS)[:2] == (64, 16)
    assert cv.forward_plan_bf16(1, 64, 64, 208, 32, SMS)[:2] == (64, 32)
    first = [cv.forward_plan_bf16(*s, d, SMS) for s, d in SHAPES]
    cv.forward_plan_bf16.cache_clear()
    assert [cv.forward_plan_bf16(*s, d, SMS) for s, d in SHAPES] == first
    with pytest.raises(ValueError, match="no bf16 forward tiling"):
        cv.forward_plan_bf16(1, 32, 8, 64, 2000, SMS)
    for (b, c, h, w), d in SHAPES:
        for p in cv.forward_plans_bf16(b, c, h, w, d):
            assert p.threads <= cv.MMA_MAX_THREADS and p.smem_bytes <= SMEM_BYTES


@pytest.mark.parametrize("name", ["MMA_CW", "MMA_K", "MMA_MAX_THREADS", "MMA_MIN_BLOCKS"])
def test_bf16_constants_are_the_kernels(name):
    """The plan's constants are the kernel's, its launch bounds among them;
    the kernel is built for each n-tile count the plans name, and its
    entry point launches no float32 kernel."""
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found == [str(getattr(cv, name))]
    assert "__launch_bounds__(MMA_MAX_THREADS, MMA_MIN_BLOCKS)\ncorr_fwd_mma_kernel" in SOURCE
    assert set(re.findall(r"corr_fwd_mma_kernel<(\d+)>", SOURCE)) == {str(n) for n in cv.MMA_NTGS}
    assert f"constexpr int MMA_NTG_MAX = {cv.MMA_NTGS[-1]};" in SOURCE
    entry = SOURCE[SOURCE.index('extern "C" int aanet_correlation_bf16'):]
    entry = entry[:entry.index("\n}\n")]
    assert "launch_corr_fwd_mma(" in entry and "launch_corr_fwd(" not in entry


@pytest.mark.parametrize("tile_w,max_disp,chunk", [(96, 64, 32), (112, 64, 32), (32, 1, 16),
                                                   (128, 96, 16), (32, 200, 64), (48, 24, 32)])
def test_bf16_shared_memory_is_the_kernels(tile_w, max_disp, chunk):
    """The plan's shared memory is the kernel's layout, the source's own
    expressions (``mma_row``, ``fwd_mma_smem_bytes``): rows of an odd
    number of 16-byte pieces (8 channels an ldmatrix reads in 8 different
    bank groups), two buffers of a chunk, the band reusing them."""
    assert "if (pieces % 2 == 0) ++pieces;\n  return 8 * pieces;" in SOURCE
    assert ("const int stage = 2 * chunk * (mma_row(tw) + mma_row(tw + dtot));\n"
            "  const int band = max_disp * mma_row(tw);\n"
            "  return 2 * (stage > band ? stage : band);") in SOURCE
    for n in (tile_w, tile_w + 8 * -(-max_disp // 8)):
        row = cv._mma_row(n)
        assert row >= n and row % 8 == 0 and (row // 8) % 2 == 1 and row - n < 16
        assert len({(r * row * 2 // 16) % 8 for r in range(8)}) == 8
    dtot = 8 * -(-max_disp // 8)
    stage = 2 * chunk * (cv._mma_row(tile_w) + cv._mma_row(tile_w + dtot))
    assert cv._fwd_mma_smem(tile_w, max_disp, chunk) == 2 * max(stage, max_disp * cv._mma_row(tile_w))


# ---------------------------------------------------------------------------
# The kernel, replayed
# ---------------------------------------------------------------------------


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen).to(torch.bfloat16).double().numpy()


def _piece(width):
    """Values a copy, as the launch picks them for aligned tensors."""
    return 8 if width % 8 == 0 else 4 if width % 4 == 0 else 2 if width % 2 == 0 else 1


def _stage(smem, lrow, rrow, channels, width, n, plan, ls, rs, dtot, w0, piece):
    """The kernel's ``stage(n)``: chunk n's left tile and right window into
    buffer n % 2, `piece` values a copy, zero outside the image and beyond
    the channels. Returns the (channel, first column) of every copy."""
    stage_elems = plan.chunk * (ls + rs)
    base = (n & 1) * stage_elems
    c0 = n * plan.chunk
    copies = []
    for off, stride, row, first, cols in ((base, ls, lrow, w0, plan.tile_w),
                                          (base + plan.chunk * ls, rs, rrow, w0 - dtot,
                                           plan.tile_w + dtot)):
        for cc in range(plan.chunk):
            for q in range(cols // piece):
                w = first + piece * q
                inside = c0 + cc < channels and 0 <= w < width
                assert inside or not (c0 + cc < channels and 0 <= w + piece - 1 < width)
                dst = off + cc * stride + piece * q
                smem[dst: dst + piece] = row[c0 + cc, w: w + piece] if inside else 0.0
                copies.append((c0 + cc, w, inside))
    return copies


def _replay(left, right, max_disp, plan):
    """The kernel's output [D, H, W] for one batch element, in float64
    (before the rounding to bf16), and how often each output is written."""
    c, h, w = left.shape
    dtot = 8 * -(-max_disp // 8)
    nt = -(-(max_disp + 15) // 8)
    ls, rs = cv._mma_row(plan.tile_w), cv._mma_row(plan.tile_w + dtot)
    piece = _piece(w)
    out = np.full((max_disp, h, w), np.nan)
    writes = np.zeros((max_disp, h, w), int)
    lane = np.arange(32)
    lr, li = lane & 7, lane >> 3
    g, t = lane >> 2, lane & 3
    nchunks = -(-c // plan.chunk)
    for row in range(h):
        for w0 in range(0, w, plan.tile_w):
            smem = np.full(plan.smem_bytes // 2, np.nan)
            accs = {}
            stage = lambda n: _stage(smem, left[:, row], right[:, row], c, w, n, plan, ls, rs,  # noqa: E731
                                     dtot, w0, piece)
            if nchunks:
                stage(0)
            for n in range(nchunks):
                if n + 1 < nchunks:  # into the other buffer, before chunk n is contracted
                    stage(n + 1)
                for wl, j0, ntw in _warps(plan, max_disp):
                    s0 = wl + dtot + cv.MMA_CW - 8 * nt
                    acc = accs.setdefault(wl * 1000 + j0, np.zeros((plan.ntg, 32, 4)))
                    a_off = ((li >> 1) * 8 + lr) * ls + wl + 8 * (li & 1)
                    b_off = ((li & 1) * 8 + lr) * rs + s0 + 8 * j0 + 8 * (li >> 1)
                    sa = (n & 1) * plan.chunk * (ls + rs) + a_off
                    sb = (n & 1) * plan.chunk * (ls + rs) + plan.chunk * ls + b_off
                    for k in range(0, plan.chunk, cv.MMA_K):
                        a = _ldmatrix(smem, sa + k * ls, 4, trans=True)
                        for j in range(0, plan.ntg, 2):
                            if j + 1 < ntw:
                                bq = _ldmatrix(smem, sb + k * rs + 8 * j, 4, trans=True)
                                _mma(acc[j], a, bq[:, 0:2])
                                _mma(acc[j + 1], a, bq[:, 2:4])
                            elif j < ntw:
                                _mma(acc[j], a, _ldmatrix(smem, sb + k * rs + 8 * j, 2, trans=True))
            # the epilogue's band: lane (g, t) of n-tile j, register r
            for wl, j0, ntw in _warps(plan, max_disp):
                s0 = wl + dtot + cv.MMA_CW - 8 * nt
                acc = accs.get(wl * 1000 + j0, np.zeros((plan.ntg, 32, 4)))
                for j in range(ntw):
                    for r in range(4):
                        m = g + 8 * (r >> 1)
                        d = wl + m + dtot - (s0 + 8 * (j0 + j) + 2 * t + (r & 1))
                        col = w0 + wl + m
                        ok = (d >= 0) & (d < max_disp) & (col < w)
                        out[d[ok], row, col[ok]] = acc[j, ok, r] / c
                        np.add.at(writes, (d[ok], row, col[ok]), 1)
    return out, writes


def _reference(left, right, max_disp):
    """The banded product in float64: (1/C) sum_c L[c, w] R[c, w - d], and
    0 where w < d."""
    c, h, w = left.shape
    ref = np.zeros((max_disp, h, w))
    for d in range(min(max_disp, w)):
        ref[d, :, d:] = (left[:, :, d:] * right[:, :, : w - d]).sum(0) / c
    return ref


@pytest.mark.parametrize("shape,max_disp,tile_w,chunk", [
    ((37, 2, 64), 40, 32, 16),    # C off the chunks, n-tiles odd (7), 16-byte copies
    ((70, 1, 64), 24, 32, 16),    # five chunks through the two buffers
    ((16, 1, 53), 24, 48, 16),    # W off the quads: a value a copy; a ragged last tile
    ((20, 2, 36), 12, 32, 32),    # 8-byte quads, one chunk
    ((24, 1, 78), 12, 80, 16),    # 4-byte pairs (psmnet-aa's W = 78)
    ((16, 1, 24), 64, 32, 16),    # W < D: every column beyond the image
    ((8, 1, 40), 1, 32, 16),      # D = 1
    ((16, 1, 96), 130, 32, 16),   # n-tiles split over two warps of a column group
])
def test_contraction_replay(shape, max_disp, tile_w, chunk):
    """The kernel's staging, contraction and band, lane by lane, at tilings
    the plans list: every (d, w) written once, equal to the banded product
    in float64 (the products of bf16 values and their sums are exact here),
    the zeros at w < d exactly zero."""
    gen = torch.Generator().manual_seed(max_disp + tile_w)
    c, h, w = shape
    left, right = _bf16(gen, c, h, w), _bf16(gen, c, h, w)
    plans = [p for p in cv.forward_plans_bf16(1, c, h, w, max_disp)
             if (p.tile_w, p.chunk) == (tile_w, chunk)]
    assert len(plans) == 1
    out, writes = _replay(left, right, max_disp, plans[0])
    assert (writes == 1).all()
    ref = _reference(left, right, max_disp)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    for d in range(max_disp):
        assert not out[d, :, : min(d, w)].any()


def test_replay_matches_the_twin():
    """The replay rounded to bf16 once is the plain bf16 twin within one
    bf16 ulp of the output's scale (the twin sums in float32, in another
    order), as chip_smoke.py holds the kernel."""
    gen = torch.Generator().manual_seed(7)
    c, h, w, max_disp = 48, 2, 64, 24
    left, right = _bf16(gen, c, h, w), _bf16(gen, c, h, w)
    plan = cv.forward_plan_bf16(1, c, h, w, max_disp, SMS)
    out, _ = _replay(left, right, max_disp, plan)
    got = torch.from_numpy(out).float().to(torch.bfloat16)
    lt = torch.from_numpy(left).unsqueeze(0).to(torch.bfloat16)
    rt = torch.from_numpy(right).unsqueeze(0).to(torch.bfloat16)
    want = cv.correlation_cost_volume_plain(lt, rt, max_disp)[0]
    assert float((got.float() - want.float()).abs().max()) <= chip_smoke.bf16_ulp(want)


@pytest.mark.parametrize("width,tile_w,max_disp", [(192, 96, 64), (416, 112, 64), (156, 64, 24),
                                                   (36, 48, 12), (53, 32, 32), (78, 80, 12)])
def test_staging_copies_whole_pieces(width, tile_w, max_disp):
    """Every copy of the staging is of a piece wholly inside the row or
    wholly outside it, from a source aligned to its size (16 bytes where W
    is a multiple of 8, 8 where it is a multiple of 4, 4 where it is even),
    and the window is
    columns w0 - dtot .. w0 + tile_w - 1."""
    piece = _piece(width)
    dtot = 8 * -(-max_disp // 8)
    plan = next(p for p in cv.forward_plans_bf16(1, 16, 1, width, max_disp)
                if p.tile_w == tile_w and p.chunk == 16)
    ls, rs = cv._mma_row(tile_w), cv._mma_row(tile_w + dtot)
    row = np.arange(16 * width, dtype=float).reshape(16, width) + 1
    for w0 in range(0, width, tile_w):
        smem = np.full(plan.smem_bytes // 2, np.nan)
        copies = _stage(smem, row, row, 16, width, 0, plan, ls, rs, dtot, w0, piece)
        firsts = sorted({w for _, w, _ in copies})
        assert firsts[0] == w0 - dtot and firsts[-1] + piece - 1 == w0 + tile_w - 1
        for _, w, inside in copies:
            if inside:
                assert (2 * w) % (2 * piece) == 0
        window = smem[16 * ls: 16 * ls + rs][: tile_w + dtot]
        cols = np.arange(w0 - dtot, w0 + tile_w)
        want = np.where((cols >= 0) & (cols < width), np.clip(cols, 0, width - 1) + 1, 0)
        np.testing.assert_array_equal(window, want)
