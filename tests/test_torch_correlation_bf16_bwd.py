"""The bf16 correlation backward on the tensor cores
(``aanet_torch/csrc/correlation.cu``: ``corr_bwd_mma_kernel``), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain twin there). Here: its plan (``ops.cost_volume.backward_plan_bf16``)
at every correlation of the paths and at the shapes beyond them, within a
block's and an SM's shared memory and the launch bounds, covering every
(channel, column) of dL and of dR once and every disparity of the band
inside each warp's k-steps; the plan's constants, builds and shared-memory
formula against the kernel source; the band's build, every entry of both
matrices written once; and a numpy replay of the kernel: the raw staging of
each chunk's windows (zeros outside the image and beyond C), the band, each
warp's contraction lane by lane with ``ldmatrix`` and ``mma.sync.m16n8k16``
as PTX lays out their fragments (``_ldmatrix`` and ``_mma`` of
``test_torch_deform_bf16_mma.py``), and the tiles written out, against the
two band transposes in float64.
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


def _registers(max_threads, min_blocks):
    return 65536 // (max_threads * min_blocks)


def _piece(width):
    """Values a copy, as the launch picks them for aligned tensors."""
    return 8 if width % 8 == 0 else 4 if width % 4 == 0 else 2 if width % 2 == 0 else 1


def _for_each_unit(rows, cols, threads):
    """``for_each_unit``'s (thread, row, col) units: t, t + threads, ... of a
    rows x cols grid in row-major order."""
    for t in range(threads):
        for unit in range(t, rows * cols, threads):
            yield t, unit // cols, unit % cols


def _band_entries(tile_w, max_disp):
    """The band's build, in the kernel's order: thread (q, j) of the 4
    tile_w threads stores column j's gradient at d = q, q + 4, ... < D, then
    ``for_each_unit`` zeroes the entries of d off the band (-15 <= d < 0, D
    <= d < 16 nk). Yields each store's (matrix, row, column, d, source
    column offset): GL row j at u = jj + dtot - d from column j, GR row j at
    u = jj + d from column j + d."""
    nk, dtot = cv.bwd_mma_steps(max_disp)
    span = 16 * nk
    for t in range(4 * tile_w):
        q, j = divmod(t, tile_w)
        for d in range(q, max_disp, 4):
            yield 0, j, j % 16 + dtot - d, d, j
            yield 1, j, j % 16 + d, d, j + d
    for _, r, j in _for_each_unit(span - max_disp + 15, tile_w, 4 * tile_w):
        d, jj = (r - 15 if r < 15 else max_disp + r - 15), j % 16
        if 0 <= jj + dtot - d < span:
            yield 0, j, jj + dtot - d, d, j
        if 0 <= jj + d < span:
            yield 1, j, jj + d, d, j + d


@pytest.mark.parametrize("shape,max_disp", SHAPES)
def test_backward_plan_bf16_fits_and_covers(shape, max_disp):
    """The plan fits a block's and an SM's shared memory and the launch
    bounds' registers; its tiles and chunks store every (channel, column)
    of dL and of dR once; each warp's k-steps hold every disparity of the
    band of each of its 16 columns, in window slots the staging fills."""
    b, c, h, w = shape
    plan = cv.backward_plan_bf16(b, c, h, w, max_disp, SMS)
    nk, dtot = cv.bwd_mma_steps(max_disp)
    assert (plan.nk, plan.dtot) == (nk, dtot) and dtot >= max_disp - 1 and dtot % 16 == 0
    assert plan.tile_w % cv.BMMA_CW == 0 and plan.chunk in cv.BMMA_CHUNKS
    assert plan.threads == 2 * 32 * plan.tile_w // cv.BMMA_CW <= cv.BMMA_MAX_THREADS
    assert plan.threads * _registers(cv.BMMA_MAX_THREADS, cv.BMMA_MIN_BLOCKS) <= 65536
    assert plan.smem_bytes == cv._bwd_mma_smem(plan.tile_w, max_disp, plan.chunk)
    assert plan.smem_bytes <= SMEM_BYTES and plan.smem_bytes + 1024 <= SM_SMEM_BYTES
    assert plan.blocks == b * h * -(-w // plan.tile_w)
    # the copy-out: (side, channel, column) stores of every tile and chunk
    piece = _piece(w)
    stores = np.zeros((2, c, w), int)
    for w0 in range(0, w, plan.tile_w):
        for n in range(-(-c // plan.chunk)):
            for _, sc, q in _for_each_unit(2 * plan.chunk, plan.tile_w // piece, plan.threads):
                ch, col = n * plan.chunk + sc % plan.chunk, w0 + piece * q
                if ch < c and col < w:
                    assert col + piece <= w  # a piece lies wholly inside the row
                    stores[sc // plan.chunk, ch, col: col + piece] += 1
    assert (stores == 1).all()
    # the band of warp jw's columns j: dL takes R's slot j + dtot - d, dR L's
    # slot j + d, both inside the warp's k-steps [jw, jw + 16 nk) and the
    # staged row of tile_w + dtot slots
    for j in range(plan.tile_w):
        jw = j - j % 16
        for d in range(max_disp):
            for slot in (j + dtot - d, j + d):
                assert jw <= slot < jw + 16 * nk and slot < plan.tile_w + dtot


def test_backward_plan_bf16_picks():
    """At the aanet step's largest gradient: tiles of 32 columns, chunks of
    32 channels, 5 k-steps (D = 64); aanet+'s (C = 32) in chunks of 16; a
    row of 48 or 144 columns in tiles of 48; chunks of 64 where the grid is
    short of two blocks an SM, but of 16 where C <= 16; the plans are the
    same without the cache; D beyond every tiling's shared memory raises;
    the lists hold only tilings the kernel takes."""
    plan = cv.backward_plan_bf16(16, 128, 96, 192, 64, SMS)
    assert (plan.tile_w, plan.chunk, plan.nk, plan.dtot, plan.threads) == (32, 32, 5, 64, 128)
    assert cv.backward_plan_bf16(16, 32, 96, 192, 64, SMS)[:2] == (32, 16)
    assert cv.backward_plan_bf16(16, 128, 24, 48, 16, SMS)[:2] == (48, 32)
    assert cv.backward_plan_bf16(16, 32, 72, 144, 48, SMS)[:2] == (48, 16)
    assert cv.backward_plan_bf16(1, 128, 32, 104, 16, SMS)[:2] == (32, 64)
    assert cv.backward_plan_bf16(2, 3, 6, 64, 16, SMS).chunk == 16
    first = [cv.backward_plan_bf16(*s, d, SMS) for s, d in SHAPES]
    cv.backward_plan_bf16.cache_clear()
    assert [cv.backward_plan_bf16(*s, d, SMS) for s, d in SHAPES] == first
    assert cv.backward_plan_bf16(1, 32, 8, 64, 584, SMS).smem_bytes <= SMEM_BYTES
    with pytest.raises(ValueError, match="no bf16 tiling"):
        cv.backward_plan_bf16(1, 32, 8, 64, 1200, SMS)
    for (b, c, h, w), d in SHAPES:
        for p in cv.backward_plans_bf16(b, c, h, w, d):
            assert p.threads <= cv.BMMA_MAX_THREADS and p.smem_bytes <= SMEM_BYTES


@pytest.mark.parametrize("name", ["BMMA_CW", "BMMA_K", "BMMA_MAX_THREADS", "BMMA_MIN_BLOCKS"])
def test_bf16_backward_constants_are_the_kernels(name):
    """The plan's constants are the kernel's, its launch bounds among them;
    the kernel is built for each chunk the plans name; the bf16 entry point
    launches it and no float32 kernel, and the float32 backward has no bf16
    form left."""
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found == [str(getattr(cv, name))]
    assert "__launch_bounds__(BMMA_MAX_THREADS, BMMA_MIN_BLOCKS)\ncorr_bwd_mma_kernel" in SOURCE
    assert set(re.findall(r"corr_bwd_mma_kernel<(\d+)>", SOURCE)) == {str(n) for n in cv.BMMA_CHUNKS}
    assert "corr_bwd_mma_builds[chunk / 32]" in SOURCE and [n // 32 for n in cv.BMMA_CHUNKS] == [0, 1, 2]
    entry = SOURCE[SOURCE.index('extern "C" int aanet_correlation_backward_bf16'):]
    entry = entry[:entry.index("\n}\n")]
    assert "launch_corr_bwd_mma(" in entry and "launch_corr_bwd(" not in entry
    assert not re.search(r"corr_bwd_kernel<\w", SOURCE) and "stage_quad" not in SOURCE


@pytest.mark.parametrize("tile_w,max_disp,chunk", [(64, 64, 32), (48, 32, 32), (16, 1, 16),
                                                   (32, 96, 64), (48, 584, 16), (64, 17, 16)])
def test_bf16_backward_shared_memory_is_the_kernels(tile_w, max_disp, chunk):
    """The plan's shared memory and k-steps are the kernel's, the source's
    own expressions (``bwd_mma_steps``, ``bwd_mma_smem_bytes``): two buffers
    of a chunk's two windows, the two band matrices and the two output
    tiles, every row an odd number of 16-byte pieces (the 8 rows an
    ldmatrix reads in 8 different bank groups)."""
    assert "return (max_disp + 30) / BMMA_K;" in SOURCE
    assert ("return 2 * (2 * 2 * chunk * mma_row(tw + dtot) + 2 * tw * mma_row(BMMA_K * nk) +\n"
            "              2 * chunk * mma_row(tw));") in SOURCE
    nk, dtot = cv.bwd_mma_steps(max_disp)
    assert nk == (max_disp + 30) // 16 == -(-(max_disp + 15) // 16) and dtot == 16 * (nk - 1)
    for n in (tile_w + dtot, 16 * nk, tile_w):
        row = cv._mma_row(n)
        assert row >= n and (row // 8) % 2 == 1
        assert len({(r * row * 2 // 16) % 8 for r in range(8)}) == 8
    assert cv._bwd_mma_smem(tile_w, max_disp, chunk) == 2 * (
        4 * chunk * cv._mma_row(tile_w + dtot) + 2 * tile_w * cv._mma_row(16 * nk)
        + 2 * chunk * cv._mma_row(tile_w))


@pytest.mark.parametrize("tile_w,max_disp", [(64, 64), (48, 1), (16, 16), (32, 17), (48, 40),
                                             (16, 130)])
def test_band_build_writes_each_entry_once(tile_w, max_disp):
    """The band's two loops write every (row, column < 16 nk) of both
    matrices once, the values' stores all inside the span; an entry off the
    band (d < 0 or d >= D) is zero, one on it the gradient at the right
    disparity and column: GL row j holds g[jj + dtot - u][w0 + j], GR row j
    holds g[u - jj][w0 + j - jj + u]."""
    assert "for (int d0 = threadIdx.x / tw; d0 < max_disp; d0 += nq * BAND_BATCH) {" in SOURCE
    assert "for_each_unit(span - max_disp + 15, tw, [&](int r, int j) {" in SOURCE
    nk, dtot = cv.bwd_mma_steps(max_disp)
    span = 16 * nk
    written = np.zeros((2, tile_w, span), int)
    for side, j, u, d, col in _band_entries(tile_w, max_disp):
        assert 0 <= u < span
        written[side, j, u] += 1
        jj = j % 16
        assert d == (jj + dtot - u if side == 0 else u - jj)
        assert col == (j if side == 0 else j - jj + u)
    assert (written == 1).all()


# ---------------------------------------------------------------------------
# The kernel, replayed
# ---------------------------------------------------------------------------


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen).to(torch.bfloat16).double().numpy()


def _replay(grad, left, right, plan):
    """The kernel's dL and dR [C, H, W] for one batch element, in float64
    (before the rounding to bf16), and how often each output is written."""
    d_all, h, w = grad.shape
    c = left.shape[0]
    nk, dtot = cv.bwd_mma_steps(d_all)
    span, tw, chunk = 16 * nk, plan.tile_w, plan.chunk
    lw, lg, lo = cv._mma_row(tw + dtot), cv._mma_row(span), cv._mma_row(tw)
    stage_elems = 2 * chunk * lw
    band, s_out = 2 * stage_elems, 2 * stage_elems + 2 * tw * lg
    piece = _piece(w)
    out = np.full((2, c, h, w), np.nan)
    writes = np.zeros((2, c, h, w), int)
    lane = np.arange(32)
    lr, li = lane & 7, lane >> 3
    g, t = lane >> 2, lane & 3
    nchunks = -(-c // chunk)
    for row in range(h):
        for w0 in range(0, w, tw):
            smem = np.full(plan.smem_bytes // 2, np.nan)

            def stage(n):  # R window slot s: column w0 - dtot + s; L window slot s: w0 + s
                base = (n & 1) * stage_elems
                for off, feat, first in ((base, right, w0 - dtot), (base + chunk * lw, left, w0)):
                    for _, cc, q in _for_each_unit(chunk, (tw + dtot) // piece, plan.threads):
                        col = first + piece * q
                        inside = n * chunk + cc < c and 0 <= col < w
                        assert inside or not (n * chunk + cc < c and 0 <= col + piece - 1 < w)
                        dst = off + cc * lw + piece * q
                        smem[dst: dst + piece] = feat[n * chunk + cc, row, col: col + piece] if inside else 0.0

            for n in range(min(nchunks, 2)):  # chunks 0 and 1, while the band is built
                stage(n)
            for side, j, u, d, col in _band_entries(tw, d_all):
                inside = 0 <= d < d_all and w0 + col < w
                smem[band + (side * tw + j) * lg + u] = grad[d, row, w0 + col] if inside else 0.0
            for n in range(nchunks):
                for warp in range(plan.threads // 32):
                    side, jw = divmod(warp, tw // 16)
                    jw *= 16
                    sa = band + (side * tw + jw + lr + 8 * (li & 1)) * lg + 8 * (li >> 1)
                    sb = (n & 1) * stage_elems + (side * chunk + lr + 8 * (li >> 1)) * lw + jw + 8 * (li & 1)
                    acc = np.zeros((chunk // 8, 32, 4))
                    for k in range(nk):
                        a = _ldmatrix(smem, sa + 16 * k, 4)
                        for p in range(chunk // 16):
                            bq = _ldmatrix(smem, sb + 16 * p * lw + 16 * k, 4)
                            _mma(acc[2 * p], a, bq[:, 0:2])
                            _mma(acc[2 * p + 1], a, bq[:, 2:4])
                    so = s_out + side * chunk * lo + jw + g
                    for jt in range(chunk // 8):
                        for r in range(4):
                            smem[so + (8 * jt + 2 * t + (r & 1)) * lo + 8 * (r >> 1)] = acc[jt, :, r] / c
                if n + 2 < nchunks:  # into the buffer chunk n was read from
                    stage(n + 2)
                for _, sc, q in _for_each_unit(2 * chunk, tw // piece, plan.threads):
                    ch, j = n * chunk + sc % chunk, piece * q
                    if ch >= c or w0 + j >= w:
                        continue
                    side = sc // chunk
                    out[side, ch, row, w0 + j: w0 + j + piece] = smem[s_out + sc * lo + j: s_out + sc * lo + j + piece]
                    writes[side, ch, row, w0 + j: w0 + j + piece] += 1
    return out, writes


def _reference(grad, left, right):
    """The two band transposes in float64: dL[c, w] = (1/C) sum_d g[d, w]
    R[c, w - d] and dR[c, w'] = (1/C) sum_d g[d, w' + d] L[c, w' + d], over
    w >= d."""
    d_all, _, w = grad.shape
    c = left.shape[0]
    dl, dr = np.zeros_like(left), np.zeros_like(right)
    for d in range(min(d_all, w)):
        dl[..., d:] += grad[d, :, d:] * right[..., : w - d] / c
        dr[..., : w - d] += grad[d, :, d:] * left[..., d:] / c
    return dl, dr


@pytest.mark.parametrize("shape,max_disp,tile_w,chunk", [
    ((37, 1, 64), 40, 32, 16),    # C off the chunks, three chunks through the two buffers
    ((3, 2, 64), 16, 64, 16),     # C = 3: one chunk, mostly zero rows
    ((16, 1, 37), 24, 48, 16),    # W = 37: a value a copy, a ragged last tile
    ((16, 1, 24), 64, 32, 16),    # D > W: every window beyond the image
    ((32, 1, 40), 1, 16, 32),     # D = 1: one k-step, no columns past the tile
    ((24, 1, 53), 32, 64, 16),    # W = 53
    ((20, 1, 36), 12, 32, 32),    # 8-byte quads
    ((64, 1, 78), 12, 16, 64),    # 4-byte pairs (psmnet-aa's W = 78), the 64-channel build
])
def test_backward_contraction_replay(shape, max_disp, tile_w, chunk):
    """The kernel's staging, band, contraction and tiles, lane by lane, at
    tilings the plans list: every (channel, column) of dL and of dR written
    once, equal to the band transposes in float64 (the products of bf16
    values and their sums are exact here)."""
    gen = torch.Generator().manual_seed(max_disp + tile_w)
    c, h, w = shape
    grad, left, right = _bf16(gen, max_disp, h, w), _bf16(gen, c, h, w), _bf16(gen, c, h, w)
    plans = [p for p in cv.backward_plans_bf16(1, c, h, w, max_disp)
             if (p.tile_w, p.chunk) == (tile_w, chunk)]
    assert len(plans) == 1
    out, writes = _replay(grad, left, right, plans[0])
    assert (writes == 1).all()
    dl, dr = _reference(grad, left, right)
    np.testing.assert_allclose(out[0], dl, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out[1], dr, rtol=1e-12, atol=1e-12)


def test_backward_replay_matches_the_twin():
    """The replay rounded to bf16 once is the plain bf16 twin within one
    bf16 ulp of each gradient's scale (the twin sums in float32, in another
    order), as chip_smoke.py holds the kernel."""
    gen = torch.Generator().manual_seed(11)
    c, h, w, max_disp = 48, 2, 64, 24
    grad, left, right = _bf16(gen, max_disp, h, w), _bf16(gen, c, h, w), _bf16(gen, c, h, w)
    plan = cv.backward_plan_bf16(1, c, h, w, max_disp, SMS)
    out, _ = _replay(grad, left, right, plan)
    tensors = [torch.from_numpy(x).unsqueeze(0).to(torch.bfloat16) for x in (grad, left, right)]
    want = cv.correlation_cost_volume_backward_plain(*tensors)
    for got, ref in zip(out, want):
        got = torch.from_numpy(got).float().to(torch.bfloat16)
        assert float((got.float() - ref[0].float()).abs().max()) <= chip_smoke.bf16_ulp(ref)
