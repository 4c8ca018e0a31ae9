"""The cuts of the 4-D cost-volume kernels (``aanet_torch/csrc/volume4d.cu``:
the difference and concat volumes, forward and backward), on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against their
plain twins there). What surrounds them is Python: the wrappers pick each
kernel's cut per shape and SM count (``ops.cost_volume.volume_forward_plan``,
``volume_backward_plan``). Here the plans are checked for every volume that
``chip_smoke.py``'s paths run and for its shapes beyond them: they fit a
block's and an SM's shared memory and the launch bounds, and the kernels'
thread mappings, replayed in numpy step by step (the backward's staging of
each plane into its ring of shared memory, the register window of the
forward), write every output once, read every band value of the gradient
once, and give the plain twins' values bit for bit.
"""
import collections
import dataclasses
import pathlib
import re
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from aanet_torch._build import SM_SMEM_BYTES, SMEM_BYTES
from aanet_torch.ops import cost_volume as cv

SMS = 132  # an H100 SXM's SMs
PATHS = list(chip_smoke.VOL_PATHS.values())  # ((shape, D), concat)
EDGES = [(sig, concat) for sig in chip_smoke.VOL_EDGE_SHAPES for concat in (False, True)]
SOURCE = (pathlib.Path(cv.__file__).parents[1] / "csrc" / "volume4d.cu").read_text()
# the baselines' inputs on the paths: batch 1 at 384x1248, the train step's
# batch (VOL_PATHS) at 288x576; a small forward at SMALL_HW (PSMNet's
# pooling takes 256x256 at least), max_disp SMALL_DISP finds each volume's
# channels, scale and D per max_disp
SMALL_HW = {"psmnet": (256, 256), "psmnet_basic": (256, 256), "stereonet": (64, 128),
            "gcnet": (64, 128)}
SMALL_DISP, PATH_DISP = 32, 192
INPUTS = {"inference": (384, 1248), "step": (288, 576)}


class _Built(Exception):
    """Raised by the recorder once the volume is built: the aggregation
    after it is not needed."""


def _recorded_volumes(name):
    """The 4-D volumes of a CPU forward of chip_smoke's baseline ``name``
    at SMALL_HW and max_disp SMALL_DISP, up to its volume: {(C, D, h, w,
    concat): calls}."""
    seen = collections.Counter()

    def recorder(concat):
        def record(left, right, max_disp):
            seen[tuple(left.shape[1:2]) + (max_disp,) + tuple(left.shape[2:]) + (concat,)] += 1
            raise _Built
        return record

    torch.manual_seed(0)
    cfg = dataclasses.replace(chip_smoke.baseline_config(name), max_disp=SMALL_DISP)
    model = cfg.build().eval()
    hw = SMALL_HW[name]
    with mock.patch.object(cv, "difference_cost_volume", recorder(False)), \
            mock.patch.object(cv, "concat_cost_volume", recorder(True)), \
            torch.no_grad(), pytest.raises(_Built):
        model(torch.randn(1, 3, *hw), torch.randn(1, 3, *hw))
    return seen


@pytest.mark.parametrize("name", ["psmnet", "psmnet_basic", "stereonet", "gcnet"])
def test_path_shapes_are_the_models_volumes(name):
    """chip_smoke.py's paths hold every volume the baselines build: a small
    forward finds its channels, its scale of the input and its D per
    max_disp, and those at the paths' batches, sizes and max_disp are the
    listed ones."""
    seen = _recorded_volumes(name)
    assert sum(seen.values()) == 1
    (c, d, h, w, concat), = seen
    scale = SMALL_HW[name][0] // h
    assert SMALL_HW[name][1] // w == scale
    base = name.split("_")[0]
    for path, full in INPUTS.items():
        sig, listed_concat = chip_smoke.VOL_PATHS[f"{base} {path}"]
        batch = 1 if path == "inference" else sig[0][0]
        assert sig == ((batch, c, full[0] // scale, full[1] // scale), d * PATH_DISP // SMALL_DISP)
        assert listed_concat == concat


# ---------------------------------------------------------------------------
# numpy replays of the kernels' thread mappings


def _replay_forward(plan, left, right, d_total, concat):
    """``volume4d_fwd_kernel`` over L, R [B, C, H, W] (float32 numpy) with
    ``plan``: thread i takes quad i % nq of row i // nq and a run of
    ``plan.dchunk`` planes, keeps its L quad and a window of two R quads
    (one new quad every four planes). Returns the volume and how often each
    element was written."""
    b, c, h, w = left.shape
    nq = -(-w // 4)
    hw, vec = h * w, w % 4 == 0
    out_c = (2 if concat else 1) * c
    out = np.full(b * out_c * d_total * hw, np.nan, np.float32)
    writes = np.zeros(out.size, int)
    lf, rf = left.reshape(-1), right.reshape(-1)
    i = np.arange(b * c * h * nq)
    row, q = i // nq, i % nq
    col = 4 * q
    bc = row // h
    oc = bc + (bc // c) * c if concat else bc
    dst = oc * d_total * hw + (row % h) * w + col
    dst_r = dst + c * d_total * hw

    def load(j):  # quads j of each thread's row, zero outside [0, W)
        idx = 4 * j[:, None] + np.arange(4)
        ok = (idx >= 0) & (idx < w) & ((j[:, None] >= 0) if vec else True)
        return np.where(ok, rf[np.clip(row[:, None] * w + idx, 0, rf.size - 1)], np.float32(0))

    lidx = col[:, None] + np.arange(4)
    l = np.where(lidx < w, lf[np.clip(row[:, None] * w + lidx, 0, lf.size - 1)], np.float32(0))
    for d_beg in range(0, d_total, plan.dchunk):
        d_end = min(d_total, d_beg + plan.dchunk)
        cur, prev = load(q - d_beg // 4), load(q - d_beg // 4 - 1)
        for d0 in range(d_beg, d_end, 4):
            nxt = load(q - d0 // 4 - 2)
            for s in range(4):
                d = d0 + s
                if d >= d_end:
                    break
                win = np.concatenate([prev, cur], axis=1)
                r = win[:, 4 - s: 8 - s]
                inside = lidx >= d
                a = np.where(inside, l if concat else l - r, np.float32(0))
                rr = np.where(inside, r, np.float32(0))
                for e in range(4):
                    ok = col + e < w
                    out[dst[ok] + d * hw + e] = a[ok, e]
                    writes[dst[ok] + d * hw + e] += 1
                    if concat:
                        out[dst_r[ok] + d * hw + e] = rr[ok, e]
                        writes[dst_r[ok] + d * hw + e] += 1
            cur, prev = prev, nxt
    return out.reshape(b, out_c, d_total, h, w), writes


def _replay_backward(plan, grad, channels, concat):
    """``volume4d_bwd_kernel`` over grad [B, C', D, H, W] (float32 numpy)
    with ``plan``: per block, the staging of each chunk of planes into its
    stage of the ring (a stage is cleared to NaN before it is staged, so a
    value read that this chunk did not stage would show), then each
    thread's sums in ascending d, read from the stage as the kernel reads
    them. Returns dL, dR, how often each output was written and how often
    each grad element was read from device memory."""
    b, cg, d_total, h, w = grad.shape
    c = channels
    hw, vec = h * w, w % 4 == 0
    nrows, depth = b * c * h, min(d_total, w)
    rows, tile, chunk = plan.rows, plan.tile, cv.VOL_BWD_CHUNK
    tiles_x = -(-w // tile)
    whole = tiles_x == 1
    nq = tile // 4
    b_w = (tile if concat else 0) if whole else tile + 4
    a_words = chunk * rows * tile
    stage_words = a_words + chunk * rows * b_w
    assert 4 * 2 * stage_words == plan.smem_bytes
    g = grad.reshape(-1)
    reads = np.zeros(g.size, int)
    dl = np.full(nrows * w, np.nan, np.float32)
    dr = np.full(nrows * w, np.nan, np.float32)
    writes = np.zeros((2, nrows * w), int)
    t = np.arange(plan.threads)
    r, q = t // nq, t % nq
    for blk in range(-(-nrows // rows) * tiles_x):
        row = (blk // tiles_x) * rows + r
        w0 = (blk % tiles_x) * tile
        col = w0 + 4 * q
        act = (r < rows) & (row < nrows) & (col < w)
        ra, qa, wa, rowa = r[act], q[act], col[act], row[act]
        bc = rowa // h
        ga = (bc + (bc // c) * c if concat else bc) * d_total * hw + (rowa % h) * w
        gb = ga + c * d_total * hw if concat else ga
        smem = np.full(2 * stage_words, np.nan, np.float32)

        def copy(dst, src, first, d):
            for e in range(4):
                cc = first + e
                ok = ((first < w) & (first + 3 >= d)) if vec else ((cc >= d) & (cc < w))
                smem[dst[ok] + e] = g[src[ok] + cc[ok]]
                reads[src[ok] + cc[ok]] += 1

        def stage(k):
            base = (k & 1) * stage_words
            smem[base: base + stage_words] = np.nan
            for j in range(chunk):
                d = k * chunk + j
                if d >= depth:
                    break
                copy(base + (j * rows + ra) * tile + 4 * qa, ga + d * hw, wa, d)
                if b_w:
                    sb = base + a_words + (j * rows + ra) * b_w
                    b0 = 0 if whole else w0 + (d & ~3)
                    copy(sb + 4 * qa, gb + d * hw, b0 + 4 * qa, d)
                    if not whole:
                        m = qa == 0
                        copy(sb[m] + tile, (gb + d * hw)[m], np.full(m.sum(), b0 + tile), d)

        acc_l = np.zeros((len(ra), 4), np.float32)
        acc_r = np.zeros((len(ra), 4), np.float32)
        dr_stride = rows * b_w if b_w else rows * tile
        dr_base = (a_words + ra * b_w if b_w else ra * tile) + 4 * qa
        nchunks = -(-depth // chunk)
        if nchunks:
            stage(0)
        for k in range(nchunks):
            if k + 1 < nchunks:
                stage(k + 1)
            base = (k & 1) * stage_words
            for j in range(chunk):
                d = k * chunk + j
                s = d & 3
                if d >= depth:
                    break
                m = wa + 3 >= d
                a = smem[(base + ra * tile + 4 * qa + j * rows * tile)[m, None] + np.arange(4)]
                for e in range(4):
                    sel = wa[m] + e >= d
                    acc_l[np.flatnonzero(m)[sel], e] += a[sel, e]
                m = wa + d < w
                at = base + dr_base[m] + j * dr_stride + ((d & ~3) if whole else 0)
                v = smem[at[:, None] + np.arange(4)]
                hi = np.zeros_like(v)
                if s:
                    need = wa[m] + (d & ~3) + 4 < w
                    hi[need] = smem[at[need, None] + 4 + np.arange(4)]
                v = np.concatenate([v, hi], axis=1)[:, s: s + 4]
                for e in range(4):
                    sel = wa[m] + e + d < w
                    idx = np.flatnonzero(m)[sel]
                    if concat:
                        acc_r[idx, e] += v[sel, e]
                    else:
                        acc_r[idx, e] -= v[sel, e]
        for e in range(4):
            ok = wa + e < w
            for out, acc, n in ((dl, acc_l, 0), (dr, acc_r, 1)):
                out[rowa[ok] * w + wa[ok] + e] = acc[ok, e]
                writes[n, rowa[ok] * w + wa[ok] + e] += 1
    return dl.reshape(b, c, h, w), dr.reshape(b, c, h, w), writes, reads.reshape(grad.shape)


def _band(shape, d_total):
    """[B, C', D, H, W] booleans: the band w >= d (d < D)."""
    w = shape[-1]
    band = np.arange(w)[None, :] >= np.arange(d_total)[:, None]
    return np.broadcast_to(band[None, None, :, None, :], shape)


def _inputs(shape, d_total, concat, seed=0):
    rs = np.random.RandomState(seed)
    b, c, h, w = shape
    left, right = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    grad = rs.randn(b, (2 if concat else 1) * c, d_total, h, w).astype(np.float32)
    return left, right, grad


def _plain(concat):
    if concat:
        return cv.concat_cost_volume_plain, cv.concat_cost_volume_backward_plain
    return cv.difference_cost_volume_plain, cv.difference_cost_volume_backward_plain


def _reduced(shape, rows=1):
    """A volume of the shape's width with a few rows: two blocks of the
    backward's plan and part of a third."""
    b, c, h, w = shape
    return (1, 1, 2 * rows + 1, w)


# ---------------------------------------------------------------------------
# the forward


@pytest.mark.parametrize("sig,concat", PATHS + EDGES)
def test_forward_plan_fits_and_covers(sig, concat):
    (b, c, h, w), d = sig
    plan = cv.volume_forward_plan(b, c, h, w, d, SMS)
    assert plan in cv.volume_forward_plans(b, c, h, w, d)
    assert plan.dchunk % 4 == 0 and plan.dchunk >= 4
    quads = b * c * h * -(-w // 4)
    assert plan.blocks == -(-quads // cv.VOL_FWD_THREADS) * -(-d // plan.dchunk)
    assert -(-d // plan.dchunk) <= 65535
    # all of D a thread where the quads fill two waves of the SMs' threads
    assert (plan.dchunk >= d) == (quads >= 2 * SMS * cv.SM_THREADS) or plan.dchunk == 4
    # the mapping on a few rows of this width: every output written once,
    # equal to the twin bit for bit
    shape = (b, c, h, w) if b * c * h * w * d <= 2**16 else _reduced((b, c, h, w))
    left, right, _ = _inputs(shape, d, concat)
    got, writes = _replay_forward(plan, left, right, d, concat)
    assert (writes == 1).all()
    want = _plain(concat)[0](torch.from_numpy(left), torch.from_numpy(right), d).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dchunk", [4, 8, 12, 24])
@pytest.mark.parametrize("concat", [False, True])
def test_forward_runs_of_d_cover_d_once(dchunk, concat):
    """D split in runs (the plans' other cuts): the same values, each
    output written once, also where the last run is short."""
    left, right, _ = _inputs((2, 3, 2, 26), 22, concat)
    plan = cv.VolumeForwardPlan(dchunk, 0)
    got, writes = _replay_forward(plan, left, right, 22, concat)
    assert (writes == 1).all()
    want = _plain(concat)[0](torch.from_numpy(left), torch.from_numpy(right), 22).numpy()
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the backward


@pytest.mark.parametrize("sig,concat", PATHS + EDGES)
def test_backward_plan_fits(sig, concat):
    (b, c, h, w), d = sig
    plan = cv.volume_backward_plan(b, c, h, w, concat, SMS)
    assert plan in cv.volume_backward_plans(b, c, h, w, concat)
    whole = plan.tile >= w
    # the block: whole warps of the rows' quads, within the launch bounds;
    # several rows only where each is whole
    assert plan.threads == 32 * -(-plan.rows * plan.tile // 4 // 32)
    assert plan.threads <= cv.VOL_BWD_MAX_THREADS and plan.tile % 4 == 0
    assert plan.rows == 1 or whole
    assert plan.blocks == -(-b * c * h // plan.rows) * -(-w // plan.tile)
    # shared memory: two stages of the layout, within a block's and an SM's
    piece = (plan.tile if concat else 0) if whole else plan.tile + 4
    assert plan.smem_bytes == 8 * cv.VOL_BWD_CHUNK * plan.rows * (plan.tile + piece)
    assert plan.smem_bytes <= SMEM_BYTES and plan.smem_bytes + 1024 <= SM_SMEM_BYTES
    registers = 65536 // (cv.VOL_BWD_MAX_THREADS * cv.VOL_BWD_MIN_BLOCKS)
    assert plan.threads * registers <= 65536
    # at the path shapes: at least the warps the plan looks for
    if (sig, concat) in PATHS:
        resident = min(SM_SMEM_BYTES // (plan.smem_bytes + 1024), 2048 // plan.threads,
                       65536 // (registers * plan.threads))
        assert resident * plan.threads // 32 >= cv.VOL_BWD_WARPS


def _check_backward(plan, shape, d, concat):
    left, right, grad = _inputs(shape, d, concat)
    dl, dr, writes, reads = _replay_backward(plan, grad, shape[1], concat)
    assert (writes == 1).all()
    want_l, want_r = _plain(concat)[1](torch.from_numpy(grad), torch.from_numpy(left),
                                       torch.from_numpy(right))
    assert np.array_equal(dl, want_l.numpy()) and np.array_equal(dr, want_r.numpy())
    return reads, _band(grad.shape, d)


@pytest.mark.parametrize("sig,concat", PATHS + EDGES)
def test_backward_replay_reads_the_band_once(sig, concat):
    """The picked plan's mapping, on the shape (or a few rows of its width
    and D): each gradient written once and equal to the twin's bit for bit;
    each band value of grad read from device memory once where a block
    holds whole rows (about twice where a row is cut in tiles), and
    beyond the band only the rest of a 16-byte quad that holds some of it."""
    (b, c, h, w), d = sig
    plan = cv.volume_backward_plan(b, c, h, w, concat, SMS)
    shape = (b, c, h, w) if b * c * h * w * d <= 2**16 else _reduced((b, c, h, w), plan.rows)
    if w > 4096:  # the widest edge shape: one row of it
        shape = (1, 1, 1, w)
    reads, band = _check_backward(plan, shape, d, concat)
    if plan.tile >= w:
        assert (reads[band] == 1).all()
    else:  # the dL tile, the dR window of tile + 4 columns (one quad shared by two)
        assert (reads[band] >= 1).all() and (reads[band] <= 3).all()
        assert reads[band].mean() <= 2 + 8 / plan.tile
    assert (reads[~band] <= (1 if plan.tile >= w else 3)).all()
    if w % 4:
        assert (reads[~band] == 0).all()


@pytest.mark.parametrize("rows,tile", [(1, 8), (1, 12), (1, 16), (3, 40), (2, 40)])
@pytest.mark.parametrize("concat", [False, True])
@pytest.mark.parametrize("width,d", [(37, 5), (37, 30), (40, 13), (36, 48), (24, 1)])
def test_backward_other_cuts(rows, tile, concat, width, d):
    """Cuts the path shapes do not pick (tiles narrower than the row, a
    row per block or several), also at W < D and D = 1: the same values bit
    for bit, each output written once. Several rows a block only where each
    is whole (tile >= W): a tile of 8, 12 or 16 columns cuts every row."""
    rows = rows if tile >= width else 1
    shape = (1, 2, 3, width)
    whole = tile >= width
    piece = (tile if concat else 0) if whole else tile + 4
    plan = cv.VolumeBackwardPlan(rows, tile, 32 * -(-rows * tile // 4 // 32),
                                 8 * cv.VOL_BWD_CHUNK * rows * (tile + piece), 0)
    _check_backward(plan, shape, d, concat)


def test_backward_at_d_0_writes_zeros():
    for concat in (False, True):
        plan = cv.volume_backward_plan(2, 3, 4, 37, concat, SMS)
        reads, _ = _check_backward(plan, (2, 3, 4, 37), 0, concat)
        assert not reads.size


# ---------------------------------------------------------------------------
# the lists, the rules, the constants


def test_every_plan_of_the_lists_fits():
    """The lists the plans are picked from (and the sweep times) hold only
    cuts the kernels take."""
    for ((b, c, h, w), d), concat in PATHS + EDGES:
        for p in cv.volume_forward_plans(b, c, h, w, d):
            assert p.dchunk % 4 == 0 and -(-d // p.dchunk) <= max(cv.VOL_FWD_SPLITS)
        for p in cv.volume_backward_plans(b, c, h, w, concat):
            assert p.threads <= cv.VOL_BWD_MAX_THREADS and p.smem_bytes <= SMEM_BYTES
            assert p.rows == 1 or p.tile >= w


def test_plans_are_deterministic_and_take_any_width():
    """The same shapes give the same plans, also without the cache; no
    width is refused (the forward stages nothing, the backward cuts wide
    rows in tiles)."""
    def plans():
        return [(cv.volume_forward_plan(b, c, h, w, d, SMS),
                 cv.volume_backward_plan(b, c, h, w, concat, SMS))
                for ((b, c, h, w), d), concat in PATHS + EDGES]

    first = plans()
    cv.volume_forward_plan.cache_clear()
    cv.volume_backward_plan.cache_clear()
    assert plans() == first
    for w in (29056, 29057, 100000):
        assert cv.volume_backward_plan(1, 2, 3, w, True, SMS).tile == cv.VOL_BWD_TILE
        assert cv.volume_forward_plan(1, 2, 3, w, 192, SMS).dchunk % 4 == 0


@pytest.mark.parametrize("name", ["FWD_THREADS", "BWD_MAX_THREADS", "BWD_MIN_BLOCKS", "BWD_CHUNK"])
def test_constants_are_the_kernels(name):
    """The plans' constants are the kernels': the forward's block, the
    backward's launch bounds (which cap a thread's registers) and the planes
    of a stage of its ring."""
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found == [str(getattr(cv, f"VOL_{name}"))]
    if name == "FWD_THREADS":
        assert "__launch_bounds__(FWD_THREADS)\nvolume4d_fwd_kernel" in SOURCE
    if name == "BWD_MIN_BLOCKS":
        assert "__launch_bounds__(BWD_MAX_THREADS, BWD_MIN_BLOCKS)\nvolume4d_bwd_kernel" in SOURCE


def test_layouts_are_the_kernels():
    """The backward's shared-memory layout is the plan's formula."""
    assert "return whole ? (concat ? tile : 0) : tile + 4;" in SOURCE
    assert "return 2LL * BWD_CHUNK * rows * (tile + bwd_piece_words(tile, whole, concat));" in SOURCE
