"""The tilings of the soft-argmin kernels (``aanet_torch/csrc/softargmin.cu``:
the forward and the backward), on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against their
plain twins there). What surrounds them is Python: the wrappers pick the
tile of pixels and the slices of D per shape and SM count
(``ops.softargmin.forward_plan``, ``backward_plan``). Here the plans are
checked for every soft-argmin that ``chip_smoke.py``'s paths run and for its
shapes beyond them: they fit a block's and an SM's shared memory and
registers, and the kernels' thread mappings, replayed in numpy, split D into
slices that cover it once, and read (the forward), stage and write (the
backward) every (candidate, pixel) once.
"""
import collections
import pathlib
import re
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from aanet_torch._build import SM_SMEM_BYTES, SMEM_BYTES
from aanet_torch.config import preset
from aanet_torch.ops import softargmin as sa

SMS = 132  # an H100 SXM's SMs
# ((B, D, H, W), match_similarity) of each soft-argmin of the aanet train step
# (batch 16, 288x576) and inference forward (384x1248), the baselines' and
# stereonet-aa's forwards and steps, psmnet-aa's and aanet+'s forward and
# step, gcnet-aa's and ganet-aa's forward, and chip_smoke.py phase 6b's shapes
# beyond them: planes that are not a multiple of 4 or smaller than a tile,
# D = 1, 37 and 191, batch 3
PATH_SHAPES = chip_smoke.SA_PATH_SHAPES
EDGE_SHAPES = chip_smoke.SA_EDGE_SHAPES
SHAPES = sorted({shape for shape, _ in PATH_SHAPES + EDGE_SHAPES}) + [(2, 0, 6, 10)]
# the presets' paths: batch and input size of each
INPUTS = {"step": (16, (288, 576)), "inference": (1, (384, 1248))}
SOURCE = (pathlib.Path(sa.__file__).parents[1] / "csrc" / "softargmin.cu").read_text()


def _recorded_volumes(name, hw):
    """The soft-argmins of one CPU forward of preset ``name`` at ``hw``:
    {(D, height, width, match_similarity): calls}."""
    seen = collections.Counter()
    real = sa.soft_argmin

    def record(cost, match_similarity=True):
        seen[tuple(cost.shape[1:]) + (match_similarity,)] += 1
        return real(cost, match_similarity)

    torch.manual_seed(0)
    model = preset(name).build().eval()
    with mock.patch.object(sa, "soft_argmin", record), torch.no_grad():
        model(torch.randn(1, 3, *hw), torch.randn(1, 3, *hw))
    return seen


@pytest.mark.parametrize("name,calls,paths", [
    ("aanet", 3, INPUTS), ("stereonet-aa", 1, INPUTS), ("psmnet-aa", 1, INPUTS),
    ("gcnet-aa", 1, {"inference": INPUTS["inference"]}), ("aanet+", 3, INPUTS),
    ("ganet-aa", 1, {"inference": INPUTS["inference"]}),
])
def test_path_shapes_are_the_models_volumes(name, calls, paths):
    """chip_smoke.py's paths hold every soft-argmin the presets run: a
    small forward finds their candidates, signs and the scales of the input
    they run at, and those at the paths' batches and sizes are the listed
    ones (gcnet-aa's and ganet-aa's at inference only)."""
    # psmnet-aa's SPP pools 64-px windows at H/4; aanet+ pads to multiples of 96
    hw = {"psmnet-aa": (256, 256), "aanet+": (96, 192)}.get(name, (48, 96))
    seen = _recorded_volumes(name, hw)
    assert sum(seen.values()) == calls
    for d, h, w, match in seen:
        scale = hw[0] // h
        assert hw[1] // w == scale
        for path, (batch, full) in paths.items():
            sig = ((batch, d, full[0] // scale, full[1] // scale), match)
            assert sig in chip_smoke.SA_PATHS[f"{name} {path}"]


def _registers(max_threads, min_blocks):
    """A thread's registers under __launch_bounds__(max_threads,
    min_blocks): an SM's 64K over the threads it must hold."""
    return 65536 // (max_threads * min_blocks)


def _pixels(tile, vec):
    """Pixel i of quad q of a tile, [quads, 4]: 4 neighbours where rows are
    read 16 bytes wide, else a quarter tile apart."""
    q, i = np.meshgrid(np.arange(tile // 4), np.arange(4), indexing="ij")
    return 4 * q + i if vec else q + tile // 4 * i


def _slices(depth, slices):
    """The candidates of each slice, as the kernel's slice_range cuts D."""
    per = -(-depth // slices)
    return [range(min(depth, s * per), min(depth, s * per + per)) for s in range(slices)]


def _replay(plan, depth, plane, vec, writer_slices):
    """Replays a kernel's thread mapping over one batch element's plane: how
    often each (candidate, pixel) is read by a thread's slice, and how often
    each pixel is written by the threads of ``writer_slices``. Thread t of a
    block takes quad t % (tile / 4) and slice t // (tile / 4)."""
    nq = plan.tile // 4
    reads = np.zeros((depth, plane), int)
    writes = np.zeros(plane, int)
    ranges = _slices(depth, plan.slices)
    for p0 in range(0, plane, plan.tile):
        for t in range(plan.threads):
            q, s = t % nq, t // nq
            js = [p0 + j for j in _pixels(plan.tile, vec)[q] if p0 + j < plane]
            reads[np.ix_(list(ranges[s]), js)] += 1
            if s in writer_slices:
                writes[js] += 1
    return reads, writes


def _staged(plan, depth, plane, vec):
    """Replays the backward's staging of each tile's slab: thread (quad q,
    slice s) copies its quad of rows s, s + slices, ... (one 16-byte copy a
    row where rows are read 16 bytes wide, else four 4-byte ones). Returns
    how often each (candidate, pixel) of the plane is copied, and how many
    slab words beyond the plane are zero-filled."""
    nq, pixels = plan.tile // 4, _pixels(plan.tile, vec)
    rows, cols = [], []  # the (row, pixel of the tile) of every copy, by thread
    for t in range(plan.threads):
        q, s = t % nq, t // nq
        d = np.arange(s, depth, plan.slices)
        rows.append(np.repeat(d, 4))
        cols.append(np.tile(pixels[q], len(d)))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    copied = np.zeros((depth, plane), int)
    zeroed = 0
    for p0 in range(0, plane, plan.tile):
        inside = p0 + cols < plane
        np.add.at(copied, (rows[inside], p0 + cols[inside]), 1)
        zeroed += int((~inside).sum())
    return copied, zeroed


def _small(shape):
    """The shape's plane replayed in full where it is small, else the same
    tiling on a plane of a few tiles with the same remainder mod the tile."""
    b, d, h, w = shape
    return d, h * w if h * w <= 4096 else 1024 + h * w % 1024


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_plan_fits_and_covers(shape):
    b, d, h, w = shape
    plan = sa.forward_plan(b, d, h * w, SMS)
    # the block: a warp a slice, within the launch bounds; no slice more
    # than D has candidates
    assert plan.tile == sa.FWD_TILE == 128
    assert 1 <= plan.slices <= max(d, 1)
    assert plan.threads == plan.tile // 4 * plan.slices
    assert plan.threads % 32 == 0 and plan.threads <= sa.FWD_MAX_THREADS
    # shared memory: the slices' triples, within a block's and an SM's limit
    # (with its reserve); registers within the launch bounds' budget
    assert plan.smem_bytes == (4 * 2 * plan.tile * plan.slices if plan.slices > 1 else 0)
    assert plan.smem_bytes <= SMEM_BYTES and plan.smem_bytes + 1024 <= SM_SMEM_BYTES
    assert plan.threads * _registers(sa.FWD_MAX_THREADS, sa.FWD_MIN_BLOCKS) <= 65536
    assert plan.blocks == b * -(-h * w // plan.tile)
    # the most slices of whole chunks of candidates where there are some
    whole = [n for n in range(1, min(sa.FWD_SLICES, max(d, 1)) + 1) if -(-d // n) % sa.UNROLL == 0]
    if whole:
        assert plan.slices == max(whole)
    # the slices partition D; every (candidate, pixel) is read once and every
    # pixel written once (by slice 0), both for 16-byte and 4-byte loads
    assert sorted(c for r in _slices(d, plan.slices) for c in r) == list(range(d))
    depth, plane = _small(shape)
    for vec in (plane % 4 == 0, False):
        reads, writes = _replay(plan, depth, plane, vec, {0})
        assert (reads == 1).all() and (writes == 1).all()


# each shape with rows read 16 bytes wide where its plane allows, and without
BWD_CASES = [(s, vec) for s in SHAPES if s[1] > 0 for vec in (True, False)
             if not (vec and s[2] * s[3] % 4)]


@pytest.mark.parametrize("shape,vec", BWD_CASES)
def test_backward_plan_fits_and_covers(shape, vec):
    b, d, h, w = shape
    plan = sa.backward_plan(b, d, h * w, SMS)
    # the block: whole warps of quads by slices within the launch bounds
    assert plan.tile in sa.BWD_TILES and plan.threads in sa.BWD_THREADS
    assert plan.threads == plan.tile // 4 * plan.slices and 1 <= plan.slices <= d
    assert plan.threads % 32 == 0 and plan.threads <= sa.BWD_MAX_THREADS
    # shared memory: the slab [D][tile] and the merge slots, within a block's
    # and an SM's limit; registers within the launch bounds' budget
    assert plan.smem_bytes == 4 * plan.tile * (d + 2 * plan.slices)
    assert plan.smem_bytes <= SMEM_BYTES and plan.smem_bytes + 1024 <= SM_SMEM_BYTES
    assert plan.threads * _registers(sa.BWD_MAX_THREADS, sa.BWD_MIN_BLOCKS) <= 65536
    assert plan.blocks == b * -(-h * w // plan.tile)
    assert sorted(c for r in _slices(d, plan.slices) for c in r) == list(range(d))
    # a plane that is not a multiple of 4 takes the wide tile where D allows
    if h * w % 4 and d >= sa.BWD_SLICES[1]:
        assert (plan.tile, plan.slices) == (sa.BWD_ODD_TILE, sa.BWD_SLICES[1])
    # every (candidate, pixel) staged once, the slab beyond the plane
    # zero-filled, with 16-byte copies (vec) or 4-byte ones
    depth, plane = _small(shape)
    copied, zeroed = _staged(plan, depth, plane, vec)
    assert (copied == 1).all()
    assert zeroed == depth * (-(-plane // plan.tile) * plan.tile - plane)
    # the statistics and the write take the same (quad, slice) of a thread:
    # each (candidate, pixel) is read from the slab by one thread, which
    # writes its gradient
    touched, _ = _replay(plan, depth, plane, vec, set())
    assert (touched == 1).all()


def test_every_plan_of_the_lists_fits():
    """The lists the plans are picked from (and the sweep times) hold only
    tilings the kernels take: whole warps, the launch bounds, a block's
    shared memory, no more slices than candidates."""
    for b, d, h, w in SHAPES:
        for p in sa.forward_plans(b, d, h * w):
            assert p.threads % 32 == 0 and p.threads <= sa.FWD_MAX_THREADS
            assert p.smem_bytes <= SMEM_BYTES and 1 <= p.slices <= max(d, 1)
        for p in sa.backward_plans(b, d, h * w):
            assert p.threads % 32 == 0 and p.threads <= sa.BWD_MAX_THREADS
            assert p.smem_bytes <= SMEM_BYTES and 1 <= p.slices <= d


def test_plans_are_deterministic():
    """The same shapes give the same plans, also without the cache."""
    def plans():
        return [(sa.forward_plan(b, d, h * w, SMS),
                 sa.backward_plan(b, d, h * w, SMS) if d else None)
                for b, d, h, w in SHAPES]

    first = plans()
    sa.forward_plan.cache_clear()
    sa.backward_plan.cache_clear()
    assert plans() == first


def test_plans_raise_when_nothing_fits():
    # 2000 candidates: a slab of even the narrowest tile exceeds a block's
    # shared memory
    with pytest.raises(ValueError, match="no tiling"):
        sa.backward_plan(1, 2000, 64, SMS)
    assert sa.backward_plans(1, 2000, 64) == []
    # D = 0: the forward has one slice, no shared memory, and writes zeros
    assert sa.forward_plan(2, 0, 60, SMS)[1:4] == (1, 32, 0)


@pytest.mark.parametrize("name", ["UNROLL", "FWD_TILE", "FWD_MAX_THREADS", "FWD_MIN_BLOCKS",
                                  "BWD_MAX_THREADS", "BWD_MIN_BLOCKS"])
def test_constants_are_the_kernels(name):
    """The plans' constants are the kernels': the unroll, the forward's tile
    and the launch bounds (which cap a thread's registers)."""
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found == [str(getattr(sa, name))]
    if name == "FWD_MIN_BLOCKS":
        assert "__launch_bounds__(FWD_MAX_THREADS, FWD_MIN_BLOCKS)\nsoftargmin_fwd_kernel" in SOURCE
    if name == "BWD_MIN_BLOCKS":
        assert "__launch_bounds__(BWD_MAX_THREADS, BWD_MIN_BLOCKS)\nsoftargmin_bwd_kernel" in SOURCE


def test_tiles_and_layouts_are_the_kernels():
    """The backward is built for each tile the plans name, and both kernels'
    shared-memory layouts are the plans' formulas."""
    assert set(re.findall(r"launch_bwd<(\d+)>", SOURCE)) == {str(t) for t in sa.BWD_TILES}
    assert "(tile != 32 && tile != 64 && tile != 128 && tile != 256)" in SOURCE
    assert "return slices > 1 ? 4 * 2 * FWD_TILE * slices : 0;" in SOURCE
    assert "return 4 * tile * (depth + 2 * slices);" in SOURCE
