"""The bf16 soft-argmin forward, a kernel of its own
(``aanet_torch/csrc/softargmin.cu``: ``softargmin_fwd_bf16_kernel``), on the
CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain twin there). Here: its plan (``ops.softargmin.forward_plan_bf16``) at
every soft-argmin of the paths and at the shapes beyond them, within a
block's and an SM's shared memory and the launch bounds; a replay of its
thread mapping (a block a tile, each thread its octet of pixels and its
slice of D in chunks of 8, each warp storing its share of the merged tile)
under every plan of its list, which reads every (candidate, pixel) once and
stores every pixel once; its constants and shared-memory formula against
the source; and a numpy float32 replay of its arithmetic (the chunks'
online softmax in the log2 domain, the slices merged in order) against the
JAX ``soft_argmin`` on the same bf16 volume.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aanet_torch._build import SM_SMEM_BYTES, SMEM_BYTES
from aanet_torch.ops import softargmin as sa
from aanet_tpu.ops.softargmin import soft_argmin as jax_soft_argmin
from test_torch_softargmin_plan import _slices, _small

SMS = 132  # an H100 SXM's SMs
SOURCE = (pathlib.Path(sa.__file__).parents[1] / "csrc" / "softargmin.cu").read_text()
SHAPES = sorted({shape for shape, _ in chip_smoke.SA_PATH_SHAPES + chip_smoke.SA_EDGE_SHAPES}) + [
    (2, 0, 6, 10)]
LOG2E = np.float32(1.4426950408889634)


def _tol(ref):
    """The float32 form's tolerance, as chip_smoke.py holds the bf16 one."""
    return max(1e-4, 2e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_plan_bf16_fits(shape):
    """A warp a slice, at most BF16_MAX_THREADS; no more slices than
    candidates; the merge slots within a block's shared memory and
    BF16_MIN_BLOCKS blocks' within an SM's; a block a tile; the pick's rule: BF16_ODD_SLICES where the
    plane is not a multiple of 8, else the fewest slices of at most
    BF16_SHORT candidates (a grid of fewer than BF16_SM_TILES tiles an SM)
    or BF16_LONG (more), else 8."""
    b, d, h, w = shape
    plan = sa.forward_plan_bf16(b, d, h * w, SMS)
    assert plan in sa.forward_plans_bf16(b, d, h * w)
    assert plan.tile == sa.BF16_TILE == 256
    assert plan.slices in sa.BF16_SLICES and plan.slices <= max(d, 1)
    assert plan.threads == 32 * plan.slices <= sa.BF16_MAX_THREADS
    assert plan.smem_bytes == (4 * 3 * plan.tile * plan.slices if plan.slices > 1 else 0)
    assert plan.smem_bytes <= SMEM_BYTES
    assert (plan.smem_bytes + 1024) * sa.BF16_MIN_BLOCKS <= SM_SMEM_BYTES
    assert plan.blocks == b * -(-h * w // plan.tile)
    if h * w % 8:
        assert plan.slices == min(sa.BF16_ODD_SLICES, max(d, 1))
    else:
        most = sa.BF16_SHORT if plan.blocks < sa.BF16_SM_TILES * SMS else sa.BF16_LONG
        fits = [s for s in sa.BF16_SLICES if s <= max(d, 1) and -(-d // s) <= most]
        assert plan.slices == (fits[0] if fits else 8)


def test_picks_at_the_paths():
    """The picks the sweep led to at the paths' volumes (an H100's 132 SMs):
    the aanet step's 4, 4, 2 slices and inference's 8, 4, 2; PSMNet's 8;
    GC-Net's odd planes 2."""
    def slices(b, d, h, w):
        return sa.forward_plan_bf16(b, d, h * w, SMS).slices

    assert [slices(16, 64, 96, 192), slices(16, 32, 48, 96), slices(16, 16, 24, 48)] == [4, 4, 2]
    assert [slices(1, 64, 128, 416), slices(1, 32, 64, 208), slices(1, 16, 32, 104)] == [8, 4, 2]
    assert slices(1, 192, 384, 1248) == slices(16, 192, 288, 576) == 8
    assert slices(1, 191, 383, 1247) == slices(8, 191, 287, 575) == 2


def _walk(plan, depth, plane):
    """Replays the kernel's thread mapping over one batch element: a block a
    tile; thread (lane o, warp s) reads the candidates of slice s in chunks
    of UNROLL at its octet's pixels (8 neighbours where the plane is a
    multiple of 8, else 32 apart); one slice's thread stores its octet, more
    slices' warp s stores pixels s * tile / slices + o * 8 / slices + k of
    the tile. Returns how often each (candidate, pixel) is read and each
    pixel stored."""
    vec = plane % 8 == 0
    reads = np.zeros((depth, plane), int)
    stores = np.zeros(plane, int)
    lanes = np.arange(32)
    octet = (8 * lanes[:, None] + np.arange(8)) if vec else (lanes[:, None] + 32 * np.arange(8))
    ranges = _slices(depth, plan.slices)
    pl = 8 // plan.slices
    for p0 in range(0, plane, plan.tile):
        for s in range(plan.slices):
            pix = p0 + octet.ravel()
            inside = pix[pix < plane]
            for d0 in range(ranges[s].start, ranges[s].stop, sa.UNROLL):
                rows = np.arange(d0, min(d0 + sa.UNROLL, ranges[s].stop))
                np.add.at(reads, (np.repeat(rows, len(inside)), np.tile(inside, len(rows))), 1)
            if plan.slices > 1:
                pix = p0 + s * (plan.tile // plan.slices) + (lanes[:, None] * pl + np.arange(pl)).ravel()
            np.add.at(stores, pix[pix < plane], 1)
    return reads, stores


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] > 0])
def test_forward_bf16_mapping_covers(shape):
    """Every (candidate, pixel) of the plane read once and every pixel stored
    once, under every plan of the list, on a plane with the shape's
    remainder mod the tile."""
    b, d, h, w = shape
    depth, plane = _small(shape)
    for plan in sa.forward_plans_bf16(b, depth, plane):
        reads, stores = _walk(plan, depth, plane)
        assert (reads == 1).all() and (stores == 1).all()


@pytest.mark.parametrize("name", ["BF16_TILE", "BF16_MAX_THREADS", "BF16_MIN_BLOCKS",
                                  "BF16_ODD_MIN_BLOCKS"])
def test_constants_are_the_kernels(name):
    assert re.findall(rf"constexpr int {name} = (\d+);", SOURCE) == [str(getattr(sa, name))]


def test_layout_and_builds_are_the_kernels():
    """The shared-memory formula, the launch bounds (the builds reading a
    value a load hold fewer blocks an SM), the slices it takes,
    the chunk of UNROLL rows, the thread mappings the replays take, and the
    entry point's arguments (the float32 form's); the bf16 entry launches
    the bf16 kernel only."""
    assert "return slices > 1 ? 4 * 3 * BF16_TILE * slices : 0;" in SOURCE
    assert sa._fwd_bf16_smem(8) == 4 * 3 * 256 * 8
    assert ("__launch_bounds__(BF16_MAX_THREADS, VEC ? BF16_MIN_BLOCKS : BF16_ODD_MIN_BLOCKS)\n"
            "softargmin_fwd_bf16_kernel") in SOURCE
    assert "(slices != 1 && slices != 2 && slices != 4 && slices != 8)" in SOURCE
    assert sa.BF16_SLICES == (1, 2, 4, 8)
    assert "void load_rows(uint4 (&raw)[UNROLL]," in SOURCE
    assert "return o + (BF16_TILE / 8) * i;" in SOURCE
    assert "const int p = s * (BF16_TILE / S) + lane * PL;" in SOURCE
    assert "const bool vec = plane % 8 == 0 && aligned16(cost) && aligned16(out);" in SOURCE
    entries = [SOURCE[SOURCE.index(f'extern "C" int aanet_softargmin_{form}('):] for form in ("f32", "bf16")]
    params = [" ".join(e[e.index("("):e.index(")")].replace("const bf16*", "const float*").split())
              for e in entries]
    assert params[0] == params[1]  # the float32 form's arguments
    body = entries[1][:entries[1].index("\n}")]
    assert "launch_fwd_bf16(" in body and "launch_fwd(" not in body


def _ex2(x):
    """2^x rounded to float32 (the SFU's ex2 is within 2^-22 of it)."""
    with np.errstate(over="ignore"):
        return np.exp2(x.astype(np.float64)).astype(np.float32)


def _fma(a, b, c):
    """a * b + c rounded once (the product of two float32 is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(np.float32)


def _replay_forward(vol, slices, match):
    """The kernel's arithmetic in float32 on a volume [B, D, P] of bf16
    values: each of ``slices`` slices' chunks of UNROLL candidates (the chunk's max of
    a = s * v * log2(e) first, its values' 2^(a - m) by one fma each, the
    sums rescaled once a chunk), then the slices' triples merged in order."""
    b, depth, plane = vol.shape
    lo2 = LOG2E if match else -LOG2E
    triples = []
    with np.errstate(invalid="ignore"):
        for r in _slices(depth, slices):
            m = np.full((b, plane), -np.inf, np.float32)
            total = np.zeros((b, plane), np.float32)
            wtotal = np.zeros((b, plane), np.float32)
            for d0 in range(r.start, r.stop, sa.UNROLL):
                chunk = vol[:, d0:min(d0 + sa.UNROLL, r.stop)]
                ext = chunk.max(1) if match else chunk.min(1)
                mx = np.maximum(m, (ext * lo2).astype(np.float32))
                scale = _ex2((m - mx).astype(np.float32))
                s = np.zeros_like(total)
                w = np.zeros_like(total)
                for u in range(chunk.shape[1]):
                    e = _ex2(_fma(chunk[:, u], lo2, -mx))
                    s = (s + e).astype(np.float32)
                    w = _fma(e, np.float32(d0 + u), w)
                total, wtotal, m = _fma(total, scale, s), _fma(wtotal, scale, w), mx
            triples.append((m, total, wtotal))
        if slices > 1:
            mx = np.max([m for m, _, _ in triples], axis=0)
            total = np.zeros_like(mx)
            wtotal = np.zeros_like(mx)
            for m, t, wt in triples:
                f = np.where(m == -np.inf, np.float32(0), _ex2((m - mx).astype(np.float32)))
                total, wtotal = _fma(t, f, total), _fma(wt, f, wtotal)
        else:
            _, total, wtotal = triples[0]
        return np.where(total > 0, wtotal / np.where(total > 0, total, 1), 0).astype(np.float32)


@pytest.mark.parametrize("shape,scale", [
    ((2, 64, 4, 16), 3.0), ((1, 192, 2, 24), 3.0), ((2, 37, 7, 9), 3.0), ((2, 1, 6, 64), 3.0),
    ((1, 24, 3, 5), 3.0), ((2, 64, 4, 16), 12.0), ((1, 192, 2, 24), 12.0)])
@pytest.mark.parametrize("match", [True, False])
def test_replay_matches_jax(shape, scale, match):
    """The replay of the kernel's chunks, log2-domain softmax and ordered
    merge under every plan of the list (1, 2, 4 and 8 slices; chunks cut
    short at the slice's end; D = 1) gives the JAX op's disparity on the
    same bf16 volume (as seeded inputs: normal values times ``scale``)
    within the float32 form's tolerance, for a similarity and a matching
    cost."""
    b, d, h, w = shape
    rng = np.random.RandomState(d * 31 + h * w)
    cost = torch.from_numpy(rng.randn(b, d, h, w).astype(np.float32) * scale).bfloat16()
    bits = cost.permute(0, 2, 3, 1).contiguous().view(torch.int16).numpy()
    want = np.asarray(jax_soft_argmin(jnp.asarray(bits).view(jnp.bfloat16), match))
    for plan in sa.forward_plans_bf16(b, d, h * w):
        got = _replay_forward(cost.float().numpy().reshape(b, d, h * w), plan.slices, match)
        assert np.abs(got.reshape(b, h, w) - want).max() <= _tol(want)
    assert np.abs(sa.soft_argmin_plain(cost, match).numpy() - want).max() <= _tol(want)
