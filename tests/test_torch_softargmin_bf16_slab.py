"""The bf16 soft-argmin backward's raw slab (``aanet_torch/csrc/softargmin.cu``:
``softargmin_bwd_kernel<TP, VEC, bf16>``), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain twin there). Here: its plan (``ops.softargmin.backward_plan_bf16``) at
every soft-argmin of the paths and at the shapes beyond them, within a
block's and an SM's shared memory and the launch bounds, its slices covering
D once and its threads every (candidate, pixel) once; its layout (the raw
slab at 2 bytes a value, the float32 merge slots after it) against the
kernel source; and a numpy replay of the slab's staging, raw: 8-byte copies
of a quad where the plane is a multiple of 4 (each from an aligned source,
wholly inside the plane or wholly beyond it), a load and a store a value
where it is odd (a quad's pixels a quarter tile apart), and each quad
widened exactly where it is read.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from aanet_torch._build import SM_SMEM_BYTES, SMEM_BYTES
from aanet_torch.ops import softargmin as sa
from test_torch_softargmin_plan import _pixels, _replay, _slices, _small

SMS = 132  # an H100 SXM's SMs
SOURCE = (pathlib.Path(sa.__file__).parents[1] / "csrc" / "softargmin.cu").read_text()
SHAPES = sorted({shape for shape, _ in chip_smoke.SA_PATH_SHAPES + chip_smoke.SA_EDGE_SHAPES})
# each shape with the 8-byte quads where its plane allows, and without
CASES = [(s, vec) for s in SHAPES for vec in (True, False) if not (vec and s[2] * s[3] % 4)]


def _registers(max_threads, min_blocks):
    return 65536 // (max_threads * min_blocks)


@pytest.mark.parametrize("shape,vec", CASES)
def test_backward_plan_bf16_fits_and_covers(shape, vec):
    """The bf16 plan: the raw slab's layout (2 bytes a value, float32 merge
    slots), a block's and an SM's shared memory, the launch bounds; its
    slices partition D and each (candidate, pixel) is read and written by
    one thread; the float32 plan's tile in less shared memory (at the same
    slices, at least the float32 plan's resident blocks); 8 slices where D
    reaches BWD_DEEP or the plane is odd, else 4."""
    b, d, h, w = shape
    plan = sa.backward_plan_bf16(b, d, h * w, SMS)
    assert plan.tile in sa.BWD_TILES and plan.threads in sa.BWD_THREADS
    assert plan.threads == plan.tile // 4 * plan.slices and 1 <= plan.slices <= d
    assert plan.threads <= sa.BWD_MAX_THREADS
    assert plan.threads * _registers(sa.BWD_MAX_THREADS, sa.BWD_MIN_BLOCKS) <= 65536
    assert plan.smem_bytes == 2 * plan.tile * d + 4 * 2 * plan.tile * plan.slices
    assert plan.smem_bytes <= SMEM_BYTES and plan.smem_bytes + 1024 <= SM_SMEM_BYTES
    assert plan.blocks == b * -(-h * w // plan.tile)
    assert sorted(c for r in _slices(d, plan.slices) for c in r) == list(range(d))
    f32 = sa.backward_plan(b, d, h * w, SMS)
    assert plan.tile == f32.tile and plan.smem_bytes < f32.smem_bytes
    if d >= sa.BWD_SLICES[1]:
        deep = d >= sa.BWD_DEEP or h * w % 4
        assert plan.slices == sa.BWD_SLICES[bool(deep)]
    resident = lambda p: min(SM_SMEM_BYTES // (p.smem_bytes + 1024), 2048 // p.threads)  # noqa: E731
    if plan.slices == f32.slices:
        assert resident(plan) >= resident(f32)
    depth, plane = _small(shape)
    reads, writes = _replay(plan, depth, plane, vec, {0})
    assert (reads == 1).all() and (writes == 1).all()


def test_backward_plan_bf16_halves_the_slab_at_d192():
    """At D = 192 (the PSMNet step) a 64-pixel slab takes 24 KB where the
    float32 form's took 48; D beyond a block's shared memory raises."""
    plan = sa.backward_plan_bf16(16, 192, 288 * 576, SMS)
    assert plan.tile == 64 and 2 * plan.tile * 192 == 24 * 1024
    assert sa.backward_plan(16, 192, 288 * 576, SMS).smem_bytes - 4 * 64 * 2 * plan.slices == 48 * 1024
    with pytest.raises(ValueError, match="no bf16 tiling"):
        sa.backward_plan_bf16(1, 4000, 64, SMS)
    first = [sa.backward_plan_bf16(b, d, h * w, SMS) for b, d, h, w in SHAPES]
    sa.backward_plan_bf16.cache_clear()
    assert [sa.backward_plan_bf16(b, d, h * w, SMS) for b, d, h, w in SHAPES] == first


def test_bf16_layout_is_the_kernels():
    """The kernel's bf16 layout is the plan's formula, it checks the plan's
    shared memory against that layout, its merge slots start after the raw
    slab, the slab is copied raw by 8-byte cp.async a quad (else a load and
    a store a value) and each quad is widened where it is read."""
    assert "return 2 * tile * (depth + 4 * slices);" in SOURCE
    assert ("const int layout = is_bf16<T> ? bwd_smem_bytes_bf16(tile, depth, slices)\n"
            "                                 : bwd_smem_bytes(tile, depth, slices);") in SOURCE
    assert "float4* part = reinterpret_cast<float4*>(slab + depth * TP);" in SOURCE
    assert "cp_async_8(dst + 4 * q, in[0] ? src + 4 * q : cost, in[0] ? 8 : 0);" in SOURCE
    assert "dst[j] = in[i] ? src[j] : __ushort_as_bfloat16(0);" in SOURCE
    assert "widen4(*reinterpret_cast<const uint2*>(row + 4 * q))" in SOURCE
    for tile in sa.BWD_TILES:
        for depth in (1, 37, 191, 192):
            assert (2 * tile * depth) % 16 == 0  # the merge slots' float4s stay aligned
    assert sa._bwd_smem(64, 192, 8, value_bytes=2) == 2 * 64 * (192 + 4 * 8)


def _stage_raw(plan, cost, vec):
    """Replays the bf16 staging of every tile's slab of one batch element
    (cost [D, plane], bf16 bit patterns): thread (quad q, slice s) copies
    its quad of rows s, s + slices, ...: one 8-byte copy (``vec``; its
    source must be 8-byte aligned and the quad wholly inside the plane or
    beyond it) or four values. Returns the slabs [tiles, D, tile]."""
    depth, plane = cost.shape
    nq, pixels = plan.tile // 4, _pixels(plan.tile, vec)
    tiles = -(-plane // plan.tile)
    slabs = np.full((tiles, depth, plan.tile), 0xFFFF, np.uint16)  # poison
    for k in range(tiles):
        p0 = k * plan.tile
        for t in range(plan.threads):
            q, s = t % nq, t // nq
            for d in range(s, depth, plan.slices):
                if vec:
                    first = p0 + pixels[q][0]
                    inside = [p0 + j < plane for j in pixels[q]]
                    assert all(inside) or not any(inside)
                    assert list(pixels[q]) == list(range(4 * q, 4 * q + 4))
                    assert (2 * (d * plane + first)) % 8 == 0 and (2 * (d * plan.tile + 4 * q)) % 8 == 0
                    slabs[k, d, 4 * q: 4 * q + 4] = cost[d, first: first + 4] if inside[0] else 0
                else:
                    for j in pixels[q]:
                        slabs[k, d, j] = cost[d, p0 + j] if p0 + j < plane else 0
    return slabs


@pytest.mark.parametrize("shape,vec", [((1, 37, 7, 9), False), ((1, 24, 3, 5), False),
                                       ((1, 191, 5, 27), False), ((1, 37, 12, 40), True),
                                       ((1, 37, 12, 40), False), ((1, 16, 24, 48), True),
                                       ((1, 1, 6, 64), True)])
def test_raw_slab_replay(shape, vec):
    """The raw slab holds every (candidate, pixel) of its tile bit for bit
    and zeros beyond the plane, by either route; each quad widened as
    ``load_quad`` reads it (the bf16 value in a float32's high half) is the
    volume's value exactly; no slot is left unwritten."""
    b, d, h, w = shape
    plane = h * w
    plan = sa.backward_plan_bf16(b, d, plane, SMS)
    rng = np.random.RandomState(d + plane)
    bits = rng.randint(0, 2**16, size=(d, plane)).astype(np.uint16)
    bits[:, :3] = [0x0000, 0x8000, 0x0001]  # zeros and a subnormal
    slabs = _stage_raw(plan, bits, vec)
    assert not (slabs == 0xFFFF).any() or (bits == 0xFFFF).any()
    padded = np.zeros((d, slabs.shape[0] * plan.tile), np.uint16)
    padded[:, :plane] = bits
    assert np.array_equal(slabs.transpose(1, 0, 2).reshape(d, -1), padded)
    widened = (slabs.astype(np.uint32) << 16).view(np.float32)
    want = torch.from_numpy(padded.astype(np.int16)).view(torch.bfloat16).float().numpy()
    assert np.array_equal(widened.transpose(1, 0, 2).reshape(d, -1).view(np.uint32),
                          want.view(np.uint32))


@pytest.mark.parametrize("name", ["BWD_MAX_THREADS", "BWD_MIN_BLOCKS"])
def test_bf16_launch_bounds_are_the_kernels(name):
    """Both forms of the backward are one template under the same launch
    bounds, and the bf16 entry point takes the bf16 plan's layout."""
    assert re.findall(rf"constexpr int {name} = (\d+);", SOURCE) == [str(getattr(sa, name))]
    assert "__launch_bounds__(BWD_MAX_THREADS, BWD_MIN_BLOCKS)\nsoftargmin_bwd_kernel" in SOURCE
    entry = SOURCE[SOURCE.index('extern "C" int aanet_softargmin_backward_bf16'):]
    assert "launch_bwd_entry(grad_out, cost, grad_cost" in entry
