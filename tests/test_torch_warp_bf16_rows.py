"""The bf16 warp forward (``aanet_torch/csrc/warp.cu``: ``warp_kernel``
with ``T = bf16``, behind ``aanet_warp_bf16``), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain twin there). Here: the launch geometry the kernel takes at the paths'
warps and the widths beyond them; its constants, checks and evict-first
disparity loads against the source; and a numpy replay of the kernel: each
thread's quad of 4 pixels of a row (its disparity loaded 16 bytes at a time
and its quads stored 8 bytes at a time, each aligned and inside its row,
where the width is a multiple of 4; else a value at a time), both taps of
every pixel inside the row, the kernel's float32 arithmetic and one rounding
to bf16, every pixel written once; against the plain twin bit for bit and the
JAX ``disp_warp`` on the same bf16 image (the mask exactly).
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aanet_torch.ops import warp
from aanet_tpu.ops.warp import disp_warp as jax_disp_warp

SOURCE = (pathlib.Path(warp.__file__).parents[1] / "csrc" / "warp.cu").read_text()
PATH_SHAPES = [s for shapes in chip_smoke.WARP_PATHS.values() for s in shapes]
MAX_THREADS = int(re.findall(r"constexpr int WARP_MAX_THREADS = (\d+);", SOURCE)[0])


def _launch(width):
    """The kernel's launch over a row (``launch_warp``): its quads over the
    fewest blocks of at most WARP_MAX_THREADS threads, each a multiple of
    32. Returns (blocks a row, threads a block)."""
    quads = -(-width // 4)
    blocks = -(-quads // MAX_THREADS)
    per_block = -(-quads // blocks)
    return blocks, -(-per_block // 32) * 32


@pytest.mark.parametrize("shape", PATH_SHAPES + chip_smoke.WARP_EDGE_SHAPES)
def test_launch_covers_every_quad_once(shape):
    """Whole warps of at most WARP_MAX_THREADS threads, a row's quads over
    the fewest such blocks, every quad of a row one thread's."""
    w = shape[3]
    blocks, threads = _launch(w)
    quads = -(-w // 4)
    assert threads % 32 == 0 and threads <= MAX_THREADS
    assert blocks == -(-quads // MAX_THREADS) and (blocks - 1) * threads < quads <= blocks * threads
    w0 = np.arange(blocks * threads) * 4
    owned = np.concatenate([np.arange(x, min(x + 4, w)) for x in w0[w0 < w]])
    assert np.array_equal(np.sort(owned), np.arange(w))


def test_constants_and_checks_are_the_kernels():
    """The launch geometry and vector condition the replay takes, the
    disparity loaded evict-first, and the entry point's arguments (the
    wrapper's argument types); the bf16 entry launches the one template
    the float32 entry does."""
    assert MAX_THREADS == 256
    assert "const int blocks = (quads + WARP_MAX_THREADS - 1) / WARP_MAX_THREADS;" in SOURCE
    assert "const int threads = ((quads + blocks - 1) / blocks + 31) / 32 * 32;" in SOURCE
    assert "const bool vec = (width & 3) == 0 && aligned16(disp)" in SOURCE
    assert "const int w0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;" in SOURCE
    assert "__ldcs(reinterpret_cast<const float4*>(drow + w0))" in SOURCE
    assert "if (i < n) d[i] = __ldcs(drow + w0 + i);" in SOURCE
    for form in ("bf16", "f32"):
        entry = SOURCE[SOURCE.index(f'extern "C" int aanet_warp_{form}('):]
        assert entry[:entry.index(")")].count(",") + 1 == len(warp._ARGTYPES) == 10
        assert "return launch_warp(" in entry[:entry.index("\n}")]
    assert "warp_kernel<3, T><<<" in SOURCE and "warp_kernel<0, T><<<" in SOURCE


def _replay(img_bits, disp):
    """The kernel on one image: img_bits [B, C, H, W] bf16 bits, disp
    [B, H, W] float32. Block (x, h, b), thread t: the quad of pixels from
    w0 = (x * threads + t) * 4, if w0 < W; where vec its disparity load
    (16 bytes) and its stores (8 bytes) must start aligned and end inside
    the row. Returns (warped bits, mask bits, writes per pixel)."""
    b, c, h, w = img_bits.shape
    blocks, threads = _launch(w)
    vec = w % 4 == 0
    warped = np.zeros_like(img_bits)
    valid = np.zeros((b, 1, h, w), np.uint16)
    writes = np.zeros((b, h, w), int)
    last = np.float32(w - 1)
    w0s = np.arange(blocks * threads) * 4
    w0s = w0s[w0s < w]
    if vec:  # offsets in values from the row's start, which lies w values after the last row's
        assert (w0s % 4 == 0).all() and (w0s + 4 <= w).all()
    xs = np.concatenate([np.arange(x, min(x + 4, w)) for x in w0s])
    for bi in range(b):
        for hh in range(h):
            x = (xs.astype(np.float32) - disp[bi, hh, xs]).astype(np.float32)
            xc = np.minimum(np.maximum(x, np.float32(0)), last)
            x0 = np.minimum(np.floor(xc).astype(np.int64), w - 2)
            assert (x0 >= 0).all() and (x0 + 1 <= w - 1).all()  # both taps inside the row
            t = (xc - x0.astype(np.float32)).astype(np.float32)
            xf = np.floor(x)
            tf = (x - xf).astype(np.float32)
            cover = (np.where((xf >= 0) & (xf <= last), np.float32(1) - tf, np.float32(0))
                     + np.where((xf + 1 >= 0) & (xf + 1 <= last), tf, np.float32(0)))
            valid[bi, 0, hh, xs] = np.where(cover >= np.float32(0.9999), 0x3F80, 0)
            for ch in range(c):
                lo = (img_bits[bi, ch, hh, x0].astype(np.uint32) << 16).view(np.float32)
                hi = (img_bits[bi, ch, hh, x0 + 1].astype(np.uint32) << 16).view(np.float32)
                v = (lo * (np.float32(1) - t) + hi * t).astype(np.float32)
                warped[bi, ch, hh, xs] = torch.from_numpy(v).bfloat16().view(torch.int16).numpy()
            np.add.at(writes[bi, hh], xs, 1)
    return warped, valid, writes


@pytest.mark.parametrize("w", [576, 288, 1248, 624, 9, 63, 575])
def test_replay_matches_jax(w):
    """At the paths' widths (quads loaded 16 and stored 8 bytes wide) and at
    odd ones (a value at a time; a last partial quad): every pixel is
    written once from taps inside its row, the result is the plain twin's
    bit for bit and the JAX op's on the same bf16 image within one bf16 ulp
    of max|ref|, the mask exactly. Disparities take the samples off both
    edges, onto integers and onto the border ties."""
    b, c, h = 2, 3, 3
    rng = np.random.RandomState(w)
    img = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).bfloat16()
    disp = (rng.rand(b, h, w) * (w + 32) - 16).astype(np.float32)
    disp[0, 0, :4] = [0.0, 1.0, 3.0, -2.0]
    disp[1, 2, -2:] = [0.0, w - 1.0]  # x = w - 2 and x = 0: the ties
    bits = img.view(torch.int16).numpy().view(np.uint16)
    jw, jv = jax.jit(jax_disp_warp)(jnp.asarray(bits.transpose(0, 2, 3, 1).view(np.int16)).view(jnp.bfloat16),
                                    jnp.asarray(disp))
    want = np.asarray(jw.astype(jnp.float32)).transpose(0, 3, 1, 2)
    want_mask = np.asarray(jv.astype(jnp.float32)).transpose(0, 3, 1, 2)
    plain, plain_mask = warp.disp_warp_plain(img, torch.from_numpy(disp))
    warped, valid, writes = _replay(bits, disp)
    assert (writes == 1).all()
    got = (warped.astype(np.uint32) << 16).view(np.float32)
    mask = (valid.astype(np.uint32) << 16).view(np.float32)
    assert np.array_equal(got, plain.float().numpy()) and np.array_equal(mask, plain_mask.float().numpy())
    assert np.abs(got - want).max() <= chip_smoke.bf16_ulp(torch.tensor(want))
    assert np.array_equal(mask, want_mask)
