"""The warp backward (``aanet_torch/csrc/warp.cu``: ``warp_bwd_kernel``,
behind ``aanet_warp_backward_f32`` and ``aanet_warp_backward_bf16``), on the
CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain twin there). Here: the launch geometry it shares with the forward at
the paths' warps and the widths beyond them, every pixel of a row one
thread's; its loads, arithmetic and stores against the source; and a numpy
replay of the kernel: each thread's quad of 4 pixels (its disparity, each
channel's run of the gradient and its store 16 bytes wide, 8 for a bf16
gradient, each aligned and inside its row, where the width is a multiple of
4; else a value at a time), both taps of every pixel inside the row, the
channels summed by fmaf in ascending c where clip' is not 0, every pixel
written once; against ``jax.grad`` of the JAX ``disp_warp`` in float32 and
on a bf16 image, the half gradient at the two borders included.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aanet_torch.ops import warp
from aanet_tpu.ops.warp import disp_warp as jax_disp_warp
from test_torch_warp_bf16_rows import PATH_SHAPES, _launch

SOURCE = (pathlib.Path(warp.__file__).parents[1] / "csrc" / "warp.cu").read_text()
BACKWARD = SOURCE[SOURCE.index("warp_bwd_kernel(const T* __restrict__ grad_warped"):]


@pytest.mark.parametrize("shape", PATH_SHAPES + chip_smoke.WARP_EDGE_SHAPES)
def test_backward_launch_covers_every_pixel_once(shape):
    """The backward launches the forward's grid (``warp_grid``): whole warps
    of at most WARP_MAX_THREADS threads, a row's quads over the fewest such
    blocks, one (b, h) row a (blockIdx.z, blockIdx.y); every pixel of a row
    is one thread's."""
    launch = BACKWARD[BACKWARD.index("int launch_warp_bwd("):]
    launch = launch[:launch.index("\n}\n")]
    assert "const WarpGrid grid = warp_grid(batch, height, width);" in launch
    assert "warp_bwd_kernel<3, T><<<grid.blocks, grid.threads, 0, s>>>" in launch
    assert "warp_bwd_kernel<0, T><<<grid.blocks, grid.threads, 0, s>>>" in launch
    assert "if (batch > 65535 || height > 65535)" in launch
    w = shape[3]
    blocks, threads = _launch(w)
    w0 = np.arange(blocks * threads) * 4
    owned = np.concatenate([np.arange(x, min(x + 4, w)) for x in w0[w0 < w]])
    assert np.array_equal(np.sort(owned), np.arange(w))


def test_backward_loads_and_arithmetic_are_the_kernels():
    """What the replay takes: 32-bit indices from the block's row, the vector
    condition, the disparity loaded by the forward's evict-first helper, each
    channel's gradient run evict-first, the taps from L1, the fmaf order, the
    product by -clip' and the float4 store; each entry point launches the
    one template."""
    assert "const int w0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;" in BACKWARD
    assert ("const bool vec = (width & 3) == 0 && aligned16(disp) && aligned16(grad_disp) &&\n"
            "                   aligned16(img) && aligned16(grad_warped);") in BACKWARD
    assert BACKWARD.count("load_disp4(drow, w0, n, vec, d);") == 1
    assert SOURCE.count("load_disp4(drow, w0, n, vec, d);") == 2  # the forward's too
    assert "const float4 q = ldcs4_f32(src + w0);" in BACKWARD
    assert "for (int i = 0; i < 4; ++i) acc[i] = fmaf(g[c][i], hi[c][i] - lo[c][i], acc[i]);" in BACKWARD
    assert "v[i] = -dclip[i] * (dclip[i] != 0.f ? acc[i] : 0.f);" in BACKWARD
    assert "*reinterpret_cast<float4*>(orow + w0) = make_float4(v[0], v[1], v[2], v[3]);" in BACKWARD
    assert "/ width" not in BACKWARD and "% width" not in BACKWARD
    for form in ("bf16", "f32"):
        entry = SOURCE[SOURCE.index(f'extern "C" int aanet_warp_backward_{form}('):]
        assert entry[:entry.index(")")].count(",") + 1 == len(warp._ARGTYPES) == 10
        assert "return launch_warp_bwd(" in entry[:entry.index("\n}")]


def _fmaf(a, b, c):
    """fmaf in float32: the exact product (a float64 holds it) plus c,
    rounded to float32."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _replay(grad, img, disp):
    """The kernel on one image: grad and img [B, C, H, W] float32 (the
    bf16 form's values widened), disp [B, H, W] float32. Block (x, h, b),
    thread t: the quad of pixels from w0 = (x * threads + t) * 4, if w0 <
    W; where vec its loads and its store must start aligned and end inside
    the row. Returns (grad_disp, writes per pixel)."""
    b, c, h, w = img.shape
    blocks, threads = _launch(w)
    out = np.full((b, h, w), np.nan, np.float32)
    writes = np.zeros((b, h, w), int)
    last = np.float32(w - 1)
    w0s = np.arange(blocks * threads) * 4
    w0s = w0s[w0s < w]
    if w % 4 == 0:  # 16-byte (8-byte) loads and stores within the row
        assert (w0s % 4 == 0).all() and (w0s + 4 <= w).all()
    xs = np.concatenate([np.arange(x, min(x + 4, w)) for x in w0s])
    for bi in range(b):
        for hh in range(h):
            x = (xs.astype(np.float32) - disp[bi, hh, xs]).astype(np.float32)
            dclip = np.where((x > 0) & (x < last), 1.0,
                             np.where((x == 0) | (x == last), 0.5, 0.0)).astype(np.float32)
            xc = np.minimum(np.maximum(x, np.float32(0)), last)
            x0 = np.minimum(np.floor(xc).astype(np.int64), w - 2)
            assert (x0 >= 0).all() and (x0 + 1 <= w - 1).all()  # both taps inside the row
            acc = np.zeros(len(xs), np.float32)
            for ch in range(c):
                slope = (img[bi, ch, hh, x0 + 1] - img[bi, ch, hh, x0]).astype(np.float32)
                acc = _fmaf(grad[bi, ch, hh, xs], slope, acc)
            out[bi, hh, xs] = (-dclip * np.where(dclip != 0, acc, np.float32(0))).astype(np.float32)
            np.add.at(writes[bi, hh], xs, 1)
    return out, writes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels,w", [(3, 2), (3, 9), (3, 63), (3, 575), (3, 1244), (3, 61),
                                        (5, 63)])
def test_backward_replay_matches_jax(dtype, channels, w):
    """At ``WARP_EDGE_SHAPES``' widths (a value at a time where W is not a
    multiple of 4, a last partial quad; 2, the narrowest) and with five
    channels (the kernel's loop over any C): every pixel written once from
    taps inside its row, within 1e-5 of max|ref| (chip_smoke's tolerance)
    of ``jax.grad`` of the JAX op on the same image and of the plain twin;
    disparities take the samples off both edges, onto integers and onto the
    border ties, where the gradient is half the inside one and JAX's."""
    b, h = 2, 3
    rng = np.random.RandomState(w + channels)
    img = torch.from_numpy(rng.randn(b, channels, h, w).astype(np.float32))
    grad = torch.from_numpy(rng.randn(b, channels, h, w).astype(np.float32))
    if dtype == "bfloat16":  # the bf16 form's inputs: their values widened exactly
        img, grad = img.bfloat16().float(), grad.bfloat16().float()
    disp = (rng.rand(b, h, w) * (w + 32) - 16).astype(np.float32)
    disp[0, 0, : min(w, 4)] = [0.0, 1.0, 3.0, -2.0][: min(w, 4)]
    disp[1, 2, -2:] = [w - 2.0, 0.0]  # x = 0 and x = w - 1: the ties
    disp[1, 1, :] = np.arange(w) - (w - 1) / 2.0  # x at the middle, inside
    got, writes = _replay(grad.numpy(), img.numpy(), disp)
    assert (writes == 1).all()

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jimg = jnp.asarray(img.numpy().transpose(0, 2, 3, 1)).astype(jdt)
    jgrad = jnp.asarray(grad.numpy().transpose(0, 2, 3, 1))

    def loss(d):
        warped, _ = jax_disp_warp(jimg, d)
        return jnp.sum(warped.astype(jnp.float32) * jgrad)

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(disp)))
    tol = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    half = got[1, 2, -2:]  # the ties: half of the gradient with clip' = 1
    for k, col in enumerate((w - 2, w - 1)):
        x0 = min(int(np.floor(col - disp[1, 2, col])), w - 2)
        full = -sum(grad[1, c, 2, col].item() * (img[1, c, 2, x0 + 1].item() - img[1, c, 2, x0].item())
                    for c in range(channels))
        assert abs(half[k] - 0.5 * full) <= 1e-5 * max(abs(full), 1e-6)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    plain = warp.disp_warp_backward_plain(grad.to(dt), img.to(dt), torch.from_numpy(disp)).numpy()
    assert np.abs(got - plain).max() <= tol
