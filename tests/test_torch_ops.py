"""The PyTorch port's ops against the JAX package's, on the CPU.

On the CPU each kernel op runs its plain PyTorch twin; the CUDA kernels are
held against the same twins on the card by chip_smoke.py. Inputs are made
with numpy from a seed; layouts are transposed at the boundary (JAX NHWC,
port NCHW). Tolerances: 1e-5 abs, 1e-4 for the deformable conv (a
different summation order over K*Cin terms).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aanet_tpu import ops as jops
from aanet_torch import _build
from aanet_torch.ops import KERNEL_OPS, cost_volume, deform, resize, softargmin, warp

from _torch_port import nchw


def rng(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    """The CPU path never counts a kernel launch."""
    before = [op.launches for op in KERNEL_OPS]
    yield
    assert [op.launches for op in KERNEL_OPS] == before == [0] * len(KERNEL_OPS)


@pytest.mark.parametrize("w,d", [(37, 8), (64, 16), (20, 24), (52, 48), (45, 16)])
def test_correlation_matches_jax(w, d):
    left = rng(2, 5, w, 16, seed=1)
    right = rng(2, 5, w, 16, seed=2)
    want = np.asarray(jops.correlation_cost_volume(jnp.asarray(left), jnp.asarray(right), d))
    got = cost_volume.correlation_cost_volume(nchw(left), nchw(right), d)
    assert got.shape == (2, d, 5, w)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)


def test_correlation_float32_is_the_correctly_rounded_mean():
    """The plain correlation with ``exact`` (what the kernel's float32 form
    computes: float64 sums) is the exact mean rounded once, within half an
    ulp of its float64 value, where the float32 sums over 96 channels (the
    CPU path, as the JAX op sums) are not."""
    left = torch.from_numpy(rng(2, 96, 5, 40, seed=3))
    right = torch.from_numpy(rng(2, 96, 5, 40, seed=4))
    got = cost_volume.correlation_cost_volume_plain(left, right, 12, exact=True)
    exact = cost_volume.correlation_cost_volume_plain(left.double(), right.double(), 12)
    half_ulp = (torch.nextafter(got, torch.full_like(got, np.inf)) - got).double() / 2
    assert ((got.double() - exact).abs() <= half_ulp).all()
    summed32 = cost_volume.correlation_cost_volume(left, right, 12)
    assert ((summed32.double() - exact).abs() > half_ulp).any()


# volumes [B, H, W, D] (the JAX layout) with each sign: the first case, then
# the edges of the kernels' tiling: D = 0 (zeros), D = 1, an odd D, and an
# H*W that is not a multiple of 4
SOFT_ARGMIN_CASES = [
    pytest.param(shape, match, id=f"{tag}{match}")
    for shape, tag in (((2, 6, 7, 24), ""), ((2, 5, 7, 0), "D0-"), ((2, 5, 7, 1), "D1-"),
                       ((2, 4, 6, 37), "D37-"), ((3, 3, 5, 24), "HW15-"))
    for match in (True, False)
]


@pytest.mark.parametrize("shape,match_similarity", SOFT_ARGMIN_CASES)
def test_soft_argmin_matches_jax(shape, match_similarity):
    cost = rng(*shape, seed=3, scale=3.0)
    want = np.asarray(jops.soft_argmin(jnp.asarray(cost), match_similarity))
    got = softargmin.soft_argmin(nchw(cost), match_similarity)
    assert got.dtype == torch.float32 and got.shape == shape[:3]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if shape[3] == 0:
        assert not got.any()


def test_disp_warp_matches_jax_off_both_edges():
    b, h, w, c = 2, 5, 20, 3
    img = rng(b, h, w, c, seed=4)
    # negative disparities push samples off the right edge, large ones off the left
    disp = np.random.RandomState(5).uniform(-6.0, 12.0, (b, h, w)).astype(np.float32)
    disp[0, 0, :4] = [0.0, 1.0, 2.5, -0.25]  # exact and fractional samples at the edge
    want, want_valid = jops.disp_warp(jnp.asarray(img), jnp.asarray(disp))
    got, got_valid = warp.disp_warp(nchw(img), torch.from_numpy(disp))
    assert got_valid.shape == (b, 1, h, w)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got_valid.numpy()[:, 0], np.asarray(want_valid)[..., 0])
    assert 0.0 < got_valid.numpy().mean() < 1.0  # both outcomes occur


@pytest.mark.parametrize(
    "modulated,stride,groups,kernel",
    [(True, 1, 1, 3), (True, 1, 2, 3), (True, 2, 2, 3), (False, 1, 2, 3),
     (False, 2, 1, 3), (True, 1, 2, 1)],
)
def test_deform_conv_matches_jax(modulated, stride, groups, kernel):
    b, h, w, cin, cout, dil = 2, 9, 11, 8, 6, 2
    pad = dil * (kernel // 2)
    ho = (h + 2 * pad - (dil * (kernel - 1) + 1)) // stride + 1
    wo = (w + 2 * pad - (dil * (kernel - 1) + 1)) // stride + 1
    k2 = kernel * kernel
    x = rng(b, h, w, cin, seed=6)
    weight = rng(kernel, kernel, cin, cout, seed=7, scale=0.2)
    bias = rng(cout, seed=8)
    # fractional offsets of up to 3 px: border taps reach outside the image
    offset = np.random.RandomState(9).uniform(-3, 3, (b, ho, wo, groups * k2 * 2)).astype(np.float32)
    mask = np.random.RandomState(10).uniform(0, 2, (b, ho, wo, groups * k2)).astype(np.float32)
    kw = dict(stride=stride, padding=pad, dilation=dil, deformable_groups=groups)
    want = jops.modulated_deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask) if modulated else None,
        jnp.asarray(weight), jnp.asarray(bias), **kw,
    )
    got = deform.modulated_deform_conv2d(
        nchw(x), nchw(offset), nchw(mask) if modulated else None,
        torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias), **kw,
    )
    assert got.shape == (b, cout, ho, wo)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("out_hw", [(7, 29), (26, 34)])
def test_resize_matches_jax(out_hw):
    x = rng(2, 13, 17, 3, seed=14)
    np.testing.assert_allclose(
        resize.resize_bilinear(nchw(x), out_hw).numpy().transpose(0, 2, 3, 1),
        np.asarray(jops.resize_bilinear(jnp.asarray(x), out_hw)), atol=1e-5,
    )
    disp = rng(2, 13, 17, seed=15)
    np.testing.assert_allclose(
        resize.upsample_disparity(torch.from_numpy(disp), out_hw).numpy(),
        np.asarray(jops.upsample_disparity(jnp.asarray(disp), out_hw)), atol=1e-5,
    )


def test_resize_nearest_matches_jax():
    x = rng(1, 6, 5, 4, seed=16)
    np.testing.assert_array_equal(
        resize.resize_nearest(nchw(x), (12, 10)).numpy().transpose(0, 2, 3, 1),
        np.asarray(jops.resize_nearest(jnp.asarray(x), (12, 10))),
    )


def test_kernel_path_refuses_non_cuda_tensors():
    with pytest.raises(ValueError, match="lies on cpu"):
        _build.check_cuda("op", x=(torch.zeros(2), torch.float32))
    meta = torch.zeros(2, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        _build.check_cuda("op", x=(meta, torch.float32))


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "DEFAULT_NVCC", "/nonexistent/bin/nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT.parent / "_no_such_build_dir")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
