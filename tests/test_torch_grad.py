"""The backward halves of the PyTorch port's kernel ops, on the CPU.

Each op is an autograd Function whose CPU backward is its plain version
(the explicit gradient formula the CUDA backward kernels implement). Here
that plain backward is held against ``jax.vjp`` of the ``aanet_tpu.ops``
function and against torch autograd of the plain forward, on the same
numpy inputs and cotangent; and ``gradcheck`` runs the Functions in
float64. Layouts are transposed at the boundary (JAX NHWC, port NCHW).

Tolerances: 1e-5 absolute for correlation, soft-argmin and warp; 1e-4
(relative to the largest entry, different summation order over K*Cin
terms) for the deformable conv.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aanet_tpu import ops as jops
from aanet_torch.ops import BACKWARD_OPS, KERNEL_OPS, cost_volume, deform, softargmin, warp

from _torch_port import nchw


def rng(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    yield
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)


def close(got, want, rtol):
    """|got - want| <= rtol * max|want| (+ a floor for all-zero gradients)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:  # an empty gradient (a volume of no candidates)
        return
    scale = max(float(np.abs(want).max()), 1e-3)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def leaf(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=True)


# --------------------------------------------------------------------------
# deformable conv
# --------------------------------------------------------------------------


def _deform_case(stride, groups, modulated, offsets, seed=0):
    b, h, w, cin, cout, dil, k = 2, 9, 11, 8, 6, 2, 3
    pad = dil
    ho = (h + 2 * pad - (dil * (k - 1) + 1)) // stride + 1
    wo = (w + 2 * pad - (dil * (k - 1) + 1)) // stride + 1
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, cin).astype(np.float32)
    weight = (rs.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    bias = rs.randn(cout).astype(np.float32)
    if offsets == "fractional":  # up to 4 px: border taps reach outside the image
        offset = rs.uniform(-4, 4, (b, ho, wo, groups * k * k * 2)).astype(np.float32)
    elif offsets == "far":  # whole samples outside the image
        offset = rs.uniform(-14, 14, (b, ho, wo, groups * k * k * 2)).astype(np.float32)
    else:  # integer positions: jnp.clip's half gradient at a tie
        offset = rs.randint(-2, 3, (b, ho, wo, groups * k * k * 2)).astype(np.float32)
    mask = rs.uniform(0, 2, (b, ho, wo, groups * k * k)).astype(np.float32) if modulated else None
    cot = rs.randn(b, ho, wo, cout).astype(np.float32)
    kw = dict(stride=stride, padding=pad, dilation=dil, deformable_groups=groups)
    return x, offset, mask, weight, bias, cot, kw


def _deform_jax_grads(x, offset, mask, weight, bias, cot, kw):
    def f(x, offset, mask, weight, bias):
        return jops.modulated_deform_conv2d(x, offset, mask, weight, bias, **kw)

    args = [jnp.asarray(a) if a is not None else None for a in (x, offset, mask, weight, bias)]
    _, vjp = jax.vjp(f, *args)
    gx, goff, gm, gw, gb = vjp(jnp.asarray(cot))
    return dict(
        x=np.asarray(gx).transpose(0, 3, 1, 2), offset=np.asarray(goff).transpose(0, 3, 1, 2),
        mask=None if gm is None else np.asarray(gm).transpose(0, 3, 1, 2),
        weight=np.asarray(gw).transpose(3, 2, 0, 1), bias=np.asarray(gb),
    )


def _deform_torch_grads(fn, x, offset, mask, weight, bias, cot, kw):
    t = dict(x=leaf(nchw(x)), offset=leaf(nchw(offset)),
             mask=None if mask is None else leaf(nchw(mask)),
             weight=leaf(weight.transpose(3, 2, 0, 1)), bias=leaf(bias))
    out = fn(t["x"], t["offset"], t["mask"], t["weight"], t["bias"], **kw)
    out.backward(nchw(cot))
    return {k: None if v is None else v.grad.numpy() for k, v in t.items()}


@pytest.mark.parametrize(
    "stride,groups,modulated,offsets",
    [(1, 2, True, "fractional"), (2, 2, True, "fractional"), (1, 1, False, "fractional"),
     (2, 2, False, "far"), (1, 2, True, "far"), (1, 2, True, "integer")],
)
def test_deform_backward_matches_jax(stride, groups, modulated, offsets):
    case = _deform_case(stride, groups, modulated, offsets)
    want = _deform_jax_grads(*case)
    got = _deform_torch_grads(deform.modulated_deform_conv2d, *case)
    assert type(got) is dict and (got["mask"] is None) == (not modulated)
    for name in want:
        if want[name] is not None:
            close(got[name], want[name], 1e-4)
    if offsets != "integer":  # away from ties, the plain forward's autograd agrees too
        plain = _deform_torch_grads(deform.modulated_deform_conv2d_plain, *case)
        for name in want:
            if want[name] is not None:
                close(got[name], plain[name], 1e-4)


def test_deform_backward_halves_the_offset_gradient_at_integer_positions():
    """At zero offsets every sample sits on the grid: the JAX op's offset
    gradient is then half the one-sided derivative (jnp.clip at a tie),
    and the port's backward follows it."""
    x, offset, mask, weight, bias, cot, kw = _deform_case(1, 2, True, "integer")
    offset = np.zeros_like(offset)
    want = _deform_jax_grads(x, offset, mask, weight, bias, cot, kw)["offset"]
    got = _deform_torch_grads(deform.modulated_deform_conv2d, x, offset, mask, weight, bias, cot, kw)
    plain = _deform_torch_grads(deform.modulated_deform_conv2d_plain, x, offset, mask, weight, bias, cot, kw)
    close(got["offset"], want, 1e-4)
    close(got["offset"], 0.5 * plain["offset"], 1e-4)


def test_deform_backward_with_channel_slice_offsets():
    """The layer passes offset and mask as slices of one offset_conv
    output: the gradients come back in the slices' shapes and reach the
    shared tensor as the plain forward's autograd sends them."""
    x, offset, mask, weight, bias, cot, kw = _deform_case(1, 2, True, "fractional", seed=3)
    n_off = offset.shape[-1]
    head = np.concatenate([offset, rng(*mask.shape, seed=4)], -1)
    grads = []
    for fn in (deform.modulated_deform_conv2d, deform.modulated_deform_conv2d_plain):
        om = leaf(nchw(head))
        off_slice = om[:, :n_off]
        assert not off_slice.is_contiguous()
        m = torch.sigmoid(om[:, n_off:]) * 2.0
        out = fn(torch.from_numpy(nchw(x).numpy()), off_slice, m,
                 torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()), None, **kw)
        out.backward(nchw(cot))
        grads.append(om.grad.numpy())
    close(grads[0], grads[1], 1e-4)


# --------------------------------------------------------------------------
# correlation, soft-argmin, warp
# --------------------------------------------------------------------------


@pytest.mark.parametrize("w,d", [(37, 8), (20, 24), (52, 48), (45, 16)])
def test_correlation_backward_matches_jax(w, d):
    left, right = rng(2, 5, w, 16, seed=1), rng(2, 5, w, 16, seed=2)
    cot = rng(2, 5, w, d, seed=3)
    _, vjp = jax.vjp(lambda a, b: jops.correlation_cost_volume(a, b, d), jnp.asarray(left), jnp.asarray(right))
    want = [np.asarray(g).transpose(0, 3, 1, 2) for g in vjp(jnp.asarray(cot))]
    for fn in (cost_volume.correlation_cost_volume, cost_volume.correlation_cost_volume_plain):
        lt, rt = leaf(nchw(left)), leaf(nchw(right))
        fn(lt, rt, d).backward(nchw(cot))
        close(lt.grad.numpy(), want[0], 1e-5)
        close(rt.grad.numpy(), want[1], 1e-5)


# volumes [B, H, W, D] (the JAX layout) with each sign: the first case, then
# the edges of the kernels' tiling: D = 0 (an empty gradient), D = 1, an odd
# D, and an H*W that is not a multiple of 4
SOFT_ARGMIN_CASES = [
    pytest.param(shape, match, id=f"{tag}{match}")
    for shape, tag in (((2, 6, 7, 24), ""), ((2, 5, 7, 0), "D0-"), ((2, 5, 7, 1), "D1-"),
                       ((2, 4, 6, 37), "D37-"), ((3, 3, 5, 24), "HW15-"))
    for match in (True, False)
]


@pytest.mark.parametrize("shape,match_similarity", SOFT_ARGMIN_CASES)
def test_soft_argmin_backward_matches_jax(shape, match_similarity):
    cost = rng(*shape, seed=3, scale=3.0)
    cot = rng(*shape[:3], seed=4)
    _, vjp = jax.vjp(lambda c: jops.soft_argmin(c, match_similarity), jnp.asarray(cost))
    want = np.asarray(vjp(jnp.asarray(cot))[0]).transpose(0, 3, 1, 2)
    for fn in (softargmin.soft_argmin, softargmin.soft_argmin_plain):
        ct = leaf(nchw(cost))
        fn(ct, match_similarity).backward(torch.from_numpy(cot))
        close(ct.grad.numpy(), want, 1e-5)


def _warp_case():
    b, h, w, c = 2, 5, 20, 3
    img = rng(b, h, w, c, seed=4)
    disp = np.random.RandomState(5).uniform(-6.0, 12.0, (b, h, w)).astype(np.float32)
    # border columns: exact ties with both clip bounds, and fractional
    # positions just inside and outside them
    disp[0, 0, :6] = [0.0, 1.0, 2.5, -0.25, 4.0, 4.5]  # x = 0, 0, -0.5, 3.25, 0, -0.5
    disp[0, 1, 15:] = [-4.0, -3.0, -2.0, -1.0, 0.0]  # x = w - 1 for all five
    disp[1, 2, 10:14] = [-8.75, -9.25, 10.0, 10.5]
    cot = rng(b, h, w, c, seed=6)
    return img, disp, cot


def test_disp_warp_backward_matches_jax_at_borders_and_ties():
    img, disp, cot = _warp_case()
    w = img.shape[2]
    x = np.arange(w)[None, None] - disp
    assert (x == 0).sum() >= 3 and (x == w - 1).sum() >= 5  # the ties are there

    def f(d):
        return jops.disp_warp(jnp.asarray(img), d)[0]

    _, vjp = jax.vjp(f, jnp.asarray(disp))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    dt = leaf(disp)
    warped, valid = warp.disp_warp(nchw(img), dt)
    assert valid.grad_fn is None and not valid.requires_grad
    warped.backward(nchw(cot))
    close(dt.grad.numpy(), want, 1e-5)
    # away from the ties torch autograd of the plain forward agrees
    dp = leaf(disp)
    warp.disp_warp_plain(nchw(img), dp)[0].backward(nchw(cot))
    tie = (x == 0) | (x == w - 1)
    np.testing.assert_allclose(dt.grad.numpy()[~tie], dp.grad.numpy()[~tie], atol=1e-5)
    np.testing.assert_allclose(dt.grad.numpy()[tie], 0.5 * dp.grad.numpy()[tie], atol=1e-5)


def test_disp_warp_refuses_an_image_that_needs_a_gradient():
    img, disp, _ = _warp_case()
    with pytest.raises(NotImplementedError, match="image"):
        warp.disp_warp(leaf(nchw(img)), torch.from_numpy(disp))
    with torch.no_grad():  # no graph, nothing to refuse
        warp.disp_warp(leaf(nchw(img)), torch.from_numpy(disp))


# --------------------------------------------------------------------------
# gradcheck in float64
# --------------------------------------------------------------------------


def test_gradcheck_float64():
    f64 = torch.float64
    rs = np.random.RandomState(7)
    x = leaf(rs.randn(1, 4, 5, 6), f64)
    offset = leaf(rs.uniform(-1.5, 1.5, (1, 2 * 9 * 2, 5, 6)), f64)
    mask = leaf(rs.uniform(0.2, 1.8, (1, 2 * 9, 5, 6)), f64)
    weight = leaf(rs.randn(3, 4, 3, 3) * 0.3, f64)
    bias = leaf(rs.randn(3), f64)
    kw = dict(stride=1, padding=2, dilation=2, deformable_groups=2)
    assert torch.autograd.gradcheck(
        lambda *a: deform.modulated_deform_conv2d(*a, **kw), (x, offset, mask, weight, bias),
        eps=1e-6, atol=1e-6,
    )
    left, right = leaf(rs.randn(1, 3, 2, 9), f64), leaf(rs.randn(1, 3, 2, 9), f64)
    assert torch.autograd.gradcheck(
        lambda a, b: cost_volume.correlation_cost_volume(a, b, 4), (left, right)
    )
    cost = leaf(rs.randn(1, 5, 2, 3), f64)
    for match in (True, False):
        assert torch.autograd.gradcheck(lambda c: softargmin.soft_argmin(c, match), (cost,))
    img = torch.tensor(rs.randn(1, 2, 3, 8), dtype=f64)
    disp = leaf(rs.uniform(0.1, 3.9, (1, 3, 8)) + rs.choice([0.0, 4.0], (1, 3, 8)), f64)
    assert torch.autograd.gradcheck(lambda d: warp.disp_warp(img, d)[0], (disp,))
