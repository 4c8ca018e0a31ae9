"""The PyTorch port's 4-D cost volumes, trilinear resize, 3-D layers and
weight conversion against the JAX package's, on the CPU.

On the CPU the volume ops run their plain twins; the CUDA kernels are held
against the same twins on the card by chip_smoke.py. Inputs are made with
numpy from a seed; layouts are transposed at the boundary (JAX NDHWC, port
NCDHW). Tolerances: the volumes are a copy or one subtraction, so exactly
equal, and their gradients (sums over d in another order) within 1e-6 of
the largest entry; the resize of values in (-1, 1) within 1e-6; the 3-D
layers within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aanet_tpu import ops as jops
from aanet_tpu.config import ModelConfig as JaxModelConfig
from aanet_tpu.models import layers as jlayers
from aanet_tpu.ops.resize import resize_trilinear as jax_resize_trilinear
from aanet_torch.config import ModelConfig
from aanet_torch.convert import flax_from_state_dict, state_dict_from_flax
from aanet_torch.models import layers
from aanet_torch.ops import BACKWARD_OPS, KERNEL_OPS, cost_volume, resize

from _torch_port import load_flax, nchw, randomize

PSMNET = dict(feature_type="psmnet", feature_similarity="concat",
              aggregation_type="psmnet_hourglass", refinement_type="None")
STEREONET = dict(feature_type="stereonet", feature_similarity="difference",
                 aggregation_type="stereonet", refinement_type="stereonet")


def rng(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def ncdhw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 4, 1, 2, 3)))


def ndhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 4, 1)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    yield
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)


VOLUMES = {
    "difference": (jops.difference_cost_volume, cost_volume.difference_cost_volume),
    "concat": (jops.concat_cost_volume, cost_volume.concat_cost_volume),
}


@pytest.mark.parametrize("kind", sorted(VOLUMES))
@pytest.mark.parametrize("w,d", [(37, 8), (12, 12)])
def test_volume_equals_jax_exactly(kind, w, d):
    jax_op, port_op = VOLUMES[kind]
    left, right = rng(2, 5, w, 6, seed=1), rng(2, 5, w, 6, seed=2)
    want = np.asarray(jax_op(jnp.asarray(left), jnp.asarray(right), d))  # [B, D, H, W, C']
    got = port_op(nchw(left), nchw(right), d)  # [B, C', D, H, W]
    assert got.shape == (2, 6 * (2 if kind == "concat" else 1), d, 5, w)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 4, 1), want)


@pytest.mark.parametrize("kind", sorted(VOLUMES))
def test_volume_backward_matches_jax_vjp(kind):
    jax_op, port_op = VOLUMES[kind]
    w, d = 19, 7
    left, right = rng(2, 4, w, 5, seed=3), rng(2, 4, w, 5, seed=4)
    out, vjp = jax.vjp(lambda a, b: jax_op(a, b, d), jnp.asarray(left), jnp.asarray(right))
    cot = rng(*out.shape, seed=5)
    want_l, want_r = vjp(jnp.asarray(cot))
    lt = nchw(left).requires_grad_(True)
    rt = nchw(right).requires_grad_(True)
    port_op(lt, rt, d).backward(torch.from_numpy(np.ascontiguousarray(cot.transpose(0, 4, 1, 2, 3))))
    for got, want in ((lt.grad, want_l), (rt.grad, want_r)):
        want = np.asarray(want)
        err = np.abs(got.numpy().transpose(0, 2, 3, 1) - want).max()
        assert err <= 1e-6 * np.abs(want).max(), err


@pytest.mark.parametrize("kind", sorted(VOLUMES))
def test_volume_backward_raises_off_the_cpu(kind):
    """Off the CPU the backward takes its CUDA kernel or raises: a tensor
    that is neither on the CPU nor float32 CUDA is refused by the kernel's
    checks, and never answered with zeros, ``None`` or the plain twin."""
    backward = getattr(cost_volume, f"{kind}_cost_volume_backward")
    left = torch.empty((1, 4, 3, 9), device="meta")
    grad = torch.empty((1, 4 * (2 if kind == "concat" else 1), 5, 3, 9), device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        backward(grad, left, left)
    assert backward.launches == 0


@pytest.mark.parametrize("in_dhw,out_dhw", [((3, 5, 7), (12, 20, 28)), ((4, 6, 9), (7, 10, 13))])
def test_resize_trilinear_matches_jax(in_dhw, out_dhw):
    # values in (-1, 1): the two sum the same terms in another order
    x = np.random.RandomState(6).uniform(-1, 1, (2, *in_dhw, 3)).astype(np.float32)
    want = np.asarray(jax_resize_trilinear(jnp.asarray(x), out_dhw))
    got = resize.resize_trilinear(ncdhw(x), out_dhw)
    np.testing.assert_allclose(ndhwc(got), want, atol=1e-6)


def _flax(module, *inputs, seed, **kwargs):
    init = jax.jit(lambda key, *a: module.init(key, *a, **kwargs))
    variables = randomize(init(jax.random.PRNGKey(0), *inputs), seed)
    return variables, jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *inputs)


SIZES = [(6, 8, 10), (5, 7, 9)]  # even and odd


@pytest.mark.parametrize("dhw", SIZES)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv3d_matches_jax(dhw, stride):
    x = rng(2, *dhw, 4, seed=7)
    variables, want = _flax(jlayers.Conv(6, (3, 3, 3), stride, 1, use_bias=True), jnp.asarray(x), seed=8)
    port = load_flax(layers.Conv(4, 6, (3, 3, 3), stride, 1, bias=True), variables)
    with torch.no_grad():
        got = port(ncdhw(x))
    np.testing.assert_allclose(ndhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dhw", SIZES)
def test_conv_transpose3d_matches_jax(dhw):
    """The JAX input-dilated conv and the port's flipped conv_transpose3d."""
    x = rng(1, *dhw, 4, seed=9)
    variables, want = _flax(jlayers.ConvTranspose(5, (3, 3, 3), 2, 1, 1), jnp.asarray(x), seed=10)
    port = load_flax(layers.ConvTranspose(4, 5, (3, 3, 3), 2, 1, 1), variables)
    with torch.no_grad():
        got = port(ncdhw(x))
    assert tuple(got.shape[2:]) == tuple(2 * s for s in dhw)
    np.testing.assert_allclose(ndhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dhw", SIZES)
def test_norm3d_matches_flax_in_eval_and_training(dhw):
    x = rng(2, *dhw, 5, seed=11) * 2 + 0.5
    module = jlayers.Norm()
    variables = randomize(module.init(jax.random.PRNGKey(0), jnp.asarray(x), False), 12)
    want_eval = module.apply(variables, jnp.asarray(x), False)
    want_train, mutated = module.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    port = load_flax(layers.Norm(5, dims=3), variables)
    with torch.no_grad():
        np.testing.assert_allclose(ndhwc(port(ncdhw(x))), np.asarray(want_eval), atol=1e-5)
        port.train()
        np.testing.assert_allclose(ndhwc(port(ncdhw(x))), np.asarray(want_train), atol=1e-5)
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(port.BatchNorm_0.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(port.BatchNorm_0.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5)


def _psmnet_tree():
    jmodel = JaxModelConfig(**PSMNET).build()
    img = jnp.zeros((1, 256, 256, 3))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), img, img, train=False))
    rs = np.random.RandomState(13)
    return jax.tree_util.tree_map(lambda s: rs.randn(*s.shape).astype(np.float32), shapes)


def test_conversion_round_trips_the_psmnet_tree():
    """flax -> state_dict -> flax gives back every leaf of the PSMNet
    baseline (3-D conv and transposed-conv kernels, 3-D BatchNorms), and
    the state_dict loads strictly into the port's model."""
    tree = _psmnet_tree()
    state = state_dict_from_flax(tree["params"], tree["batch_stats"])
    assert any(v.ndim == 5 for v in state.values())
    ModelConfig(**PSMNET).build().load_state_dict(state, strict=True)
    params, batch_stats = flax_from_state_dict(state)
    for want, got in ((tree["params"], params), (tree["batch_stats"], batch_stats)):
        flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert flat_got.keys() == flat_want.keys()
        for path, leaf in flat_want.items():
            np.testing.assert_array_equal(flat_got[path], leaf, err_msg=str(path))


def test_freeze_bn_freezes_the_3d_batchnorms():
    model = dataclasses.replace(ModelConfig(**STEREONET), max_disp=48).build()
    layers.set_train_mode(model, freeze_bn=True)
    norms = [m for m in model.modules() if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d))]
    assert any(isinstance(m, torch.nn.BatchNorm3d) for m in norms)
    assert model.training and not any(m.training for m in norms)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    left, right = (torch.from_numpy(rng(1, 3, 48, 96, seed=s)) for s in (14, 15))
    model(left, right)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
