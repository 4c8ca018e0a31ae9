"""GC-Net and PSMNet's basic aggregation in the PyTorch port against the
JAX package, on the CPU, with randomised weights carried across by
``aanet_torch.convert`` (strict loads): ``GCNetFeature``,
``GCNetAggregation`` and ``PSMNetBasicAggregation`` in eval and training
mode, both networks whole in eval, and the 3-D aggregations under
checkpointing.

Tolerances: modules within 1e-4 of the output's largest value (another
summation order through tens of convs), their running statistics
likewise; whole networks within 5e-2 px max and 5e-3 px mean
(tests/test_parity_torch.py:13-16); a checkpointed aggregation's
statistics within 1e-6 and gradients within rtol 1e-5 of the plain run's.
Sizes: GC-Net's four stride-2 levels need its volume's D, H and W to be
multiples of 16, so the network runs at 64x128 with max_disp 32; PSMNet at
256x256 (its SPP pools 64-px windows at H/4) with max_disp 64.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aanet_tpu.config import ModelConfig as JaxModelConfig
from aanet_tpu.models import aggregation as jagg
from aanet_tpu.models import feature as jfeat
from aanet_torch.config import ModelConfig
from aanet_torch.models import aggregation, feature, layers
from aanet_torch.ops import BACKWARD_OPS, KERNEL_OPS

from _torch_port import load_flax, nchw, randomize

GCNET = dict(feature_type="gcnet", feature_similarity="concat", aggregation_type="gcnet",
             num_downsample=1, refinement_type="None")
PSMNET_BASIC = dict(feature_type="psmnet", feature_similarity="concat",
                    aggregation_type="psmnet_basic", refinement_type="None")


def rng(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def ncdhw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 4, 1, 2, 3)))


def close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    yield
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)


def _module(jax_module, port_module, x, train, seed):
    """The JAX module's output (and moved statistics in training) on ``x``
    from randomised variables, and the port's module with them loaded."""
    init = jax.jit(lambda key, a: jax_module.init(key, a, train=False))
    variables = randomize(init(jax.random.PRNGKey(0), x), seed)
    extra = dict(mutable=["batch_stats"]) if train else {}
    out = jax.jit(lambda v, a: jax_module.apply(v, a, train=train, **extra))(variables, x)
    want, mutated = out if train else (out, None)
    port = load_flax(port_module, variables)
    if train:
        port.train()
    return port, want, mutated


def _check_stats(port, mutated):
    buffers = dict(port.named_buffers())
    for path, leaf in jax.tree_util.tree_flatten_with_path(mutated["batch_stats"])[0]:
        keys = [p.key for p in path]
        close(buffers[".".join(keys[:-1] + ["running_" + keys[-1]])].numpy(), leaf)


@pytest.mark.parametrize("train", [False, True])
def test_gcnet_feature(train):
    x = rng(2, 64, 96, 3, seed=1)
    port, want, mutated = _module(jfeat.GCNetFeature(), feature.GCNetFeature(), jnp.asarray(x), train, 2)
    with torch.no_grad():
        got = port(nchw(x))
    assert tuple(got.shape) == (2, 32, 32, 48)
    close(got.numpy().transpose(0, 2, 3, 1), want)
    if train:
        _check_stats(port, mutated)


@pytest.mark.parametrize("train", [False, True])
def test_gcnet_aggregation(train):
    """[B, C, D, H, W] -> [B, 2D - 1, 2H - 1, 2W - 1], the reference's
    transposed-conv arithmetic, in eval and training mode."""
    vol = rng(1, 16, 16, 32, 64, seed=3)  # NDHWC
    port, want, mutated = _module(jagg.GCNetAggregation(), aggregation.GCNetAggregation(64),
                                  jnp.asarray(vol), train, 4)
    with torch.no_grad():
        got = port(ncdhw(vol))  # [B, D', H', W']
    assert tuple(got.shape) == (1, 31, 31, 63)
    close(got.numpy().transpose(0, 2, 3, 1), want)
    if train:
        _check_stats(port, mutated)


def test_gcnet_aggregation_refuses_sizes_its_levels_do_not_fit():
    with pytest.raises(ValueError, match="multiples of 16"):
        aggregation.GCNetAggregation(64).eval()(torch.zeros(1, 64, 16, 24, 32))


@pytest.mark.parametrize("train", [False, True])
def test_psmnet_basic_aggregation(train):
    """One map, upsampled x4, in eval and training alike."""
    vol = rng(1, 8, 12, 16, 64, seed=5)
    port, want, mutated = _module(jagg.PSMNetBasicAggregation(max_disp=32),
                                  aggregation.PSMNetBasicAggregation(64), jnp.asarray(vol), train, 6)
    with torch.no_grad():
        got = port(ncdhw(vol))
    assert len(got) == len(want) == 1
    assert tuple(got[0].shape) == (1, 32, 48, 64)
    close(got[0].numpy().transpose(0, 2, 3, 1), want[0])
    if train:
        _check_stats(port, mutated)


@pytest.mark.parametrize("name,flags,max_disp,hw", [
    ("gcnet", GCNET, 32, (64, 128)),
    ("psmnet_basic", PSMNET_BASIC, 64, (256, 256)),
])
def test_network_matches_jax(name, flags, max_disp, hw):
    """The whole network in eval; GC-Net's map is one pixel short on each
    axis of the image, as the JAX model's."""
    h, w = hw
    jmodel = JaxModelConfig(max_disp=max_disp, remat=False, **flags).build()
    rs = np.random.RandomState(12)
    left, right = (rs.randn(1, h, w, 3).astype(np.float32) for _ in range(2))
    zeros = jnp.zeros((1, h, w, 3))
    variables = jax.jit(lambda k: jmodel.init(k, zeros, zeros, train=False))(jax.random.PRNGKey(0))
    variables = randomize(variables, 13)
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(variables, left, right)
    port = load_flax(ModelConfig(max_disp=max_disp, **flags).build(), variables)
    with torch.no_grad():
        got = port(nchw(left), nchw(right))
    shape = (1, h - 1, w - 1) if name == "gcnet" else (1, h, w)
    assert len(got) == len(want) == 1 and tuple(got[0].shape) == shape
    err = np.abs(got[0].numpy() - np.asarray(want[0]))
    assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())


@pytest.mark.parametrize("make,shape", [
    (lambda: aggregation.PSMNetHGAggregation(64), (1, 64, 8, 16, 16)),
    (lambda: aggregation.GCNetAggregation(64), (2, 64, 16, 16, 16)),
], ids=["psmnet_hourglass", "gcnet"])
def test_checkpointed_3d_aggregation_updates_batchnorm_statistics_once(make, shape):
    """The composer checkpoints a 3-D aggregation as a whole in training,
    so backward recomputes all of it; its statistics after forward +
    backward equal those without checkpointing, each moved exactly once,
    and the gradients are the un-checkpointed run's, none of them zero
    (GC-Net at batch 2: its 1x1x1 level leaves one value per channel at
    batch 1, which BatchNorm maps to its bias with no gradient)."""
    vol = torch.from_numpy(rng(*shape, seed=7))
    runs = []
    for checkpointed in (False, True):
        torch.manual_seed(1)
        agg = make().train()
        out = layers.remat(agg, vol) if checkpointed else agg(vol)
        out = out if isinstance(out, list) else [out]
        sum(o.square().sum() for o in out).backward()
        runs.append(agg)
    plain, checkpointed = (dict(a.named_buffers()) for a in runs)
    for name, value in checkpointed.items():
        if name.endswith("num_batches_tracked"):
            assert int(value) == 1, name
        else:
            torch.testing.assert_close(value, plain[name], rtol=0, atol=1e-6)
    grads = [dict((n, p.grad) for n, p in a.named_parameters()) for a in runs]
    assert all(g is not None and float(g.abs().sum()) > 0 for g in grads[1].values())
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=1e-5, atol=1e-6)
