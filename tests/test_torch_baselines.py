"""The modules of the PyTorch port's PSMNet and StereoNet baselines
against the JAX package's, on the CPU, with randomised weights carried
across by ``aanet_torch.convert`` (strict loads); the whole networks are
in test_torch_baseline_models.py.

Tolerance: within 1e-4 of the output's largest value (another summation
order through tens of convs).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aanet_tpu.models import aggregation as jagg
from aanet_tpu.models import feature as jfeat
from aanet_tpu.models import refinement as jref
from aanet_torch.models import aggregation, feature, refinement
from aanet_torch.ops import KERNEL_OPS

from _torch_port import load_flax, nchw, randomize


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
    assert all(op.launches == 0 for op in KERNEL_OPS)


def _flax(module, *inputs, seed, mutable=False, **kwargs):
    init = jax.jit(lambda key, *a: module.init(key, *a, **kwargs))
    variables = randomize(init(jax.random.PRNGKey(0), *inputs), seed)
    extra = dict(mutable=["batch_stats"]) if mutable else {}
    apply = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs, **extra))
    return variables, apply(variables, *inputs)


def test_stereonet_feature():
    x = rng(2, 48, 96, 3, seed=1)
    variables, want = _flax(jfeat.StereoNetFeature(2), jnp.asarray(x), seed=2, train=False)
    port = load_flax(feature.StereoNetFeature(2), variables)
    with torch.no_grad():
        got = port(nchw(x))
    close(got.numpy().transpose(0, 2, 3, 1), want)


def test_psmnet_feature():
    x = rng(1, 256, 256, 3, seed=3)
    variables, want = _flax(jfeat.PSMNetFeature(), jnp.asarray(x), seed=4, train=False)
    port = load_flax(feature.PSMNetFeature(), variables)
    with torch.no_grad():
        got = port(nchw(x))
    assert tuple(got.shape) == (1, 32, 64, 64)
    close(got.numpy().transpose(0, 2, 3, 1), want)
    with pytest.raises(ValueError, match="at least 256x256"):
        port(torch.zeros(1, 3, 252, 256))


def test_stereonet_aggregation():
    vol = rng(1, 6, 8, 12, 16, seed=5)  # NDHWC
    variables, want = _flax(jagg.StereoNetAggregation(), jnp.asarray(vol), seed=6, train=False)
    port = load_flax(aggregation.StereoNetAggregation(16), variables)
    with torch.no_grad():
        got = port(ncdhw(vol))  # [B, D, H, W]
    close(got.numpy().transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("train", [False, True])
def test_psmnet_hourglass_aggregation(train):
    """Eval: one map; training: the three heads and the updated running
    statistics of every 3-D BatchNorm."""
    vol = rng(1, 8, 12, 16, 64, seed=7)
    variables, out = _flax(jagg.PSMNetHGAggregation(max_disp=32), jnp.asarray(vol), seed=8,
                           mutable=train, train=train)
    want, mutated = out if train else (out, None)
    port = load_flax(aggregation.PSMNetHGAggregation(64), variables)
    if train:
        port.train()
    with torch.no_grad():
        got = port(ncdhw(vol))
    assert len(got) == len(want) == (3 if train else 1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (1, 32, 48, 64)
        close(g.numpy().transpose(0, 2, 3, 1), w)
    if train:
        stats = jax.tree_util.tree_flatten_with_path(mutated["batch_stats"])[0]
        buffers = dict(port.named_buffers())
        for path, leaf in stats:
            keys = [p.key for p in path]
            name = ".".join(keys[:-1] + ["running_" + keys[-1]])
            close(buffers[name].numpy(), leaf)


@pytest.mark.parametrize("hw", [(24, 40), (25, 41)])  # the JAX head runs s2d at even sizes
def test_stereonet_refinement(hw):
    h, w = hw
    low = np.abs(rng(1, (h + 1) // 2, (w + 1) // 2, seed=9)) * 3
    left = rng(1, h, w, 3, seed=10)
    variables, want = _flax(jref.StereoNetRefinement(), jnp.asarray(low), jnp.asarray(left),
                            seed=11, train=False)
    port = load_flax(refinement.StereoNetRefinement(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(low), nchw(left))
    close(got.numpy(), want)
