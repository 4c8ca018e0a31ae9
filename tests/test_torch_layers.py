"""The PyTorch port's deformable layers and stages against the JAX
package's, on the CPU, with randomised parameters carried across by
``aanet_torch.convert``.

Layers within 1e-4 (a different summation order); stages within 2e-3,
the per-stage tolerance of tests/test_parity_torch.py:13-16.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aanet_tpu.models import aggregation as jagg
from aanet_tpu.models import feature as jfeat
from aanet_tpu.models import layers as jlayers
from aanet_tpu.models import refinement as jref
from aanet_torch.models import aggregation, feature, layers, refinement

from _torch_port import load_flax, nchw, randomize


def rng(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flax(module, *inputs, seed, **kwargs):
    """Random variables of flax ``module`` and its eval-mode output."""
    init = jax.jit(lambda key, *a: module.init(key, *a, **kwargs))
    variables = randomize(init(jax.random.PRNGKey(0), *inputs), seed)
    apply = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))
    return variables, apply(variables, *inputs)


@pytest.mark.parametrize("stride,groups", [(1, 2), (2, 2), (1, 1)])
def test_deform_conv_layer(stride, groups):
    x = rng(2, 10, 13, 8, seed=1)
    variables, want = _flax(
        jlayers.DeformConv2dLayer(6, stride=stride, deformable_groups=groups),
        jnp.asarray(x), seed=2,
    )
    port = load_flax(layers.DeformConv2dLayer(8, 6, stride=stride, deformable_groups=groups), variables)
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_bottleneck(stride):
    x = rng(2, 12, 14, 16, seed=3)
    variables, want = _flax(
        jlayers.DeformBottleneck(8, stride=stride), jnp.asarray(x), seed=4, train=False
    )
    port = load_flax(layers.DeformBottleneck(16, 8, stride=stride), variables)
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-4)


def test_deform_simple_bottleneck():
    x = rng(1, 12, 20, 16, seed=5)
    variables, want = _flax(
        jlayers.DeformSimpleBottleneck(16), jnp.asarray(x), seed=6, train=False
    )
    port = load_flax(layers.DeformSimpleBottleneck(16, 16), variables)
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-4)


def test_feature_and_fpn_stage():
    x = rng(2, 48, 96, 3, seed=7)
    fvars, fwant = _flax(jfeat.AANetFeature(), jnp.asarray(x), seed=8, train=False)
    pvars, pwant = _flax(jfeat.FeaturePyramidNetwork(), fwant, seed=9, train=False)
    port_feat = load_flax(feature.AANetFeature(), fvars)
    port_fpn = load_flax(feature.FeaturePyramidNetwork(), pvars)
    with torch.no_grad():
        fgot = port_feat(nchw(x))
        pgot = port_fpn(fgot)
    for got, want in zip(fgot + pgot, list(fwant) + list(pwant)):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=2e-3)


def test_aggregation_stage():
    d = 16
    vols = [rng(1, 16 // 2**s, 32 // 2**s, d // 2**s, seed=10 + s) for s in range(3)]
    variables, want = _flax(
        jagg.AdaptiveAggregation(max_disp=d, num_fusions=3, num_deform_blocks=2),
        [jnp.asarray(v) for v in vols], seed=13, train=False,
    )
    port = load_flax(aggregation.AdaptiveAggregation(d, num_fusions=3, num_deform_blocks=2), variables)
    with torch.no_grad():
        got = port([nchw(v) for v in vols])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(w), atol=2e-3)


@pytest.mark.parametrize("hw", [(24, 40), (25, 41)])  # the JAX head runs s2d at even sizes
def test_refinement_stage(hw):
    h, w = hw
    low = np.abs(rng(1, (h + 1) // 2, (w + 1) // 2, seed=14)) * 3
    left = rng(1, h, w, 3, seed=15)
    right = rng(1, h, w, 3, seed=16)
    variables, want = _flax(
        jref.StereoDRNetRefinement(), jnp.asarray(low), jnp.asarray(left),
        jnp.asarray(right), seed=17, train=False,
    )
    port = load_flax(refinement.StereoDRNetRefinement(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(low), nchw(left), nchw(right))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
