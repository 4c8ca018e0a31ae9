"""The PyTorch port's PSMNet and StereoNet baselines and the
``stereonet-aa`` preset, whole, against the JAX package, on the CPU, with
randomised weights carried across by ``aanet_torch.convert`` (strict
loads).

Tolerance: the pyramid within 5e-2 px max and 5e-3 px mean
(tests/test_parity_torch.py:13-16). Sizes: the PSMNet baseline at 256x256
(its SPP pools 64-px windows at H/4) with max_disp 64; the StereoNet
baseline and ``stereonet-aa`` at 48x96 with max_disp 48.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aanet_tpu.config import ModelConfig as JaxModelConfig
from aanet_tpu.config import preset as jax_preset
from aanet_torch.config import ModelConfig, preset
from aanet_torch.ops import KERNEL_OPS

from _torch_port import load_flax, nchw, randomize

PSMNET = dict(feature_type="psmnet", feature_similarity="concat",
              aggregation_type="psmnet_hourglass", refinement_type="None")
STEREONET = dict(feature_type="stereonet", feature_similarity="difference",
                 aggregation_type="stereonet", refinement_type="stereonet")


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    yield
    assert all(op.launches == 0 for op in KERNEL_OPS)


CONFIGS = {
    "psmnet": (JaxModelConfig(max_disp=64, **PSMNET), ModelConfig(max_disp=64, **PSMNET), (256, 256)),
    "stereonet": (JaxModelConfig(max_disp=48, **STEREONET), ModelConfig(max_disp=48, **STEREONET),
                  (48, 96)),
    "stereonet-aa": (dataclasses.replace(jax_preset("stereonet-aa"), max_disp=48),
                     dataclasses.replace(preset("stereonet-aa"), max_disp=48), (48, 96)),
}


def _whole(name, train=False):
    """The JAX model's randomised variables and its pyramid on a seeded
    pair, and the port's model with those variables loaded strictly."""
    jcfg, cfg, (h, w) = CONFIGS[name]
    jcfg, cfg = (dataclasses.replace(c, remat=False) for c in (jcfg, cfg))
    jmodel = jcfg.build()
    rs = np.random.RandomState(12)
    left, right = (rs.randn(1, h, w, 3).astype(np.float32) for _ in range(2))
    zeros = jnp.zeros((1, h, w, 3))
    variables = jax.jit(lambda k: jmodel.init(k, zeros, zeros, train=False))(jax.random.PRNGKey(0))
    variables = randomize(variables, 13)
    extra = dict(mutable=["batch_stats"]) if train else {}
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=train, **extra))(variables, left, right)
    want = want[0] if train else want
    port = load_flax(cfg.build(), variables)
    return port, (nchw(left), nchw(right)), want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configuration_matches_jax(name):
    port, (left, right), want = _whole(name)
    h, w = CONFIGS[name][2]
    with torch.no_grad():
        got = port(left, right)
    shapes = [(1, h, w)] if name == "psmnet" else [(1, h // 4, w // 4), (1, h // 2, w // 2), (1, h, w)]
    assert [tuple(g.shape) for g in got] == shapes
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32
        err = np.abs(g.numpy() - np.asarray(wv))
        assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())


def test_psmnet_training_forward_gives_the_three_maps_in_jax_order():
    """In training the PSMNet baseline returns its three heads as the JAX
    composer orders them, [cost3, cost2, cost1] (it reverses the
    aggregation's list), with BatchNorms on batch statistics."""
    port, (left, right), want = _whole("psmnet", train=True)
    port.train()
    with torch.no_grad():
        got = port(left, right)
    assert len(got) == len(want) == 3
    for g, wv in zip(got, want):
        assert tuple(g.shape) == (1, 256, 256)
        err = np.abs(g.numpy() - np.asarray(wv))
        assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())
    # the heads differ, so the order is checked, not only the values
    assert float((got[0] - got[2]).abs().max()) > 1e-2
