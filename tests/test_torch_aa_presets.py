"""The ``psmnet-aa`` and ``gcnet-aa`` presets of the PyTorch port against
the JAX package, on the CPU, with randomised weights carried across by
``aanet_torch.convert`` (strict loads): the strided ``FeaturePyramid`` and
the single-output adaptive aggregation module by module, and each
preset's pyramid whole (their train steps: test_torch_aa_train.py).

Tolerances: the modules within 2e-3 of the output's largest value; the
pyramids within 5e-2 px max and 5e-3 px mean (tests/test_parity_torch.py:
13-16), with every BatchNorm's statistics calibrated on the pair (as
chip_smoke.py calibrates its seeded networks): uncalibrated, the random
PSMNet features reach magnitudes of ~600, their correlations ~1e5, and the
soft-argmin is then an argmax whose float rounding alone moves single
pixels of the full-resolution map by up to 0.06 px while the features
agree to 2e-6 of their scale. Sizes: ``psmnet-aa`` at
256x256 (its SPP pools 64-px windows at H/4) with max_disp 96, ``gcnet-aa``
at 96x144 with max_disp 48, both cut to 2 fusions with 1 deformable.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aanet_tpu.config import preset as jax_preset
from aanet_tpu.models import aggregation as jagg
from aanet_tpu.models import feature as jfeat
from aanet_torch.config import preset
from aanet_torch.convert import flax_from_state_dict
from aanet_torch.models import aggregation, feature
from aanet_torch.ops import KERNEL_OPS

from _torch_port import calibrate_bn_, load_flax, nchw, nhwc, random_variables

CUT = dict(num_fusions=2, num_deform_blocks=1)
# name -> (max_disp, input size, the pyramid's scales as divisors of H and W)
PRESETS = {"psmnet-aa": (96, (256, 256), (4, 2, 1)), "gcnet-aa": (48, (96, 144), (2, 1))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side of these small CPU runs: the
    test workers share the cores, and torch's default of one thread a core
    slows such runs by tens of times when the workers oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    yield
    assert all(op.launches == 0 for op in KERNEL_OPS)


def rng(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want, rtol=2e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rtol * scale, (err, scale)


def _flax(module, *inputs, seed, **kwargs):
    variables = random_variables(lambda: module.init(jax.random.PRNGKey(0), *inputs, **kwargs), seed)
    return variables, jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *inputs)


def test_feature_pyramid_matches_flax():
    """One scale of 32 channels to three: 32, 64 and 128 channels at
    H, H/2, H/4, with flax's auto-named Conv_0..3 and Norm_0..3."""
    x = rng(2, 24, 40, 32, seed=1)
    variables, want = _flax(jfeat.FeaturePyramid(), jnp.asarray(x), seed=2, train=False)
    port = load_flax(feature.FeaturePyramid(), variables)
    with torch.no_grad():
        got = port(nchw(x))
    assert [tuple(g.shape) for g in got] == [(2, 32, 24, 40), (2, 64, 12, 20), (2, 128, 6, 10)]
    for g, wv in zip(got, want):
        close(nhwc(g), wv)


def test_single_output_aggregation_matches_flax():
    """Without intermediate supervision the last AAModule fuses into the
    finest scale only (no branches 1 and 2, no final_conv_1 or _2): one
    volume at the finest scale, ISA on all three scales in every fusion."""
    max_disp = 24
    vols = [rng(1, 24 // 2**s, 40 // 2**s, max_disp // 2**s, seed=3 + s) for s in range(3)]
    jmod = jagg.AdaptiveAggregation(max_disp=max_disp, intermediate_supervision=False, **CUT)
    variables, want = _flax(jmod, [jnp.asarray(v) for v in vols], seed=6, train=False)
    assert sorted(variables["params"]["fusion_1"]) == sorted(
        k for k in variables["params"]["fusion_0"] if not k.startswith(("fuse_1", "fuse_2")))
    port = load_flax(aggregation.AdaptiveAggregation(max_disp, intermediate_supervision=False,
                                                     **CUT), variables)
    with torch.no_grad():
        got = port([nchw(v) for v in vols])
    assert len(got) == len(want) == 1
    close(nhwc(got[0]), want[0])


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_pyramid_matches_jax(name):
    max_disp, (h, w), scales = PRESETS[name]
    jmodel = dataclasses.replace(jax_preset(name), max_disp=max_disp, **CUT).build()
    rs = np.random.RandomState(21)
    left, right = (rs.randn(1, h, w, 3).astype(np.float32) for _ in range(2))
    zeros = jnp.zeros((1, h, w, 3))
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), zeros, zeros, train=False), 22)
    port = load_flax(dataclasses.replace(preset(name), max_disp=max_disp, **CUT).build(), variables)
    calibrate_bn_(port, nchw(left), nchw(right))
    params, batch_stats = flax_from_state_dict(port.state_dict())
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        {"params": params, "batch_stats": batch_stats}, left, right)
    with torch.no_grad():
        got = port(nchw(left), nchw(right))
    assert [tuple(g.shape) for g in got] == [(1, h // s, w // s) for s in scales]
    assert len(want) == len(got)
    for g, wv in zip(got, want):
        err = np.abs(g.numpy() - np.asarray(wv))
        assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())
