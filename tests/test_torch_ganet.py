"""AANet+'s modules in the PyTorch port against the JAX package, on the
CPU, with randomised weights carried across by ``aanet_torch.convert``
(strict loads): ``BasicConv`` and each ``Conv2x`` branch, GANet's
extractor with and without deformable convs, the hourglass refinement in
eval and in training (remat on: its BatchNorm statistics move once), and
the ``ganet-aa`` and ``aanet+`` pyramids whole (their train steps:
test_torch_aanetplus_train.py). Also the eight training recipes against
the JAX package's, and an ``aanet+`` flax tree through the port's
checkpoint reader.

Tolerances: the modules within 2e-3 of the output's largest value; the
pyramids within 5e-2 px max and 5e-3 px mean (tests/test_parity_torch.py:
13-16), with every BatchNorm's statistics calibrated on the pair (as
tests/test_torch_aa_presets.py). Sizes: the modules at 48x96 (GANet's
UNet needs H/3 and W/3 multiples of 16, the hourglass H and W), the
pyramids at 96x192 (``aanet+`` pads to multiples of 96) with max_disp 48,
cut to 2 fusions with 1 deformable.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aanet_tpu import config as jax_config
from aanet_tpu.models import feature as jfeat
from aanet_tpu.models import layers as jlayers
from aanet_tpu.models import refinement as jref
from aanet_torch import config
from aanet_torch.convert import flax_from_state_dict
from aanet_torch.models import feature, layers, refinement
from aanet_torch.ops import KERNEL_OPS
from aanet_torch.utils import checkpoint

from _torch_port import calibrate_bn_, load_flax, nchw, nhwc, random_variables, rel_stats_err

CUT = dict(num_fusions=2, num_deform_blocks=1)
# name -> the pyramid's scales as divisors of H and W
PRESETS = {"aanet+": (12, 6, 3, 2, 1), "ganet-aa": (3, 2, 1)}
MAX_DISP, HW = 48, (96, 192)


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


@pytest.mark.parametrize("deconv", [False, True], ids=["conv", "deconv"])
def test_basic_conv_matches_flax(deconv):
    """A 3x3 stride-2 conv, or a 4x4 stride-2 transposed conv (output
    exactly twice the input), then BatchNorm and ReLU."""
    x = rng(2, 12, 20, 24, seed=1)
    k = 4 if deconv else 3
    jmod = jlayers.BasicConv(16, k, 2, 1, deconv=deconv)
    variables, want = _flax(jmod, jnp.asarray(x), seed=2, train=False)
    port = load_flax(layers.BasicConv(24, 16, k, 2, 1, deconv=deconv), variables)
    with torch.no_grad():
        got = port(nchw(x))
    assert tuple(got.shape[2:]) == ((24, 40) if deconv else (6, 10))
    close(nhwc(got), want)


CONV2X = {  # branch -> (cin, features, Conv2x flags, input and skip sizes)
    "down": (16, 24, dict(), (12, 20), (6, 10)),
    "up": (24, 16, dict(deconv=True), (6, 10), (12, 20)),
    "mdconv": (16, 24, dict(mdconv=True), (12, 20), (6, 10)),
    "sum": (16, 24, dict(concat=False), (12, 20), (6, 10)),
}


@pytest.mark.parametrize("branch", sorted(CONV2X))
def test_conv2x_matches_flax(branch):
    cin, features, flags, (h, w), (rh, rw) = CONV2X[branch]
    x, rem = rng(2, h, w, cin, seed=3), rng(2, rh, rw, features, seed=4)
    jmod = jlayers.Conv2x(features, **flags)
    variables, want = _flax(jmod, jnp.asarray(x), jnp.asarray(rem), seed=5, train=False)
    port = load_flax(layers.Conv2x(cin, features, **flags), variables)
    with torch.no_grad():
        got = port(nchw(x), nchw(rem))
    close(nhwc(got), want)
    with pytest.raises(AssertionError):  # the skip must have the output's shape
        port(nchw(x), nchw(rem)[:, :, :-1])


@pytest.mark.parametrize("mdconv", [True, False], ids=["mdconv", "no_mdconv"])
def test_ganet_feature_matches_flax(mdconv):
    """32 channels at H/3 through the 5x5 stride-3 conv and the UNet; with
    ``feature_mdconv`` five deformable convs (the stem's third layer, the
    two deepest downsamplings, two Conv2x merges)."""
    x = rng(2, 48, 96, 3, seed=6)
    variables, want = _flax(jfeat.GANetFeature(feature_mdconv=mdconv), jnp.asarray(x), seed=7,
                            train=False)
    port = load_flax(feature.GANetFeature(feature_mdconv=mdconv), variables)
    deform = [m for m in port.modules() if isinstance(m, layers.DeformConv2dLayer)]
    assert len(deform) == (5 if mdconv else 0)
    with torch.no_grad():
        got = port(nchw(x))
    assert tuple(got.shape) == (2, 32, 16, 32)
    close(nhwc(got), want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_hourglass_refinement_matches_flax(train):
    """The refined map at full resolution from a half-resolution one; in
    training (remat on) with batch statistics, which move once per forward
    although backward recomputes each block, as flax's do."""
    h, w = 48, 96
    low = np.abs(rng(2, h // 2, w // 2, seed=8)) * 4
    left, right = rng(2, h, w, 3, seed=9), rng(2, h, w, 3, seed=10)
    jmod = jref.HourglassRefinement(remat=True)
    inputs = [jnp.asarray(a) for a in (low, left, right)]
    variables = random_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), *inputs, train=False), 11)
    port = load_flax(refinement.HourglassRefinement(remat=True), variables)
    assert len([m for m in port.modules() if isinstance(m, layers.DeformConv2dLayer)]) == 5
    args = (torch.from_numpy(low), nchw(left), nchw(right))
    if not train:
        want = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(variables, *inputs)
        with torch.no_grad():
            got = port(*args)
        close(got.numpy(), want)
        return
    want, new_vars = jax.jit(lambda v, *a: jmod.apply(v, *a, train=True, mutable=["batch_stats"]))(
        variables, *inputs)
    port.train()
    got = port(*args)
    got.sum().backward()  # the checkpointed blocks run again here
    close(got.detach().numpy(), want)
    _, stats = flax_from_state_dict(port.state_dict())
    want_stats = jax.tree_util.tree_flatten_with_path(jax.device_get(new_vars["batch_stats"]))[0]
    got_stats = jax.tree.leaves(stats)
    assert len(got_stats) == len(want_stats) == 2 * 26  # 26 BatchNorms, mean and var
    for (path, leaf), got_stat in zip(want_stats, got_stats):
        assert rel_stats_err(got_stat, leaf) < 2e-4, path


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_pyramid_matches_jax(name):
    """The ``aanet+`` pyramid of five maps (hourglass refinements) and the
    ``ganet-aa`` pyramid of three (one aggregated volume, StereoDRNet
    refinements), both on GANet's deformable features."""
    (h, w), scales = HW, PRESETS[name]
    jmodel = dataclasses.replace(jax_config.preset(name), max_disp=MAX_DISP, **CUT).build()
    rs = np.random.RandomState(21)
    left, right = (rs.randn(1, h, w, 3).astype(np.float32) for _ in range(2))
    zeros = jnp.zeros((1, h, w, 3))
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), zeros, zeros, train=False), 22)
    port = load_flax(
        dataclasses.replace(config.preset(name), max_disp=MAX_DISP, **CUT).build(), variables)
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


@pytest.mark.parametrize("name", sorted(jax_config.RUN_RECIPES))
def test_recipe_equals_jax_recipe(name):
    """Every field of the port's recipe as the JAX package's, the
    summaries' frequency included, but the pretrained weights' suffix (the
    port's stages hand on torch files)."""
    got, want = dataclasses.asdict(config.recipe(name)), dataclasses.asdict(jax_config.recipe(name))
    assert sorted(config.RUN_RECIPES) == sorted(jax_config.RUN_RECIPES)
    if want["train"]["pretrained"]:
        want["train"]["pretrained"] = want["train"]["pretrained"].replace(".msgpack", ".pt")
    assert got["train"]["summary_freq"] == want["train"]["summary_freq"] == 100
    got["train"]["milestones"] = tuple(got["train"]["milestones"])
    want["train"]["milestones"] = tuple(want["train"]["milestones"])
    assert got == want


def test_aanetplus_flax_tree_round_trips_through_the_reader(tmp_path):
    """An ``aanet+`` checkpoint as the JAX package writes it, read by the
    port's numpy-only reader into the port's model through ``load_model``
    (strict): every leaf comes back equal, in flax's paths."""
    from aanet_tpu.utils.checkpoint import save_checkpoint
    from aanet_torch.infer import load_model

    cfg = dataclasses.replace(config.preset("aanet+"), max_disp=MAX_DISP, **CUT)
    jmodel = dataclasses.replace(jax_config.preset("aanet+"), max_disp=MAX_DISP, **CUT).build()
    zeros = jnp.zeros((1, 96, 96, 3))
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), zeros, zeros, train=False), 23)
    path = save_checkpoint(str(tmp_path), "aanet_best", params=variables["params"],
                           batch_stats=variables["batch_stats"], step=3, epoch=1, epe=1.5,
                           best_epe=1.5, best_epoch=1)
    assert checkpoint.read_metadata(path)["epoch"] == 1
    model = load_model(cfg, path, device="cpu", strict=True)
    params, batch_stats = flax_from_state_dict(model.state_dict())
    for tree, want in ((params, variables["params"]), (batch_stats, variables["batch_stats"])):
        got_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (p, g), (_, wv) in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(g, np.asarray(wv), err_msg=str(p))
