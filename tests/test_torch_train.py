"""The PyTorch port's training path against the JAX package's, on the CPU:
the loss, the metrics, one optimizer update with its two learning-rate
groups and the schedule, BatchNorm in training mode, and one full train
step of the ``aanet`` preset (cut to max_disp 48, 2 fusions, 1 deformable
block, 48x96, batch 2) at gradient accumulation 1 and 2.

Inputs are made with numpy from a seed; the weights (the fresh flax init
for the step) are carried across by ``aanet_torch.convert``. Tolerances: loss and update norm rtol 1e-4 (as
tests/test_parity_torch.py:253-257); BatchNorm statistics 2e-4 relative
to |value| + 1 for means and variances alike (the port stores flax's
biased variance); per-leaf parameters as stated in the test.
"""
import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from aanet_tpu.config import preset as jax_preset
from aanet_tpu.train import loss as jloss
from aanet_tpu.train import metrics as jmetrics
from aanet_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from aanet_tpu.train.state import TrainState
from aanet_tpu.train.trainer import make_train_step as jax_make_train_step
from aanet_torch.config import preset
from aanet_torch.convert import flax_from_state_dict
from aanet_torch.models import aggregation, layers
from aanet_torch.train import loss, metrics
from aanet_torch.train.optimizer import make_optimizer, piecewise_constant_schedule, set_learning_rate
from aanet_torch.train.trainer import make_train_step

from _torch_port import load_flax, nchw, rel_stats_err

CUT = dict(max_disp=48, num_fusions=2, num_deform_blocks=1)


def rng(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------
# loss, metrics, optimizer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("highest_loss_only,pseudo", [(False, False), (False, True), (True, True)])
def test_pyramid_loss_matches_jax(highest_loss_only, pseudo):
    h, w, b = 24, 48, 2
    sizes = [(h // 12, w // 12), (h // 6, w // 6), (h // 3, w // 3), (h // 2, w // 2), (h, w)]
    pyramid = [np.abs(rng(b, *hw, seed=i, scale=8.0)) for i, hw in enumerate(sizes)]
    gt = np.random.RandomState(9).uniform(-2, 30, (b, h, w)).astype(np.float32)
    pseudo_gt = np.random.RandomState(10).uniform(-2, 30, (b, h, w)).astype(np.float32)
    jmask = jmetrics.validity_mask(jnp.asarray(gt), 24)
    jp_mask = jmetrics.validity_mask(jnp.asarray(pseudo_gt), 24) & ~jmask if pseudo else None
    want, waux = jloss.pyramid_loss(
        [jnp.asarray(p) for p in pyramid], jnp.asarray(gt), jmask,
        pseudo_gt_disp=jnp.asarray(pseudo_gt) if pseudo else None, pseudo_mask=jp_mask,
        highest_loss_only=highest_loss_only,
    )
    mask = metrics.validity_mask(torch.from_numpy(gt), 24)
    p_mask = metrics.validity_mask(torch.from_numpy(pseudo_gt), 24) & ~mask if pseudo else None
    got, aux = loss.pyramid_loss(
        [torch.from_numpy(p) for p in pyramid], torch.from_numpy(gt), mask,
        pseudo_gt_disp=torch.from_numpy(pseudo_gt) if pseudo else None, pseudo_mask=p_mask,
        highest_loss_only=highest_loss_only,
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose([float(x) for x in aux["pyramid_losses"]],
                               [float(x) for x in waux["pyramid_losses"]], rtol=1e-5)


def test_all_metrics_match_jax():
    pred = np.abs(rng(2, 16, 20, seed=1, scale=10.0))
    gt = np.random.RandomState(2).uniform(-1, 25, (2, 16, 20)).astype(np.float32)
    want = jmetrics.all_metrics(jnp.asarray(pred), jnp.asarray(gt), jmetrics.validity_mask(jnp.asarray(gt), 20))
    got = metrics.all_metrics(torch.from_numpy(pred), torch.from_numpy(gt),
                              metrics.validity_mask(torch.from_numpy(gt), 20))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_optimizer_steps_match_optax_across_the_schedule_boundary():
    """Three updates with the same gradients: an offset_conv group at 0.1x
    LR, weight decay added to the gradient, and the LR halved from update
    2 on (boundary 2), against the JAX optimizer and optax's schedule."""
    import optax

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 4, 3)
            self.offset_conv = torch.nn.Conv2d(4, 2, 1)

    model = Tiny()
    params = {name: p.detach().numpy().copy() for name, p in model.named_parameters()}
    tree = {"conv": {"kernel": params["conv.weight"], "bias": params["conv.bias"]},
            "offset_conv": {"kernel": params["offset_conv.weight"], "bias": params["offset_conv.bias"]}}
    key = {"conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
           "offset_conv.weight": ("offset_conv", "kernel"), "offset_conv.bias": ("offset_conv", "bias")}
    lr, boundaries = 1e-2, {2: 0.5}
    tx = jax_make_optimizer(tree, optax.piecewise_constant_schedule(lr, boundaries), weight_decay=1e-2)
    jtree = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(jtree)
    opt = make_optimizer(model, lr, weight_decay=1e-2)
    schedule = piecewise_constant_schedule(lr, boundaries)
    assert [schedule(s) for s in range(4)] == [lr, lr, lr / 2, lr / 2]
    for step in range(3):
        grads = {n: rng(*p.shape, seed=10 * step + i) for i, (n, p) in enumerate(params.items())}
        jgrads = {m: {} for m in tree}
        for n, g in grads.items():
            jgrads[key[n][0]][key[n][1]] = jnp.asarray(g)
        updates, opt_state = tx.update(jgrads, opt_state, jtree)
        jtree = optax.apply_updates(jtree, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        set_learning_rate(opt, schedule(step))
        opt.step()
        for n, p in model.named_parameters():
            # 1e-6 is 1e-4 of an update (lr 1e-2): the two Adams round
            # their float32 bias corrections in different orders
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jtree[key[n][0]][key[n][1]]),
                                       rtol=0, atol=1e-6, err_msg=f"{n} after update {step}")


# --------------------------------------------------------------------------
# BatchNorm in training mode
# --------------------------------------------------------------------------


def test_norm_train_mode_matches_flax_batchnorm():
    x = rng(4, 6, 3, 5, seed=1, scale=2.0) + 1.0
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = bn.init(jax.random.PRNGKey(0), xj)
    scale, bias = rng(6, seed=2) + 1.0, rng(6, seed=3)
    mean0, var0 = rng(6, seed=4), np.abs(rng(6, seed=5)) + 0.5
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    want, mutated = bn.apply(variables, xj, mutable=["batch_stats"])
    norm = layers.Norm(6)
    with torch.no_grad():
        norm.BatchNorm_0.weight.copy_(torch.from_numpy(scale))
        norm.BatchNorm_0.bias.copy_(torch.from_numpy(bias))
        norm.BatchNorm_0.running_mean.copy_(torch.from_numpy(mean0))
        norm.BatchNorm_0.running_var.copy_(torch.from_numpy(var0))
    got = norm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-5)
    stats = mutated["batch_stats"]
    assert rel_stats_err(norm.BatchNorm_0.running_mean, stats["mean"]) < 2e-6
    # the biased variance: torch's own update (unbiased) would scale the
    # batch term by n/(n-1) = 60/59 and miss by about 1e-3
    assert rel_stats_err(norm.BatchNorm_0.running_var, stats["var"]) < 2e-6
    # frozen: the running statistics normalise and stay
    frozen = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    want_frozen = frozen.apply({"params": variables["params"], "batch_stats": stats}, xj)
    layers.set_train_mode(norm, freeze_bn=True)
    before = norm.BatchNorm_0.running_var.clone()
    got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want_frozen), atol=1e-5)
    assert torch.equal(norm.BatchNorm_0.running_var, before) and norm.training


def test_checkpointed_blocks_update_batchnorm_statistics_once():
    """Per-AAModule checkpointing recomputes every block in backward; the
    statistics after forward + backward equal those of the same step
    without checkpointing, and each moved exactly once."""
    torch.manual_seed(0)
    vols = [torch.from_numpy(rng(2, 16 // 2**s, 8 // 2**s, 16 // 2**s, seed=s)) for s in range(3)]
    runs = []
    for remat in (False, True):
        torch.manual_seed(1)
        agg = aggregation.AdaptiveAggregation(16, num_fusions=2, num_deform_blocks=1, remat=remat).train()
        out = agg(vols)
        sum(o.square().sum() for o in out).backward()
        runs.append(agg)
    plain, checkpointed = (dict(a.named_buffers()) for a in runs)
    for name, value in checkpointed.items():
        if name.endswith("num_batches_tracked"):
            assert int(value) == 1, name
        else:
            torch.testing.assert_close(value, plain[name], rtol=0, atol=1e-6)
    grads = [dict((n, p.grad) for n, p in a.named_parameters()) for a in runs]
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# one full train step against make_train_step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_setup():
    """The JAX model, a fresh init as both packages make it (offset heads
    and ZeroNorm scales at zero: every deformable sample on the grid, where
    jnp.clip's half gradient applies) and a seeded batch. The init is the
    port's, carried to flax trees by ``flax_from_state_dict``, which the
    step test thereby holds against the JAX model's own tree layout."""
    h, w, b = 48, 96, 2
    jmodel = dataclasses.replace(jax_preset("aanet"), **CUT, remat=False).build()
    torch.manual_seed(0)
    params, stats = flax_from_state_dict(dataclasses.replace(preset("aanet"), **CUT).build().state_dict())
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
                                                jnp.zeros((1, h, w, 3)), train=False))
    assert jax.tree.map(np.shape, {"params": params, "batch_stats": stats}) == jax.tree.map(
        lambda x: tuple(x.shape), dict(shapes))
    rs = np.random.RandomState(0)
    batch = dict(
        left=rs.randn(b, h, w, 3).astype(np.float32),
        right=rs.randn(b, h, w, 3).astype(np.float32),
        disp=rs.uniform(0, 40, (b, h, w)).astype(np.float32),
    )
    return jmodel, {"params": params, "batch_stats": stats}, batch


@pytest.mark.parametrize("accumulation", [1, 2])
def test_train_step_matches_jax(step_setup, accumulation):
    jmodel, variables, batch = step_setup
    lr, wd = 1e-3, 1e-4
    state = TrainState.create(
        apply_fn=jmodel.apply, params=variables["params"], batch_stats=variables["batch_stats"],
        tx=jax_make_optimizer(variables["params"], lr, weight_decay=wd),
    )
    jstep = jax_make_train_step(jmodel, 48, accumulation_steps=accumulation)
    new_state, jmetrics_ = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})

    port = load_flax(dataclasses.replace(preset("aanet"), **CUT).build(), variables)  # remat on
    opt = make_optimizer(port, lr, weight_decay=wd)
    step = make_train_step(port, opt, 48, accumulation_steps=accumulation)
    got = step(dict(left=nchw(batch["left"]), right=nchw(batch["right"]), disp=torch.from_numpy(batch["disp"])))

    np.testing.assert_allclose(float(got["total_loss"]), float(jmetrics_["total_loss"]), rtol=1e-4)
    params, stats = flax_from_state_dict(port.state_dict())
    paths = jax.tree_util.tree_flatten_with_path(jax.device_get(new_state.params))[0]
    p0 = jax.tree.leaves(variables["params"])
    got_leaves = jax.tree.leaves(params)
    want_leaves = [np.asarray(v) for _, v in paths]
    assert len(got_leaves) == len(want_leaves) == len(p0)
    norm = lambda leaves: float(np.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(leaves, p0))))  # noqa: E731
    np.testing.assert_allclose(norm(got_leaves), norm(want_leaves), rtol=1e-4)
    # per leaf: the step-1 Adam update is lr * g / (|g| + eps), +-lr for any
    # gradient well above eps, so no entry may differ by more than two
    # updates. Where a gradient is near its rounding size (the ReLU kinks
    # make some gradients move by several % under a 1e-6 change of the
    # input, in the JAX step itself) its sign can flip; entries off by more
    # than 1 % of an update stay under 0.1 % of the model (measured 0.055 %
    # and 0.034 % at accumulation 1 and 2).
    off = total = 0
    for (path, _), a, b in zip(paths, got_leaves, want_leaves):
        diff = np.abs(a - b)
        assert diff.max() <= 2.2 * lr, "/".join(str(getattr(k, "key", k)) for k in path)
        off += int((diff > 0.01 * lr).sum())
        total += diff.size
    assert off <= 1e-3 * total, (off, total)
    for (path, want), got_stat in zip(jax.tree_util.tree_flatten_with_path(jax.device_get(new_state.batch_stats))[0],
                                      jax.tree.leaves(stats)):
        assert rel_stats_err(got_stat, want) < 2e-4, path
