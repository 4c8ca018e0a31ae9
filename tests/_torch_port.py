"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
random flax variables made from a numpy seed, carried into the port's
modules through ``aanet_torch.convert``, and layout changes at the
JAX (NHWC) / port (NCHW) boundary."""
import numpy as np
import torch

import jax

from aanet_torch.convert import state_dict_from_flax


def _map_leaves(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, np.asarray(tree))


def randomize(variables, seed):
    """Every leaf of a flax init drawn anew from ``RandomState(seed)``.

    The fresh init has zero ``offset_conv`` weights (every deformable conv a
    plain dilated conv) and zero ZeroNorm scales (every residual branch
    dead); here both are non-zero. Offsets come out at about a pixel.
    """
    rs = np.random.RandomState(seed)

    def param(path, a):
        name = path[-1]
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            std = (0.5 if "offset_conv" in path else 1.0) / np.sqrt(fan_in)
            return (rs.randn(*a.shape) * std).astype(np.float32)
        if name == "scale":
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rs.randn(*a.shape) * 0.1).astype(np.float32)  # biases

    def stat(path, a):
        if path[-1] == "var":
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rs.randn(*a.shape) * 0.1).astype(np.float32)

    variables = jax.device_get(variables)
    out = {"params": _map_leaves(variables["params"], param)}
    if "batch_stats" in variables:
        out["batch_stats"] = _map_leaves(variables["batch_stats"], stat)
    return out


def random_variables(init, seed):
    """Variables of ``init``'s shapes drawn by ``randomize`` (no init run)."""
    shapes = jax.eval_shape(init)
    return randomize(jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), shapes), seed)


def calibrate_bn_(model, left, right):
    """Set each BatchNorm's running statistics to its input's on this pair,
    so that a random network's activations stay near unit scale."""
    def hook(mod, inputs):
        mod.running_mean.copy_(inputs[0].mean((0, 2, 3)))
        mod.running_var.copy_(inputs[0].var((0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        model(left, right)
    for handle in handles:
        handle.remove()


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load flax ``variables`` into the port's ``module`` (strict) in eval mode."""
    state = state_dict_from_flax(variables["params"], variables.get("batch_stats", {}))
    module.load_state_dict(state, strict=True)
    return module.eval()


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def rel_stats_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / (np.abs(b) + 1.0)).max())


def compare_train_step(jax_cfg, cfg, hw, batch_size, seed=13, lr=1e-3, wd=1e-4, nudges=0):
    """One train step of the JAX package's ``jax_cfg`` (remat off) and of
    the port's ``cfg`` (remat as given) from the same randomised variables
    (carried across with strict loads) on a numpy-seeded batch; asserts
    the loss and the update norm within rtol 1e-4, every parameter within
    the per-leaf bounds below, and the BatchNorm statistics within 2e-4.
    With ``nudges`` the JAX step also runs that many times on the batch
    with its left images changed by 1e-6 relative, and the entries the
    port may move by more than 1 % of an update are bounded by twice the
    most that the JAX step moves so. Returns the port's metrics."""
    import dataclasses

    import jax.numpy as jnp

    from aanet_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from aanet_tpu.train.state import TrainState
    from aanet_tpu.train.trainer import make_train_step as jax_make_train_step
    from aanet_torch.convert import flax_from_state_dict
    from aanet_torch.train.optimizer import make_optimizer
    from aanet_torch.train.trainer import make_train_step

    h, w = hw
    jmodel = dataclasses.replace(jax_cfg, remat=False).build()
    zeros = jnp.zeros((1, h, w, 3))
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), zeros, zeros, train=False), seed)
    rs = np.random.RandomState(seed)
    batch = dict(
        left=rs.randn(batch_size, h, w, 3).astype(np.float32),
        right=rs.randn(batch_size, h, w, 3).astype(np.float32),
        disp=rs.uniform(0, 0.8 * cfg.max_disp, (batch_size, h, w)).astype(np.float32),
    )
    jax_step = jax_make_train_step(jmodel, cfg.max_disp)
    tx = jax_make_optimizer(variables["params"], lr, weight_decay=wd)  # one: the step's jit key

    def jax_run(images):
        state = TrainState.create(  # anew each time: the step donates it
            apply_fn=jmodel.apply, params=variables["params"],
            batch_stats=variables["batch_stats"], tx=tx,
        )
        return jax_step(state, {k: jnp.asarray(v) for k, v in dict(batch, **images).items()})

    new_state, want = jax_run({})
    nudged = []  # the JAX step's parameters under 1e-6 input changes
    for k in range(nudges):
        noise = np.random.RandomState(seed + 1 + k).randn(*batch["left"].shape)
        nudged.append(jax.tree.leaves(jax.device_get(
            jax_run({"left": batch["left"] * (1 + 1e-6 * noise)})[0].params)))

    port = load_flax(cfg.build(), variables)
    step = make_train_step(port, make_optimizer(port, lr, weight_decay=wd), cfg.max_disp)
    got = step(dict(left=nchw(batch["left"]), right=nchw(batch["right"]),
                    disp=torch.from_numpy(batch["disp"])))

    np.testing.assert_allclose(float(got["total_loss"]), float(want["total_loss"]), rtol=1e-4)
    params, stats = flax_from_state_dict(port.state_dict())
    paths = jax.tree_util.tree_flatten_with_path(jax.device_get(new_state.params))[0]
    p0 = jax.tree.leaves(variables["params"])
    got_leaves = jax.tree.leaves(params)
    want_leaves = [np.asarray(v) for _, v in paths]
    assert len(got_leaves) == len(want_leaves) == len(p0)
    norm = lambda leaves: float(np.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(leaves, p0))))  # noqa: E731
    np.testing.assert_allclose(norm(got_leaves), norm(want_leaves), rtol=1e-4)
    # per leaf, as tests/test_torch_train.py:250-263: a step-1 Adam update
    # is +-lr for any gradient well above eps, so no entry may differ by
    # more than two updates. Entries off by more than 1 % of an update are
    # gradients near their rounding size, whose sign can flip. In these
    # networks they are many more than in the aanet step (0.1 % there):
    # the JAX step alone flips 0.075 % (GC-Net) to 0.24 % (PSMNet) of its
    # entries under a 1e-6 change of its input, in the leaves where the
    # port's flips lie (the deepest 3-D levels, whose BatchNorms see few
    # values, and PSMNet's SPP fusion), and the port, which rounds
    # differently at every layer, flips 0.10 % (StereoNet) to 0.31 %
    # (PSMNet). They stay under 0.5 % of the model.
    off = total = 0
    for (path, _), a, b in zip(paths, got_leaves, want_leaves):
        diff = np.abs(a - b)
        assert diff.max() <= 2.2 * lr, "/".join(str(getattr(k, "key", k)) for k in path)
        off += int((diff > 0.01 * lr).sum())
        total += diff.size
    # in the convs of GANet's UNet (extractor and hourglass) the JAX step
    # alone moves 0.76 % (ganet-aa) to 2.78 % (aanet+) of all entries by
    # more than 1 % of an update under a 1e-6 change of its input (96x192,
    # batch 2; 1.03 % for ganet-aa at 192x384), the port as many
    flips = [sum(int((np.abs(np.asarray(a) - b) > 0.01 * lr).sum())
                 for a, b in zip(leaves, want_leaves)) for leaves in nudged]
    assert off <= max([5e-3 * total] + [2 * n for n in flips]), (off, total, flips)
    want_stats = jax.tree_util.tree_flatten_with_path(jax.device_get(new_state.batch_stats))[0]
    got_stats = jax.tree.leaves(stats)
    assert len(got_stats) == len(want_stats)
    for (path, leaf), got_stat in zip(want_stats, got_stats):
        assert rel_stats_err(got_stat, leaf) < 2e-4, path
    return got


def check_psmnet_train_step(aggregation, maps):
    """One train step of the PSMNet baseline with ``aggregation`` against
    the JAX package's (``compare_train_step``) at 256x256 (its SPP pools
    64-px windows at H/4), max_disp 64, batch 1; the loss must get
    ``maps`` disparity maps, a length ``PYRAMID_WEIGHTS`` has weights for."""
    from unittest import mock

    from aanet_tpu.config import ModelConfig as JaxModelConfig
    from aanet_torch.config import ModelConfig
    from aanet_torch.train import loss, trainer

    flags = dict(feature_type="psmnet", feature_similarity="concat", refinement_type="None",
                 aggregation_type=aggregation, max_disp=64)
    with mock.patch.object(trainer, "pyramid_loss", wraps=loss.pyramid_loss) as spy:
        metrics = compare_train_step(JaxModelConfig(**flags), ModelConfig(**flags), (256, 256), 1)
    assert len(spy.call_args.args[0]) == maps
    assert float(metrics["total_loss"]) > 0


def output_rounding_hooks(model):
    """Forward hooks that round each conv's, BatchNorm's and deformable
    conv's output to bf16 values (the offset heads' excepted): with no
    compute dtype installed, the rounding control of the bf16 tests,
    layers that compute in float32 and round only their outputs."""
    from aanet_torch.models.layers import ConvTranspose, DeformConv2dLayer, Norm

    names = {m: n for n, m in model.named_modules()}
    kinds = (torch.nn.Conv2d, ConvTranspose, Norm, DeformConv2dLayer)
    return [m.register_forward_hook(lambda mod, inputs, out: out.to(torch.bfloat16).float())
            for m in model.modules() if isinstance(m, kinds) and "offset" not in names[m]]
