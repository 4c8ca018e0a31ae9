"""One train step of the ``psmnet-aa`` and ``gcnet-aa`` presets in the
PyTorch port against the JAX package's ``make_train_step``, on the CPU,
from the same randomised variables (strict loads), and ``gcnet-aa``'s loss,
which has no weights for its pyramid of two maps unless only the final map
is supervised. The pyramids are in test_torch_aa_presets.py; the steps sit
in a file of their own, as each compiles a JAX train step (about a minute
alone), so that the test workers spread them.

Tolerances as ``_torch_port.compare_train_step``: loss and update norm
rtol 1e-4, BatchNorm statistics 2e-4. Sizes: ``psmnet-aa`` at 256x256
(its SPP pools 64-px windows at H/4) with max_disp 96, batch 1;
``gcnet-aa`` at 96x144 with max_disp 48, batch 2; both cut to 2 fusions
with 1 deformable.
"""
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aanet_tpu.config import preset as jax_preset
from aanet_torch.config import preset
from aanet_torch.ops import BACKWARD_OPS, KERNEL_OPS

from _torch_port import compare_train_step

CUT = dict(num_fusions=2, num_deform_blocks=1)
PRESETS = {"psmnet-aa": (96, (256, 256)), "gcnet-aa": (48, (96, 144))}  # max_disp, input size


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
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)


def rng(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_psmnet_aa_train_step_matches_jax():
    max_disp, hw = PRESETS["psmnet-aa"]
    cut = dict(max_disp=max_disp, **CUT)
    metrics = compare_train_step(dataclasses.replace(jax_preset("psmnet-aa"), **cut),
                                 dataclasses.replace(preset("psmnet-aa"), **cut), hw, 1)
    assert float(metrics["total_loss"]) > 0


def test_gcnet_aa_loss_has_no_weights_for_its_pyramid():
    """``gcnet-aa``'s pyramid has two maps, for which the loss has no
    weights (aanet_tpu/train/loss.py:21-26): the JAX step and the port's
    both raise NotImplementedError unless only the last map is supervised."""
    from aanet_tpu.train.loss import pyramid_loss as jax_pyramid_loss
    from aanet_torch.train.loss import pyramid_loss

    maps, gt = [rng(1, 8, 12), rng(1, 16, 24)], np.abs(rng(1, 16, 24))
    mask = gt > 0
    with pytest.raises(NotImplementedError):
        jax_pyramid_loss([jnp.asarray(m) for m in maps], jnp.asarray(gt), jnp.asarray(mask))
    with pytest.raises(NotImplementedError):
        pyramid_loss([torch.from_numpy(m) for m in maps], torch.from_numpy(gt), torch.from_numpy(mask))
    model = dataclasses.replace(preset("gcnet-aa"), max_disp=48, **CUT).build()
    with torch.no_grad():
        assert len(model(torch.zeros(1, 3, 16, 24), torch.zeros(1, 3, 16, 24))) == 2
    total, _ = pyramid_loss([torch.from_numpy(m) for m in maps], torch.from_numpy(gt),
                            torch.from_numpy(mask), highest_loss_only=True)
    want, _ = jax_pyramid_loss([jnp.asarray(m) for m in maps], jnp.asarray(gt), jnp.asarray(mask),
                               highest_loss_only=True)
    np.testing.assert_allclose(float(total), float(want), rtol=1e-6)


def test_gcnet_aa_train_step_with_highest_loss_only_matches_jax():
    from aanet_tpu.train import trainer as jax_trainer
    from aanet_torch.train import trainer

    max_disp, hw = PRESETS["gcnet-aa"]
    cut = dict(max_disp=max_disp, **CUT)
    last_only = {module: functools.partial(module.make_train_step, highest_loss_only=True)
                 for module in (jax_trainer, trainer)}
    with mock.patch.object(jax_trainer, "make_train_step", last_only[jax_trainer]), \
            mock.patch.object(trainer, "make_train_step", last_only[trainer]):
        metrics = compare_train_step(dataclasses.replace(jax_preset("gcnet-aa"), **cut),
                                     dataclasses.replace(preset("gcnet-aa"), **cut), hw, 2)
    assert float(metrics["total_loss"]) > 0
