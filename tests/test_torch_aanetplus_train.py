"""One train step of ``aanet+`` and of ``ganet-aa`` in the PyTorch port
against the JAX package's ``make_train_step``, on the CPU, from the same
randomised variables (strict loads), and one of ``aanet+`` under the
kitti15 recipe's fine-tune settings (``freeze_bn``: every BatchNorm on
its running statistics while the rest trains; ``highest_loss_only``). The
pyramids are in test_torch_ganet.py; the steps sit in a file of their own,
as each compiles a JAX train step, so that the test workers spread them.

Tolerances as ``_torch_port.compare_train_step``: loss and update norm
rtol 1e-4, BatchNorm statistics 2e-4, and the entries moved by more than
1 % of an update at most twice as many as the JAX step moves under a 1e-6
change of its input (two such changes): these networks have many
gradients near their rounding size. Sizes: 96x192 (``aanet+`` pads to
multiples of 96), max_disp 48, batch 2, cut to 2 fusions with 1
deformable.
"""
import dataclasses
import functools
from unittest import mock

import pytest
import torch

from aanet_tpu.config import preset as jax_preset
from aanet_tpu.config import recipe as jax_recipe
from aanet_torch.config import preset, recipe
from aanet_torch.ops import BACKWARD_OPS, KERNEL_OPS

from _torch_port import compare_train_step

CUT = dict(max_disp=48, num_fusions=2, num_deform_blocks=1)
HW, BATCH = (96, 192), 2


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


@pytest.mark.parametrize("name", ["aanet+", "ganet-aa"])
def test_train_step_matches_jax(name):
    """Five maps under the loss's pyramid weights (``aanet+``), or three
    (``ganet-aa``)."""
    metrics = compare_train_step(dataclasses.replace(jax_preset(name), **CUT),
                                 dataclasses.replace(preset(name), **CUT), HW, BATCH, nudges=2)
    assert float(metrics["total_loss"]) > 0


def test_aanetplus_kitti15_fine_tune_step_matches_jax():
    """The kitti15 recipe's step: the BatchNorm statistics stay as they
    were (``compare_train_step`` holds them to the JAX step's, which keeps
    them) and only the final map is supervised."""
    from aanet_tpu.train import trainer as jax_trainer
    from aanet_torch.train import trainer

    t, jt = recipe("aanet+_kitti15").train, jax_recipe("aanet+_kitti15").train
    assert t.freeze_bn and t.highest_loss_only and (jt.freeze_bn, jt.highest_loss_only) == (True, True)
    fine_tune = {module: functools.partial(module.make_train_step, freeze_bn=t.freeze_bn,
                                           highest_loss_only=t.highest_loss_only)
                 for module in (jax_trainer, trainer)}
    with mock.patch.object(jax_trainer, "make_train_step", fine_tune[jax_trainer]), \
            mock.patch.object(trainer, "make_train_step", fine_tune[trainer]):
        metrics = compare_train_step(dataclasses.replace(jax_preset("aanet+"), **CUT),
                                     dataclasses.replace(preset("aanet+"), **CUT), HW, BATCH,
                                     nudges=2)
    assert float(metrics["total_loss"]) > 0
