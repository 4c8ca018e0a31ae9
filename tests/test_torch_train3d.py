"""One train step of the PyTorch port's PSMNet baseline with its three
hourglasses against the JAX package's ``make_train_step``, on the CPU,
at 256x256, max_disp 64, batch 1 (``_torch_port.check_psmnet_train_step``).
The basic aggregation is in test_torch_train3d_basic.py, GC-Net, the
StereoNet baseline and ``stereonet-aa`` in test_torch_train3d_small.py:
one file each, so that test workers share the load.

On the CPU the volumes' backward is the plain twin; the CUDA kernels are
held against it bit for bit by chip_smoke.py. Tolerances
(``_torch_port.compare_train_step``): loss and update norm rtol 1e-4,
BatchNorm statistics 2e-4, parameters per leaf as
tests/test_torch_train.py.
"""
import pytest

from aanet_torch.ops import BACKWARD_OPS, KERNEL_OPS

from _torch_port import check_psmnet_train_step


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    yield
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)


@pytest.mark.parametrize("aggregation,maps", [("psmnet_hourglass", 3)])
def test_psmnet_train_step_matches_jax(aggregation, maps):
    check_psmnet_train_step(aggregation, maps)
