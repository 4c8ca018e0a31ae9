"""One train step of the PyTorch port's PSMNet baseline with the basic
aggregation against the JAX package's ``make_train_step``, on the CPU, as
test_torch_train3d.py does for the hourglass (tolerances there)."""
import pytest

from aanet_torch.ops import BACKWARD_OPS, KERNEL_OPS

from _torch_port import check_psmnet_train_step


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    yield
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)


@pytest.mark.parametrize("aggregation,maps", [("psmnet_basic", 1)])
def test_psmnet_train_step_matches_jax(aggregation, maps):
    check_psmnet_train_step(aggregation, maps)
