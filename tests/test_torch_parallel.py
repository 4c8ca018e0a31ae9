"""Data-parallel training of the port on the CPU, two gloo ranks spawned
once for the module by ``torch.multiprocessing`` (the ``ranks`` fixture,
tests/_torch_parallel_worker.py), against one process and the JAX
package:

* the train loader's shards equal the JAX loader's, index for index;
* a global batch that the world size does not divide raises; ``pad_batch``
  equals the JAX package's;
* ``maybe_init_distributed`` starts nothing without a launcher, and a
  gloo group of one under a launcher's environment;
* a kernel launches under ``torch.cuda.device`` of its tensors' card,
  and tensors of two cards are refused;
* a training ``Norm`` over two ranks against one ``Norm`` on the
  concatenated batch (also at one value a channel on each rank): the
  output, the input gradient, the weight and bias gradients summed over
  the ranks and the running statistics within 1e-5 relative to
  |value| + 1 (the global variance is combined from each rank's, so it is
  not bitwise the two-pass ``var_mean``);
* the cut ``aanet`` train step (test_torch_train.py's ``CUT``, 48x96) over
  two ranks against JAX's ``make_train_step`` on the global batch under a
  two-device data mesh, at global batch 2, accumulation 1 and at global
  batch 4, accumulation 2 (the JAX batch in the port's grouping: global
  microbatch k is the ranks' k-th), with half of one rank's disparities
  beyond max_disp so that the ranks' valid counts differ: loss and update
  norm rtol 1e-4, BatchNorm statistics 2e-4 (test_torch_train.py's
  tolerances), both ranks' parameters and statistics equal bit for bit;
* validation over two ranks, each running its share of
  ``make_val_loader``, on a ragged set with a batch without a valid
  pixel gives the single process's means exactly, and a set that no
  rank ran whole raises;
* the train summary over two ranks: rank 0 draws the global batch's
  panels and histogram, as one process does.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_parallel_worker as worker
from aanet_tpu.config import preset as jax_preset
from aanet_tpu.data.pipeline import make_train_loader as jax_make_train_loader
from aanet_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from aanet_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from aanet_tpu.train.state import TrainState
from aanet_tpu.train.trainer import make_train_step as jax_make_train_step
from aanet_torch.config import preset
from aanet_torch.convert import flax_from_state_dict
from aanet_torch.data.pipeline import make_train_loader
from aanet_torch.models import layers
from aanet_torch.parallel import mesh

from _torch_port import nchw, rel_stats_err
from test_torch_train import CUT


class IndexSet:
    """A dataset whose samples are their own indices."""

    def __len__(self):
        return 23

    def load(self, i, rng):
        return {"index": np.array(int(i)), "draw": np.array(rng.integers(1 << 30))}


@pytest.mark.parametrize("pc", [2, 3])
def test_train_loader_shards_equal_jax(pc):
    for pi in range(pc):
        kw = dict(epoch=3, seed=5, num_workers=1, process_index=pi, process_count=pc)
        got = list(make_train_loader(IndexSet(), 6, **kw))
        want = list(jax_make_train_loader(IndexSet(), 6, **kw))
        assert len(got) == len(want) == len(make_train_loader(IndexSet(), 6, **kw)) > 0
        for g, w in zip(got, want):
            assert g["index"].shape == (6 // pc,)
            np.testing.assert_array_equal(g["index"], w["index"])
            np.testing.assert_array_equal(g["draw"], w["draw"])


def test_global_batch_the_world_size_does_not_divide_raises():
    with pytest.raises(ValueError, match="global batch of 5 .* 2 processes"):
        make_train_loader(IndexSet(), 5, 0, process_index=0, process_count=2)
    with pytest.raises(ValueError, match="global batch of 7 .* 3 processes"):
        mesh.local_batch_size(7, 3)
    assert mesh.local_batch_size(8, 4) == 2


def test_pad_batch_equals_jax():
    from aanet_tpu.parallel.mesh import pad_batch as jax_pad_batch

    rs = np.random.RandomState(4)
    batch = dict(left=rs.randn(3, 4, 5, 3).astype(np.float32),
                 disp=rs.randn(3, 4, 5).astype(np.float32), left_name=["a", "b", "c"])
    for size in (3, 5):
        got, want = mesh.pad_batch(batch, size), jax_pad_batch(batch, size)
        assert list(got) == list(want)
        for k, v in want.items():
            if k == "left_name":
                assert got[k] == v
            else:
                np.testing.assert_array_equal(got[k], v)
                assert got[k].dtype == v.dtype


def test_maybe_init_distributed_under_a_launchers_environment(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert not mesh.maybe_init_distributed("cpu") and not mesh.distributed()
    assert (mesh.rank(), mesh.world_size()) == (0, 1)
    assert mesh.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_device("cuda") == torch.device("cuda", 3)
    assert mesh.local_device("cuda:1") == torch.device("cuda", 1)
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    try:
        assert mesh.maybe_init_distributed("cpu")
        assert mesh.distributed() and torch.distributed.get_backend() == "gloo"
        assert (mesh.rank(), mesh.world_size()) == (0, 1)
        t = torch.arange(5.0)
        assert torch.equal(mesh.sum_over_ranks(t), t)
        assert mesh.gather_objects({"a": 1}) == [{"a": 1}]
    finally:
        mesh.stop_distributed()
    assert not mesh.distributed()


class FakeTensor:
    """What ``_build.check_cuda`` reads of a tensor, on any card."""

    def __init__(self, device):
        self.device, self.dtype = torch.device(device), torch.float32

    def is_contiguous(self):
        return True


def test_kernels_launch_on_their_tensors_card(monkeypatch):
    """A rank's kernels run on its own card: ``check_cuda`` refuses the
    tensors of two cards, and ``_build.launch`` calls the entry point
    under ``torch.cuda.device`` of the index it passes (the entry points'
    last two arguments are the tensors' device index and stream)."""
    from aanet_torch import _build

    args = dict(a=(FakeTensor("cuda:1"), torch.float32), b=(FakeTensor("cuda:1"), torch.float32))
    _build.check_cuda("op", **args)
    with pytest.raises(ValueError, match="b lies on cuda:0 and a on cuda:1"):
        _build.check_cuda("op", a=args["a"], b=(FakeTensor("cuda:0"), torch.float32))
    events = []

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            events.append(("enter", self.index))

        def __exit__(self, *exc):
            events.append(("exit", self.index))

    def entry(*call):
        events.append(("launch", call))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Device)
    lib = types.SimpleNamespace(aanet_op=entry)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    _build.launch("x", "aanet_op", [], 7, 3, "stream")
    assert events == [("enter", 3), ("launch", (7, 3, "stream")), ("exit", 3)]
    with pytest.raises(ValueError, match="device index"):
        _build.launch("x", "aanet_op", [], 7, None, "stream")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks that run the module's jobs."""
    pool = worker.Pool(str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def close(got, want, what):
    err = float(((got - want).abs() / (want.abs() + 1)).max())
    assert err <= 1e-5, (what, err)


@pytest.mark.parametrize("shape", [(4, 6, 3, 5), (2, 5, 1, 1)],
                         ids=["map", "one-value-a-channel-a-rank"])
def test_norm_over_two_ranks_matches_one_process(ranks, shape):
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32) * 2 + 1)
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    norm = layers.Norm(shape[1])
    with torch.no_grad():
        norm.BatchNorm_0.weight.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, shape[1])))
        norm.BatchNorm_0.bias.copy_(torch.from_numpy(rs.randn(shape[1])))
        norm.BatchNorm_0.running_mean.copy_(torch.from_numpy(rs.randn(shape[1])))
        norm.BatchNorm_0.running_var.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, shape[1])))
    state = {k: v.clone() for k, v in norm.state_dict().items()}
    got = ranks.run(dict(kind="norm", x=x, g=g, rows=shape[0] // 2, state=state))
    xs = x.clone().requires_grad_(True)
    out = norm.train()(xs)
    (out * g).sum().backward()
    close(torch.cat([r["out"] for r in got]), out.detach(), "output")
    close(torch.cat([r["x_grad"] for r in got]), xs.grad, "input gradient")
    close(got[0]["weight_grad"] + got[1]["weight_grad"], norm.BatchNorm_0.weight.grad, "weight")
    close(got[0]["bias_grad"] + got[1]["bias_grad"], norm.BatchNorm_0.bias.grad, "bias")
    for name, value in norm.state_dict().items():
        assert torch.equal(got[0]["state"][name], got[1]["state"][name]), name
        if value.is_floating_point():
            close(got[0]["state"][name], value, name)


@pytest.fixture(scope="module")
def jax_cut():
    """The cut JAX model, the port's fresh init as flax trees (as
    test_torch_train.py's ``step_setup``) and the port's state, made once."""
    h, w = 48, 96
    jmodel = dataclasses.replace(jax_preset("aanet"), **CUT, remat=False).build()
    torch.manual_seed(0)
    model = dataclasses.replace(preset("aanet"), **CUT).build()
    params, stats = flax_from_state_dict(model.state_dict())
    return jmodel, {"params": params, "batch_stats": stats}, model.state_dict(), (h, w)


def global_batch(n, hw, seed):
    """n samples; sample 1's disparities half beyond max_disp 48 (its rank
    has fewer valid pixels)."""
    rs = np.random.RandomState(seed)
    h, w = hw
    disp = rs.uniform(0, 40, (n, h, w)).astype(np.float32)
    disp[1, :, : w // 2] = rs.uniform(50, 90, (h, w // 2))
    return dict(left=rs.randn(n, h, w, 3).astype(np.float32),
                right=rs.randn(n, h, w, 3).astype(np.float32), disp=disp)


@pytest.mark.parametrize("batch,accumulation", [(2, 1), (4, 2)])
def test_two_rank_train_step_matches_jax_global_batch(ranks, jax_cut, batch, accumulation):
    jmodel, variables, state_dict, hw = jax_cut
    lr, wd = 1e-3, 1e-4
    data = global_batch(batch, hw, seed=batch)
    # the ranks take samples r::2; global microbatch k holds each rank's
    # k-th, which is rows 2k, 2k + 1 of the JAX batch in this order
    job = ranks.submit(dict(
        kind="train_step", cut=CUT, state=state_dict, lr=lr, wd=wd, max_disp=48,
        accumulation=accumulation,
        batch=dict(left=nchw(data["left"]), right=nchw(data["right"]),
                   disp=torch.from_numpy(data["disp"]))))
    # the JAX step compiles while the ranks run
    data_mesh = make_mesh(data=2)
    state = replicate(TrainState.create(
        apply_fn=jmodel.apply, params=variables["params"], batch_stats=variables["batch_stats"],
        tx=jax_make_optimizer(variables["params"], lr, weight_decay=wd)), data_mesh)
    jstep = jax_make_train_step(jmodel, 48, accumulation_steps=accumulation)
    new_state, jmetrics = jstep(state, shard_batch({k: jnp.asarray(v) for k, v in data.items()},
                                                   data_mesh))
    got = ranks.results(job)
    for name, value in got[0]["state"].items():
        assert torch.equal(value, got[1]["state"][name]), name
    assert got[0]["metrics"] == got[1]["metrics"]

    np.testing.assert_allclose(got[0]["metrics"]["total_loss"], float(jmetrics["total_loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(got[0]["metrics"]["epe"], float(jmetrics["epe"]), rtol=1e-4)
    params, stats = flax_from_state_dict(got[0]["state"])
    paths = jax.tree_util.tree_flatten_with_path(jax.device_get(new_state.params))[0]
    p0 = jax.tree.leaves(variables["params"])
    got_leaves, want_leaves = jax.tree.leaves(params), [np.asarray(v) for _, v in paths]
    assert len(got_leaves) == len(want_leaves) == len(p0)
    norm = lambda leaves: float(np.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(leaves, p0))))  # noqa: E731
    np.testing.assert_allclose(norm(got_leaves), norm(want_leaves), rtol=1e-4)
    # per leaf, as test_torch_train.py: within two Adam updates, and under
    # 0.1 % of the entries off by more than 1 % of one
    off = total = 0
    for (path, _), a, b in zip(paths, got_leaves, want_leaves):
        diff = np.abs(a - b)
        assert diff.max() <= 2.2 * lr, "/".join(str(getattr(k, "key", k)) for k in path)
        off += int((diff > 0.01 * lr).sum())
        total += diff.size
    assert off <= 1e-3 * total, (off, total)
    for (path, want), stat in zip(
            jax.tree_util.tree_flatten_with_path(jax.device_get(new_state.batch_stats))[0],
            jax.tree.leaves(stats)):
        assert rel_stats_err(stat, want) < 2e-4, path


def test_validation_over_two_ranks_equals_one_process(ranks, tmp_path):
    batches = worker.numpy_batches(14, 4, 12, 16, seed=3, invalid=(1,))
    job = dict(kind="validate", max_disp=24, val_batch_size=4, batches=batches,
               checkpoint_dir=str(tmp_path / "ranks"))
    got = ranks.run(job)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = worker.validate_job(0, dict(job, checkpoint_dir=str(tmp_path / "one")))
    finally:
        torch.set_num_threads(threads)
    assert got[0]["means"] == got[1]["means"] == one["means"]
    assert set(one["means"]) >= {"epe", "d1", "thres3"}


def test_train_summary_over_two_ranks_draws_the_global_batch(ranks, tmp_path):
    """Rank 0 draws the summary of the whole global batch: the panels of
    its first sample and the signed-error histogram of every rank's
    share, as one process does of the batch; rank 1 draws nothing."""
    batch = worker.numpy_batches(4, 4, 12, 16, seed=5)[0]
    job = dict(kind="summary", max_disp=24, batch=batch, checkpoint_dir=str(tmp_path / "ranks"))
    got = ranks.run(job)
    one = worker.summary_job(0, dict(job, checkpoint_dir=str(tmp_path / "one")))
    assert got[1] == dict(images={}, hists={})
    assert set(got[0]["hists"]) == set(one["hists"]) == {"train/signed_error"}
    assert got[0]["hists"]["train/signed_error"].size == (batch["disp"] > 0).sum()
    assert set(got[0]["images"]) == set(one["images"])
    for name, values in [*one["hists"].items(), *one["images"].items()]:
        mine = got[0]["hists"].get(name, got[0]["images"].get(name))
        np.testing.assert_allclose(mine, values, rtol=1e-6, atol=1e-6, err_msg=name)


def test_validation_refuses_batches_no_rank_ran(tmp_path):
    """A None is another rank's batch: where no rank ran it (a loader
    split otherwise than the group), validation raises instead of
    averaging a part of the set."""
    from aanet_torch.train.trainer import Trainer

    batches = worker.numpy_batches(6, 4, 12, 16, seed=3)
    job = dict(max_disp=24, val_batch_size=4, batches=batches, checkpoint_dir=str(tmp_path))
    cfg = worker.Config(model=dataclasses.replace(preset("aanet"), max_disp=24),
                        data=worker.DataConfig(val_batch_size=4),
                        train=worker.TrainConfig(checkpoint_dir=str(tmp_path), evaluate_only=True))
    trainer = Trainer(cfg, 1, model=worker.Toy(), device="cpu")
    assert trainer.validate(batches) == worker.validate_job(0, job)["means"]
    with pytest.raises(ValueError, match=r"batches \[0\], not each of the 2 once"):
        trainer.validate([batches[0], None])
