"""The rank side of tests/test_torch_parallel.py: a gloo group of ranks
(``torch.multiprocessing.spawn``, a ``file://`` rendezvous) on the CPU,
started once by ``Pool``, runs the jobs the test hands it one after
another and saves what each computed for the test to hold against one
process and the JAX package. Imports torch and the port only."""
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from aanet_torch.config import Config, DataConfig, TrainConfig, preset
from aanet_torch.data.pipeline import make_val_loader
from aanet_torch.models import layers
from aanet_torch.train.optimizer import make_optimizer
from aanet_torch.train.trainer import Trainer, make_train_step, to_device


def norm_job(rank, job):
    """A training ``Norm`` on this rank's rows of ``x``; the loss is the
    sum of the output times ``g``'s rows."""
    x, g = job["x"], job["g"]
    rows = slice(rank * job["rows"], (rank + 1) * job["rows"])
    norm = layers.Norm(x.shape[1])
    norm.load_state_dict(job["state"])
    xr = x[rows].clone().requires_grad_(True)
    out = norm.train()(xr)
    (out * g[rows]).sum().backward()
    return dict(out=out.detach(), x_grad=xr.grad, weight_grad=norm.BatchNorm_0.weight.grad,
                bias_grad=norm.BatchNorm_0.bias.grad, state=norm.state_dict())


def train_step_job(rank, job):
    """One step of the cut ``aanet`` model on this rank's share of the
    global batch."""
    model = dataclasses.replace(preset("aanet"), **job["cut"]).build()
    model.load_state_dict(job["state"])
    opt = make_optimizer(model, job["lr"], weight_decay=job["wd"])
    step = make_train_step(model, opt, job["max_disp"], accumulation_steps=job["accumulation"])
    local = {k: v[rank::dist.get_world_size()] for k, v in job["batch"].items()}
    metrics = step(local)
    return dict(metrics={k: float(v) for k, v in metrics.items()}, state=model.state_dict(),
                grads={n: p.grad for n, p in model.named_parameters()})


class Toy(torch.nn.Module):
    """A one-conv disparity network for validation's bookkeeping."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.conv = torch.nn.Conv2d(6, 1, 3, padding=1)

    def forward(self, left, right):
        return [torch.relu(self.conv(torch.cat([left, right], 1)))[:, 0] * 10]


class Samples:
    """Validation batches (``numpy_batches``) as a dataset of their
    samples, which ``make_val_loader`` batches again."""

    def __init__(self, batches):
        self.samples = [{k: v[j] for k, v in b.items()} for b in batches
                        for j in range(len(b["disp"]))]

    def __len__(self):
        return len(self.samples)

    def load(self, i, rng):
        return self.samples[i]


def validate_job(rank, job):
    """``Trainer.validate`` of the toy model over this process's share of
    ``make_val_loader`` (all of it without a group)."""
    cfg = Config(model=dataclasses.replace(preset("aanet"), max_disp=job["max_disp"]),
                 data=DataConfig(val_batch_size=job["val_batch_size"]),
                 train=TrainConfig(checkpoint_dir=job["checkpoint_dir"], evaluate_only=True))
    trainer = Trainer(cfg, 1, model=Toy(), device="cpu")
    loader = make_val_loader(Samples(job["batches"]), job["val_batch_size"], num_workers=1)
    return dict(means=trainer.validate(loader))


class Recorder:
    """A summary writer that keeps the panels and histograms it is handed."""

    def __init__(self):
        self.images, self.hists = {}, {}

    def add_image(self, tag, img, step):
        self.images[tag] = img

    def add_histogram(self, tag, values, step):
        self.hists[tag] = np.asarray(values)


def summary_job(rank, job):
    """``Trainer._train_summary`` of the toy model on this rank's rows of
    the global batch (the ranks' rows in rank order make it up; all of
    it without a group): what rank 0's writer was handed."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg = Config(model=dataclasses.replace(preset("aanet"), max_disp=job["max_disp"]),
                 train=TrainConfig(checkpoint_dir=job["checkpoint_dir"]))
    trainer = Trainer(cfg, 1, model=Toy(), device="cpu")
    recorder = Recorder()
    if trainer.writer is not None:
        trainer.writer.close()
        trainer.writer = recorder
    rows = len(job["batch"]["disp"]) // world
    share = {k: v[rank * rows: (rank + 1) * rows] for k, v in job["batch"].items()}
    trainer._train_summary(to_device(share, trainer.device))
    return dict(images=recorder.images, hists=recorder.hists)


JOBS = dict(norm=norm_job, train_step=train_step_job, validate=validate_job,
            summary=summary_job)


def _save(obj, path):
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def serve(rank, world, work_dir, parent):
    """Join the group, then run ``job<n>.pt`` for n = 0, 1, ... as it
    appears and save ``result<n>_rank<rank>.pt``, until a job is None or
    the test's process is gone."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work_dir}/rendezvous", rank=rank,
                            world_size=world)
    try:
        n = 0
        while True:
            path = os.path.join(work_dir, f"job{n}.pt")
            while not os.path.exists(path):
                if os.getppid() != parent:
                    return
                time.sleep(0.01)
            job = torch.load(path, weights_only=False)
            if job is None:
                return
            _save(JOBS[job["kind"]](rank, job), os.path.join(work_dir, f"result{n}_rank{rank}.pt"))
            n += 1
    finally:
        dist.destroy_process_group()


class Pool:
    """``world`` ranks started once; ``submit(job)`` hands them a job (a
    dict with ``kind``) and returns its number, ``results(n)`` waits for
    job n and returns each rank's result in rank order. The caller may
    work between the two."""

    def __init__(self, work_dir, world=2):
        import torch.multiprocessing as mp

        os.makedirs(work_dir, exist_ok=True)
        self.work_dir, self.world, self.jobs = work_dir, world, 0
        self.context = mp.spawn(serve, args=(world, work_dir, os.getpid()), nprocs=world,
                                join=False)

    def submit(self, job) -> int:
        n, self.jobs = self.jobs, self.jobs + 1
        _save(job, os.path.join(self.work_dir, f"job{n}.pt"))
        return n

    def results(self, n):
        paths = [os.path.join(self.work_dir, f"result{n}_rank{r}.pt") for r in range(self.world)]
        while not all(os.path.exists(p) for p in paths):
            # raises where a rank failed, and stops the others
            if self.context.join(timeout=0.01):
                raise RuntimeError(f"the ranks ended before job {n} was done")
        return [torch.load(p, weights_only=False) for p in paths]

    def run(self, job):
        """``job`` on every rank; each rank's result in rank order."""
        return self.results(self.submit(job))

    def close(self):
        self.submit(None)
        while not self.context.join():
            pass


def numpy_batches(n, bs, h, w, seed, invalid=()):
    """Validation batches of ``n`` samples in batches of ``bs`` (the last
    ragged); the batches of ``invalid`` have no valid pixel."""
    rs = np.random.RandomState(seed)
    out = []
    for i, start in enumerate(range(0, n, bs)):
        k = min(bs, n - start)
        disp = rs.uniform(0, 30, (k, h, w)).astype(np.float32)
        if i in invalid:
            disp[:] = 0
        out.append(dict(left=rs.randn(k, h, w, 3).astype(np.float32),
                        right=rs.randn(k, h, w, 3).astype(np.float32), disp=disp))
    return out
