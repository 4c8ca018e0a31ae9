"""The port's bfloat16 training path against the JAX package's, on the CPU.

The JAX package trains in bf16 by differentiating its bf16 model
(``aanet_tpu/train/trainer.py:94-130``); parameters, BatchNorm statistics
and losses stay float32 (``aanet_tpu/ops/precision.py``). On the CPU the
port's five bf16 backward ops run their plain twins: every value widened
to float32, the float32 twin's arithmetic, each gradient rounded once to
its primal's dtype. Inputs come from numpy seeds; the JAX side runs under
``jax.jit``, as its train step does.

Tolerances, stated with their reasons:
* per backward op, against ``jax.vjp`` of the JAX op on the same bf16
  inputs and output gradient: the gradients' dtypes equal (x, mask,
  weight, features and volume gradients bf16; the offsets' and the
  disparity's float32), each gradient within 2 bf16 ulps of its scale
  (2^(floor(log2 max|ref|) - 7)) and nearer in the mean than a
  float32-then-round control (JAX's float32 vjp on the unrounded float32
  inputs, rounded to the gradient's dtype), which reads 0.5-2 ulps off
  (max) at every op. The correlation's and soft-argmin's gradients came
  out equal to JAX's bit for bit, the warp's within float32 rounding; the
  deformable conv's x gradient reaches 1.25 ulps (max; mean 0.07-0.17
  ulps, the control 0.09-0.19) and its other gradients 1 ulp: the JAX op
  rounds each modulated sample, and its products with the output
  gradient, to bf16, the port does not (ROADMAP.md, "Known behaviours");
* one train step of the cut ``aanet`` (max_disp 48, 2 fusions, 1
  deformable block, 48x96, batch 2) from the fresh init both packages
  make (carried across by ``aanet_torch.convert``), on three seeded
  batches, against ``make_train_step`` with ``dtype="bfloat16"``: the port
  and JAX share most rounding points but not all (the deformable convs,
  the order of the backward's sums), so the port is held to how far bf16
  moves the JAX step from its float32 step on the same batch. The loss
  (root mean square over the batches) and the whole update (root mean
  square over every entry of every batch) within 1.2 times that distance
  (tests/test_torch_bf16.py's stage limit), the update norm within rtol
  1e-4 of JAX's (tests/test_torch_train.py's float32 bound: Adam's first
  update is about +-lr an entry). These cannot tell bf16 from float32:
  the random cut network is chaotic in bf16 (its gradients sit about half
  their norm from float32's), and a float32 step reads about 1.0 on each.
  What tells them apart is the BatchNorm statistics, taken before Adam:
  their mean relative error within 0.85 times JAX's own (the port read
  0.65-0.72; the port's float32 step 1.00 and a rounding control, float32
  layers with bf16-rounded outputs, 1.15-1.18, must both break it), their
  largest within 2 times. The gradients before Adam (JAX's from Adam's
  first moment) are held within 1.5 times, as a guard against gross
  errors: two independent bf16 roundings of a chaotic step sit about
  sqrt(2) times as far apart as either from float32 (the port read
  1.12-1.41 per batch, its float32 step 0.96-1.07). Over nine batches
  the port read 0.99-1.19 times the JAX bf16 step's own distance in the
  updates and its loss 0.08-3.7 times per batch: one batch's loss is too
  noisy to hold alone (ROADMAP.md, "Known behaviours").
The cut ``aanet+`` step is not held here: its JAX steps at 96x192 would
add another two JAX train-step compiles.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from aanet_tpu import ops as jops
from aanet_tpu.config import preset as jax_preset
from aanet_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from aanet_tpu.train.state import TrainState
from aanet_tpu.train.trainer import make_train_step as jax_make_train_step
from aanet_torch import ops
from aanet_torch.config import preset
from aanet_torch.convert import flax_from_state_dict
from aanet_torch.models.layers import Conv, remat
from aanet_torch.ops import cost_volume, deform, softargmin, warp
from aanet_torch.ops.precision import compute_dtype, precision
from aanet_torch.train.optimizer import make_optimizer
from aanet_torch.train.trainer import make_train_step

from _torch_port import load_flax, nchw, output_rounding_hooks

BF16 = torch.bfloat16
CUT = dict(max_disp=48, num_fusions=2, num_deform_blocks=1)
HW, BATCH, SEEDS = (48, 96), 2, (0, 1, 2)
LR, WD, ADAM_B1 = 1e-3, 1e-4, 0.9
# the BatchNorm statistics' mean error, in units of JAX's own bf16-vs-
# float32 distance: the port read 0.65-0.72, its float32 step 1.00, the
# rounding control 1.15-1.18
STATS_MEAN_LIMIT = 0.85


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small CPU runs (the test workers
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    yield
    assert all(op.launches == 0 for op in ops.KERNEL_OPS + ops.BACKWARD_OPS)
    assert all(getattr(op, "launches_bf16", 0) == 0 for op in ops.KERNEL_OPS + ops.BACKWARD_OPS)


def rng(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def jbf(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def ulp(ref):
    """One bf16 ulp at the scale of ``ref``'s largest value."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def check_gradient(got, want, control, what):
    """``got`` (the port's gradient, torch, in the JAX layout) against
    ``want`` (JAX's, the same layout): the same dtype, within 2 bf16 ulps
    of the scale at most, and nearer in the mean than ``control`` (JAX's
    float32 gradient of the unrounded inputs, rounded to the dtype)."""
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (what, got.dtype, want.dtype)
    ref = as_f32(want)
    control = as_f32(jnp.asarray(control).astype(want.dtype))
    port = np.abs(got.float().numpy() - ref)
    off = np.abs(control - ref)
    scale = ulp(ref)
    assert port.max() <= 2 * scale, (what, port.max() / scale)
    assert port.mean() < off.mean(), (what, port.mean() / scale, off.mean() / scale)


def vjp(fn, primals, cotangent):
    """JAX's gradients of ``fn`` at ``primals`` for ``cotangent``, jitted."""
    return jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))(primals, cotangent)


# ---------------------------------------------------------------------------
# The five backward ops' bf16 twins against jax.vjp of the JAX ops in bf16
# (tests/test_torch_bf16.py's forward shapes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("modulated,stride,groups", [(True, 1, 2), (True, 2, 2), (False, 1, 2)])
def test_deform_backward_bf16_matches_jax(modulated, stride, groups):
    """The input/offset/mask gradient and the weight gradient, as the bf16
    op hands them over: x, the mask, the weight and the output gradient
    bf16, the offsets float32."""
    b, h, w, cin, cout, dil = 2, 9, 11, 8, 6, 2
    ho = (h + 2 * dil - (2 * dil + 1)) // stride + 1
    wo = (w + 2 * dil - (2 * dil + 1)) // stride + 1
    x = rng(b, h, w, cin, seed=6)
    weight = rng(3, 3, cin, cout, seed=7, scale=0.2)
    offset = np.random.RandomState(9).uniform(-3, 3, (b, ho, wo, groups * 18)).astype(np.float32)
    mask = np.random.RandomState(10).uniform(0, 2, (b, ho, wo, groups * 9)).astype(np.float32)
    gout = rng(b, ho, wo, cout, seed=11)
    kw = dict(stride=stride, padding=dil, dilation=dil, deformable_groups=groups)

    def op(x, o, wt, *m):
        return jops.modulated_deform_conv2d(x, o, m[0] if m else None, wt, **kw)

    masks = (mask,) if modulated else ()
    want = vjp(op, (jbf(x), jnp.asarray(offset), jbf(weight), *map(jbf, masks)), jbf(gout))
    control = vjp(op, tuple(map(jnp.asarray, (x, offset, weight, *masks))), jnp.asarray(gout))

    t = (nchw(x).to(BF16), nchw(offset), nchw(mask).to(BF16) if modulated else None,
         torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()).to(BF16))
    grad_x, grad_off, grad_mask = deform.modulated_deform_conv2d_backward_data(
        nchw(gout).to(BF16), *t, **kw)
    grad_w = deform.modulated_deform_conv2d_backward_weight(nchw(gout).to(BF16), *t, **kw)
    assert (grad_mask is None) == (not modulated)
    nhwc = lambda g: g.permute(0, 2, 3, 1)  # noqa: E731
    got = [nhwc(grad_x), nhwc(grad_off), grad_w.permute(2, 3, 1, 0)] + (
        [nhwc(grad_mask)] if modulated else [])
    for what, g, w_, c in zip(("x", "offset", "weight", "mask"), got, want, control):
        check_gradient(g, w_, c, what)


@pytest.mark.parametrize("w,d", [(37, 8), (64, 16), (52, 48)])
def test_correlation_backward_bf16_matches_jax(w, d):
    left, right, grad = rng(2, 5, w, 16, seed=1), rng(2, 5, w, 16, seed=2), rng(2, 5, w, d, seed=3)

    def op(a, b):
        return jops.correlation_cost_volume(a, b, d)

    want = vjp(op, (jbf(left), jbf(right)), jbf(grad))
    control = vjp(op, (jnp.asarray(left), jnp.asarray(right)), jnp.asarray(grad))
    got = cost_volume.correlation_cost_volume_backward(
        nchw(grad).to(BF16), nchw(left).to(BF16), nchw(right).to(BF16))
    for what, g, w_, c in zip(("left", "right"), got, want, control):
        check_gradient(g.permute(0, 2, 3, 1), w_, c, what)


@pytest.mark.parametrize("shape", [(2, 6, 7, 24), (2, 5, 7, 1), (3, 3, 5, 37)])
@pytest.mark.parametrize("match_similarity", [True, False])
def test_soft_argmin_backward_bf16_matches_jax(shape, match_similarity):
    """A bf16 volume and the float32 disparity's gradient; one candidate
    (D = 1) passes a zero gradient."""
    cost, grad = rng(*shape, seed=3, scale=3.0), rng(*shape[:3], seed=4)

    def op(c):
        return jops.soft_argmin(c, match_similarity)

    (want,) = vjp(op, (jbf(cost),), jnp.asarray(grad))
    (control,) = vjp(op, (jnp.asarray(cost),), jnp.asarray(grad))
    got = softargmin.soft_argmin_backward(torch.from_numpy(grad), nchw(cost).to(BF16),
                                          match_similarity).permute(0, 2, 3, 1)
    if shape[-1] == 1:
        assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
        assert not got.float().any() and not as_f32(want).any()
    else:
        check_gradient(got, want, control, "cost")


def test_disp_warp_backward_bf16_matches_jax():
    """The float32 disparity's gradient from a bf16 image and a bf16
    gradient of the warped image, with samples on both edges."""
    b, h, w, c = 2, 5, 20, 3
    img, grad = rng(b, h, w, c, seed=4), rng(b, h, w, c, seed=6)
    disp = np.random.RandomState(5).uniform(-6.0, 12.0, (b, h, w)).astype(np.float32)
    disp[0, 0, :4] = [0.0, 1.0, 2.5, -0.25]  # exact and fractional samples at the edge

    def op(image):
        return lambda d: jops.disp_warp(image, d)[0]

    (want,) = vjp(op(jbf(img)), (jnp.asarray(disp),), jbf(grad))
    (control,) = vjp(op(jnp.asarray(img)), (jnp.asarray(disp),), jnp.asarray(grad))
    got = warp.disp_warp_backward(nchw(grad).to(BF16), nchw(img).to(BF16), torch.from_numpy(disp))
    check_gradient(got, want, control, "disp")


# ---------------------------------------------------------------------------
# The policy under remat, and one train step against make_train_step
# ---------------------------------------------------------------------------


class _DtypeProbe(torch.nn.Module):
    """A conv that records the compute dtype each time it runs (forward
    hooks do not fire when backward recomputes a checkpointed block)."""

    def __init__(self):
        super().__init__()
        self.conv = Conv(4, 4, 3, padding=1)
        self.seen = []

    def forward(self, x):
        self.seen.append(compute_dtype())
        return self.conv(x)


def test_remat_recomputes_under_the_compute_dtype():
    """A checkpointed block recomputed in backward (outside the forward's
    ``precision`` scope) runs under the first forward's compute dtype, and
    its gradients are those of the block run without checkpointing."""
    torch.manual_seed(0)
    probe = _DtypeProbe()
    block = torch.nn.Sequential(Conv(4, 4, 3, padding=1), torch.nn.ReLU(), probe)
    x = torch.from_numpy(rng(2, 4, 6, 8, seed=1)).to(BF16)
    grads = []
    for checkpointed in (False, True):
        block.zero_grad()
        with precision(BF16):
            out = remat(block, x) if checkpointed else block(x)
        out.float().square().sum().backward()
        grads.append([p.grad.clone() for p in block.parameters()])
    assert out.dtype == BF16
    assert probe.seen == [BF16] * 3  # the plain forward, the saved one, the recomputed one
    assert all(torch.equal(a, b) and a.dtype == torch.float32 for a, b in zip(*grads))


def _adam_gradients(opt_state, params):
    """The gradients a JAX step fed its optimizer, from Adam's first moment
    after one step: mu = (1 - b1)(g + wd p), the weight decay added to the
    raw gradient first (``aanet_tpu/train/optimizer.py``)."""
    adam = optax.ScaleByAdamState
    mu = next(s.mu for s in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, adam))
              if isinstance(s, adam))
    return [np.asarray(m, np.float64) / (1 - ADAM_B1) - WD * np.asarray(p, np.float64)
            for m, p in zip(jax.tree.leaves(jax.device_get(mu)), jax.tree.leaves(params))]


@pytest.fixture(scope="module")
def steps():
    """One train step of JAX's float32 and bf16 models (remat off; each
    compiled once) and of the port's models (remat on, as the preset has
    it) from the fresh init, on each of ``SEEDS``' batches: per batch
    (loss, updated parameters, BatchNorm statistics, gradients before
    Adam) for "float32", "bfloat16", the port's bf16 step ("port"), and
    two controls that compute in float32: the port's float32 step
    ("port32") and its float32 layers with bf16-rounded outputs
    ("control", ``_torch_port.output_rounding_hooks``); and the port's
    bf16 parameter and gradient dtypes."""
    h, w = HW
    jmodels = {dt: dataclasses.replace(jax_preset("aanet"), **CUT, remat=False, dtype=dt).build()
               for dt in ("float32", "bfloat16")}
    torch.manual_seed(0)
    params, stats = flax_from_state_dict(dataclasses.replace(preset("aanet"), **CUT).build().state_dict())
    variables = {"params": params, "batch_stats": stats}
    tx = jax_make_optimizer(params, LR, weight_decay=WD, b1=ADAM_B1)
    jsteps = {dt: jax_make_train_step(m, CUT["max_disp"]) for dt, m in jmodels.items()}
    runs, dtypes = [], set()
    for seed in SEEDS:
        rs = np.random.RandomState(seed)
        batch = dict(left=rs.randn(BATCH, h, w, 3).astype(np.float32),
                     right=rs.randn(BATCH, h, w, 3).astype(np.float32),
                     disp=rs.uniform(0, 40, (BATCH, h, w)).astype(np.float32))
        run = {}
        for dt, m in jmodels.items():
            state = TrainState.create(apply_fn=m.apply, params=params, batch_stats=stats, tx=tx)
            new, metrics = jsteps[dt](state, {k: jnp.asarray(v) for k, v in batch.items()})
            run[dt] = (float(metrics["total_loss"]), jax.tree.leaves(jax.device_get(new.params)),
                       jax.tree.leaves(jax.device_get(new.batch_stats)),
                       _adam_gradients(new.opt_state, params))
        for name, dtype, rounded in (("port", "bfloat16", False), ("port32", None, False),
                                     ("control", None, True)):
            port = load_flax(dataclasses.replace(preset("aanet"), **CUT, dtype=dtype).build(),
                             variables)
            handles = output_rounding_hooks(port) if rounded else []
            step = make_train_step(port, make_optimizer(port, LR, weight_decay=WD), CUT["max_disp"])
            metrics = step(dict(left=nchw(batch["left"]), right=nchw(batch["right"]),
                                disp=torch.from_numpy(batch["disp"])))
            for handle in handles:
                handle.remove()
            if name == "port":
                dtypes |= {(p.dtype, p.grad.dtype) for p in port.parameters()}
                dtypes |= {(b.dtype, None) for b in port.buffers()}
            new_params, new_stats = flax_from_state_dict(port.state_dict())
            grads, _ = flax_from_state_dict(
                {**port.state_dict(), **{n: p.grad for n, p in port.named_parameters()}})
            run[name] = (float(metrics["total_loss"]), jax.tree.leaves(new_params),
                         jax.tree.leaves(new_stats),
                         [np.asarray(g, np.float64) for g in jax.tree.leaves(grads)])
        runs.append(run)
    return runs, jax.tree.leaves(params), dtypes


def _rms(values):
    return float(np.sqrt(np.mean(np.square(values))))


def test_bf16_train_step_loss_matches_jax(steps):
    runs, _, _ = steps
    port = _rms([r["port"][0] - r["bfloat16"][0] for r in runs])
    own = _rms([r["bfloat16"][0] - r["float32"][0] for r in runs])
    assert own > 0 and port <= 1.2 * own, (port, own)


def test_bf16_train_step_update_matches_jax(steps):
    runs, p0, _ = steps

    def sq(a_leaves, b_leaves):
        return sum(float(((np.asarray(a) - np.asarray(b)) ** 2).sum()) for a, b in zip(a_leaves, b_leaves))

    port = sum(sq(r["port"][1], r["bfloat16"][1]) for r in runs)
    own = sum(sq(r["bfloat16"][1], r["float32"][1]) for r in runs)
    assert own > 0 and port <= 1.2 ** 2 * own, (np.sqrt(port / own),)
    for r in runs:
        assert len(r["port"][1]) == len(r["bfloat16"][1]) == len(p0)
        np.testing.assert_allclose(np.sqrt(sq(r["port"][1], p0)), np.sqrt(sq(r["bfloat16"][1], p0)),
                                   rtol=1e-4)
        # a step-1 Adam update is +-lr for any gradient well above eps
        assert max(float(np.abs(np.asarray(a) - b).max())
                   for a, b in zip(r["port"][1], r["bfloat16"][1])) <= 2.2 * LR


def test_bf16_train_step_gradients_match_jax(steps):
    """The gradients before Adam, all leaves together over the batches: the
    port's bf16 step within 1.5 times JAX's bf16-vs-float32 distance (two
    independent bf16 roundings of a step sit about sqrt(2) times as far
    apart as either from float32). A guard, not a test of bf16: the
    random cut network's bf16 gradients sit about half their norm from
    float32, and a float32 step reads as near as a bf16 one."""
    runs, _, _ = steps

    def sq(a, b):
        return sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))

    port = sum(sq(r["port"][3], r["bfloat16"][3]) for r in runs)
    own = sum(sq(r["bfloat16"][3], r["float32"][3]) for r in runs)
    norm = sum(sq(r["bfloat16"][3], [0 * g for g in r["bfloat16"][3]]) for r in runs)
    assert 0 < own < norm and port <= 1.5 ** 2 * own, (np.sqrt(port / own), np.sqrt(own / norm))


def test_bf16_train_step_batchnorm_matches_jax(steps):
    """The BatchNorm statistics after one step (the forward's, before
    Adam): the mean relative error from JAX's bf16 step within
    ``STATS_MEAN_LIMIT`` of JAX's own bf16-vs-float32 distance, the largest
    within 2 times, nearer than the rounding control; both float32
    controls must break the mean limit."""
    runs, _, _ = steps

    def rel(a_leaves, b_leaves):
        return np.concatenate([(np.abs(np.asarray(a) - np.asarray(b)) / (np.abs(np.asarray(b)) + 1)).ravel()
                               for a, b in zip(a_leaves, b_leaves)])

    for r in runs:
        assert len(r["port"][2]) == len(r["bfloat16"][2]) > 0
        port, own = rel(r["port"][2], r["bfloat16"][2]), rel(r["bfloat16"][2], r["float32"][2])
        assert port.mean() <= STATS_MEAN_LIMIT * own.mean(), (port.mean(), own.mean())
        assert port.max() <= 2 * own.max(), (port.max(), own.max())
        for control in ("port32", "control"):
            off = rel(r[control][2], r["bfloat16"][2])
            assert off.mean() > STATS_MEAN_LIMIT * own.mean(), (control, off.mean() / own.mean())
            assert port.mean() < off.mean(), (control, port.mean(), off.mean())


def test_bf16_train_step_keeps_float32_state(steps):
    """Parameters, their gradients (after the casts' backward) and the
    BatchNorm statistics stay float32 (the step counters int64)."""
    _, _, dtypes = steps
    assert dtypes == {(torch.float32, torch.float32), (torch.float32, None), (torch.int64, None)}
