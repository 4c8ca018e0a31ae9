"""The 4-D cost volumes and the 3-D networks in bfloat16, against the JAX
package on the CPU.

The JAX difference and concat volumes compute in the features' dtype
(``aanet_tpu/ops/cost_volume.py:127,144``); the port's bf16 forms (the
plain twins here, the kernels of ``csrc/volume4d.cu`` on the card) take
bf16 features and give a bf16 volume. Inputs come from numpy seeds; the
JAX side runs under ``jax.jit``. The JAX volumes do not trace at D > W,
so every shape here has D <= W.

Tolerances, stated with their reasons:
* the forward, bit for bit: concat copies the values, difference rounds
  the float32 difference L - R(w - d) to bf16 once, which is what XLA
  computes for a bf16 subtraction;
* the backward: XLA's transpose on the CPU adds the n = min(D, W) slices
  of the volume's gradient in descending d and rounds every partial sum
  to bf16 (n - 1 roundings; ``_xla_order`` reproduces it bit for bit),
  where the port sums in float32 in ascending d and rounds once. Each of
  XLA's roundings is within half an ulp of its partial sum, so the two
  lie within n / 2 bf16 ulps of the largest partial sum's scale
  (2^(floor(log2 max |partial sum|) - 7)); they read up to 3 ulps of
  max|ref| apart at D = 48;
* the StereoNet and PSMNet forwards (random weights carried across by
  ``aanet_torch.convert``, BatchNorms calibrated on the pair) in bf16 at
  their smallest sizes: the layers round as flax's do (the 3-D conv,
  transposed conv and BatchNorm within a few elements of bit for bit,
  tests/test_torch_bf16.py for the 2-D ones), but one flipped rounding
  in a random network spreads to a fifth of the next outputs, so each is
  held to how far bf16 moves the JAX network from its float32 run: the
  aggregation fed the JAX bf16 volume within 1.25 times that distance in
  the mean (the port read 1.10 and 1.18), nearer than a control whose
  layers compute in float32 and round only their outputs (1.33 and 1.35),
  which must break the limit; the final map within 1.25 times in the
  mean and 2 times at most (a guard: the random networks are chaotic,
  PSMNet's bf16 map sits 2.3 px from its float32 one in the mean);
* one bf16 train step of StereoNet (the smallest 3-D network; 48x96,
  max_disp 48, batch 2) from the fresh init both packages make, on three
  seeded batches, against ``make_train_step(dtype="bfloat16")``, held as
  tests/test_torch_bf16_train.py holds the ``aanet`` step: the loss and
  the whole update within 1.2 times JAX's own bf16-vs-float32 distance,
  the BatchNorm statistics' mean relative error within 0.85 times it
  (the port read 0.76-0.79; the port's float32 step 1.00 and the
  rounding control 1.07-1.23 must break it) and their largest within 2
  times.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aanet_tpu.config import ModelConfig as JaxModelConfig
from aanet_tpu import ops as jops
from aanet_tpu.ops.precision import precision as jax_precision
from aanet_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from aanet_tpu.train.state import TrainState
from aanet_tpu.train.trainer import make_train_step as jax_make_train_step
from aanet_torch import ops
from aanet_torch.config import ModelConfig
from aanet_torch.convert import flax_from_state_dict
from aanet_torch.models.layers import ConvTranspose, Norm
from aanet_torch.ops import cost_volume
from aanet_torch.ops.precision import precision
from aanet_torch.train.optimizer import make_optimizer
from aanet_torch.train.trainer import make_train_step

from _torch_port import load_flax, nchw, random_variables

BF16 = torch.bfloat16
VOLUMES = {"difference": (jops.difference_cost_volume, cost_volume.difference_cost_volume,
                          cost_volume.difference_cost_volume_backward),
           "concat": (jops.concat_cost_volume, cost_volume.concat_cost_volume,
                      cost_volume.concat_cost_volume_backward)}
# (B, H, W, C, D): W not a multiple of 4, D = W, D = 1
SHAPES = [(2, 3, 20, 4, 12), (1, 2, 37, 3, 37), (2, 2, 16, 5, 1)]
STEREONET = dict(feature_type="stereonet", feature_similarity="difference",
                 aggregation_type="stereonet", refinement_type="stereonet", max_disp=48)
PSMNET = dict(feature_type="psmnet", feature_similarity="concat",
              aggregation_type="psmnet_hourglass", refinement_type="None", max_disp=64)
# (flags, image size): StereoNet at test_torch_train3d_small.py's size,
# PSMNet at the least its SPP takes
FORWARDS = {"stereonet": (STEREONET, (48, 96)), "psmnet": (PSMNET, (256, 256))}
AGGREGATION_MEAN_LIMIT = 1.25
FINAL_MEAN_LIMIT = 1.25
STATS_MEAN_LIMIT = 0.85
LR, WD, SEEDS = 1e-3, 1e-4, (0, 1, 2)


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
    assert all(op.launches == op.launches_bf16 == 0 for op in ops.KERNEL_OPS + ops.BACKWARD_OPS)


def rng(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def jbf(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def ulp(scale):
    """One bf16 ulp at ``scale`` (> 0)."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def ncdhw_to_ndhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 4, 1)


# ---------------------------------------------------------------------------
# The volumes' bf16 twins against the JAX ops in bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(VOLUMES))
@pytest.mark.parametrize("b,h,w,c,d", SHAPES)
def test_bf16_volume_matches_jax_bit_for_bit(kind, b, h, w, c, d):
    left, right = rng(b, h, w, c, seed=1), rng(b, h, w, c, seed=2)
    jop, op, _ = VOLUMES[kind]
    want = jax.jit(jop, static_argnums=2)(jbf(left), jbf(right), d)
    got = op(nchw(left).to(BF16), nchw(right).to(BF16), d)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(ncdhw_to_ndhwc(got), as_f32(want))


def _slices(kind, grad, c, w):
    """The terms that XLA's transpose adds into dL and dR: per d < min(D,
    W), the volume gradient's slice shifted into place (float64, NHWC)."""
    g = grad.astype(np.float64)  # [B, D, H, W, C']
    for d in range(min(g.shape[1], w)):
        tl, tr = np.zeros(g.shape[:1] + g.shape[2:4] + (c,)), np.zeros(g.shape[:1] + g.shape[2:4] + (c,))
        tl[:, :, d:] = g[:, d, :, d:, :c]
        tr[:, :, : w - d] = g[:, d, :, d:, c:] if kind == "concat" else -g[:, d, :, d:, :c]
        yield tl, tr


def _xla_order(kind, grad, c, w):
    """dL and dR as XLA's transpose computes them on the CPU: the slices
    added in descending d, each partial sum rounded to bf16; and the
    largest partial sum's magnitude."""
    terms = list(_slices(kind, grad, c, w))[::-1]
    sums, largest = [None, None], 0.0
    for pair in terms:
        for i, t in enumerate(pair):
            sums[i] = t if sums[i] is None else as_f32(jbf(sums[i] + t)).astype(np.float64)
            largest = max(largest, float(np.abs(sums[i]).max()))
    return as_f32(jbf(sums[0])), as_f32(jbf(sums[1])), largest


@pytest.mark.parametrize("kind", sorted(VOLUMES))
@pytest.mark.parametrize("b,h,w,c,d", SHAPES)
def test_bf16_volume_backward_matches_jax(kind, b, h, w, c, d):
    """dL and dR within n / 2 bf16 ulps of XLA's, n = min(D, W) (module
    docstring); XLA's own rounding reproduced bit for bit by
    ``_xla_order``, the port's sum by float32 ascending-d sums rounded
    once."""
    left, right = rng(b, h, w, c, seed=1), rng(b, h, w, c, seed=2)
    jop, _, backward = VOLUMES[kind]
    channels = 2 * c if kind == "concat" else c
    grad = as_f32(jbf(rng(b, d, h, w, channels, seed=3, scale=3.0)))
    want = jax.jit(lambda l_, r_, g: jax.vjp(lambda a, bb: jop(a, bb, d), l_, r_)[1](g))(
        jbf(left), jbf(right), jbf(grad))
    got = backward(torch.from_numpy(grad.transpose(0, 4, 1, 2, 3).copy()).to(BF16),
                   nchw(left).to(BF16), nchw(right).to(BF16))
    xla_l, xla_r, largest = _xla_order(kind, grad, c, w)
    n = min(d, w)
    for g, jw, xla, ascending in zip(got, want, (xla_l, xla_r), zip(*_slices(kind, grad, c, w))):
        assert g.dtype == BF16 and jw.dtype == jnp.bfloat16
        ref = as_f32(jw)
        np.testing.assert_array_equal(xla, ref)  # XLA's order and roundings, as stated
        port = g.float().numpy().transpose(0, 2, 3, 1)
        once = np.zeros(ref.shape, np.float32)
        for t in ascending:  # the port's rule: float32, ascending d, one rounding
            once += t.astype(np.float32)
        np.testing.assert_array_equal(port, as_f32(jbf(once)))
        assert np.abs(port - ref).max() <= n / 2 * ulp(largest), (np.abs(port - ref).max(), n)


# ---------------------------------------------------------------------------
# StereoNet and PSMNet forwards in bf16 against flax in bf16
# ---------------------------------------------------------------------------


def _calibrate_bn_(model, left, right):
    """Each BatchNorm's (2-D and 3-D) running statistics set to its input's
    on this pair, so the random network stays near unit scale."""
    def hook(mod, inputs):
        x = inputs[0]
        dims = (0,) + tuple(range(2, x.ndim))
        mod.running_mean.copy_(x.mean(dims))
        mod.running_var.copy_(x.var(dims, unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d))]
    with torch.no_grad():
        model(left, right)
    for handle in handles:
        handle.remove()


def _rounding_control(model):
    """Forward hooks that round each 2-D and 3-D conv's, transposed conv's
    and BatchNorm's output to bf16 values: with no compute dtype, layers
    that compute in float32 and round only their outputs."""
    kinds = (torch.nn.Conv2d, torch.nn.Conv3d, ConvTranspose, Norm)
    return [m.register_forward_hook(lambda mod, inputs, out: out.to(BF16).float())
            for m in model.modules() if isinstance(m, kinds)]


@pytest.fixture(scope="module", params=sorted(FORWARDS))
def forwards(request):
    """Per network: JAX's final map in float32 and bf16 and its
    aggregation's bf16 output from its bf16 volume; the port's final map in
    bf16, and its aggregation on JAX's bf16 volume in bf16, in float32 and
    as the rounding control."""
    flags, hw = FORWARDS[request.param]
    rs = np.random.RandomState(0)
    left, right = (rs.randn(1, *hw, 3).astype(np.float32) for _ in range(2))
    jmodel = JaxModelConfig(**flags).build()
    j16 = JaxModelConfig(**flags, dtype="bfloat16").build()
    zeros = jnp.zeros((1, *hw, 3))
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), zeros, zeros, train=False), 1)
    port = load_flax(ModelConfig(**flags).build(), variables)
    _calibrate_bn_(port, nchw(left), nchw(right))
    params, stats = flax_from_state_dict(port.state_dict())
    variables = {"params": params, "batch_stats": stats}

    def volume_and_aggregation(m, images):
        feats = m.feature_extraction(images, False)
        vol = m.cost_volume_construction(feats[:1], feats[1:])
        return vol, m.aggregation(vol, False)

    def run(v, a, b):
        with jax_precision(jnp.bfloat16):
            vol, agg = jmodel.apply(v, jnp.concatenate([a, b]).astype(jnp.bfloat16),
                                    method=volume_and_aggregation)
        return (jmodel.apply(v, a, b, train=False)[-1], j16.apply(v, a, b, train=False)[-1],
                vol, agg[-1] if isinstance(agg, (list, tuple)) else agg)

    final32, final16, vol, agg = jax.jit(run)(variables, left, right)
    p16 = load_flax(ModelConfig(**flags, dtype="bfloat16").build(), variables)
    vol_t = torch.from_numpy(as_f32(vol).transpose(0, 4, 1, 2, 3).copy())
    out = {}
    with torch.no_grad():
        out["final"] = p16(nchw(left), nchw(right))[-1].numpy()
        with precision(BF16):
            out["bf16"] = p16.aggregation(vol_t.to(BF16))
        out["float32"] = port.aggregation(vol_t)
        handles = _rounding_control(port)
        out["control"] = port.aggregation(vol_t)
        for handle in handles:
            handle.remove()
    for k in ("bf16", "float32", "control"):
        a = out[k][-1] if isinstance(out[k], list) else out[k]
        out[k] = a.float().numpy()
    want_agg = as_f32(agg)
    if want_agg.ndim == 4:  # [B, H, W, D] -> the port's [B, D, H, W]
        want_agg = want_agg.transpose(0, 3, 1, 2)
    return out, np.asarray(final32), np.asarray(final16), want_agg


def test_bf16_aggregation_matches_jax(forwards):
    out, _, _, want = forwards
    got, own, off = (np.abs(out[k] - want) for k in ("bf16", "float32", "control"))
    assert got.mean() <= AGGREGATION_MEAN_LIMIT * own.mean(), (got.mean() / own.mean(),)
    assert got.max() <= 2 * own.max(), (got.max() / own.max(),)
    assert got.mean() < off.mean(), (got.mean() / own.mean(), off.mean() / own.mean())
    assert off.mean() > AGGREGATION_MEAN_LIMIT * own.mean(), (off.mean() / own.mean(),)


def test_bf16_forward_matches_jax(forwards):
    out, final32, final16, _ = forwards
    assert out["final"].dtype == np.float32 and np.isfinite(out["final"]).all()
    got, own = np.abs(out["final"] - final16), np.abs(final16 - final32)
    assert own.mean() > 0 and got.mean() <= FINAL_MEAN_LIMIT * own.mean(), (got.mean() / own.mean(),)
    assert got.max() <= 2 * own.max(), (got.max() / own.max(),)


# ---------------------------------------------------------------------------
# One bf16 train step of StereoNet against make_train_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def steps():
    """One train step of JAX's float32 and bf16 StereoNet (remat off; each
    compiled once) and of the port's (remat on) from the fresh init, on
    each of ``SEEDS``' batches: per batch (loss, updated parameters,
    BatchNorm statistics) for "float32", "bfloat16", the port's bf16 step
    ("port") and two float32 controls: the port's float32 step ("port32")
    and its layers with bf16-rounded outputs ("control")."""
    h, w = FORWARDS["stereonet"][1]
    jmodels = {dt: JaxModelConfig(**STEREONET, remat=False, dtype=dt).build()
               for dt in ("float32", "bfloat16")}
    torch.manual_seed(0)
    params, stats = flax_from_state_dict(ModelConfig(**STEREONET).build().state_dict())
    variables = {"params": params, "batch_stats": stats}
    tx = jax_make_optimizer(params, LR, weight_decay=WD)
    jsteps = {dt: jax_make_train_step(m, STEREONET["max_disp"]) for dt, m in jmodels.items()}
    runs = []
    for seed in SEEDS:
        rs = np.random.RandomState(seed)
        batch = dict(left=rs.randn(2, h, w, 3).astype(np.float32),
                     right=rs.randn(2, h, w, 3).astype(np.float32),
                     disp=rs.uniform(0, 40, (2, h, w)).astype(np.float32))
        run = {}
        for dt, m in jmodels.items():
            state = TrainState.create(apply_fn=m.apply, params=params, batch_stats=stats, tx=tx)
            new, metrics = jsteps[dt](state, {k: jnp.asarray(v) for k, v in batch.items()})
            run[dt] = (float(metrics["total_loss"]), jax.tree.leaves(jax.device_get(new.params)),
                       jax.tree.leaves(jax.device_get(new.batch_stats)))
        for name, dtype, rounded in (("port", "bfloat16", False), ("port32", None, False),
                                     ("control", None, True)):
            port = load_flax(ModelConfig(**STEREONET, dtype=dtype).build(), variables)
            handles = _rounding_control(port) if rounded else []
            step = make_train_step(port, make_optimizer(port, LR, weight_decay=WD),
                                   STEREONET["max_disp"])
            metrics = step(dict(left=nchw(batch["left"]), right=nchw(batch["right"]),
                                disp=torch.from_numpy(batch["disp"])))
            for handle in handles:
                handle.remove()
            assert all(p.dtype == p.grad.dtype == torch.float32 for p in port.parameters())
            new_params, new_stats = flax_from_state_dict(port.state_dict())
            run[name] = (float(metrics["total_loss"]), jax.tree.leaves(new_params),
                         jax.tree.leaves(new_stats))
        runs.append(run)
    return runs


def _sq(a_leaves, b_leaves):
    return sum(float(((np.asarray(a) - np.asarray(b)) ** 2).sum()) for a, b in zip(a_leaves, b_leaves))


def _rel(a_leaves, b_leaves):
    return np.concatenate([(np.abs(np.asarray(a) - np.asarray(b)) / (np.abs(np.asarray(b)) + 1)).ravel()
                           for a, b in zip(a_leaves, b_leaves)])


def test_bf16_stereonet_step_matches_jax(steps):
    """The loss (root mean square over the batches) and the whole update
    within 1.2 times JAX's own bf16-vs-float32 distance; the BatchNorm
    statistics per batch within ``STATS_MEAN_LIMIT`` of it in the mean and
    2 times at most, where both float32 controls break the mean limit."""
    port = np.sqrt(np.mean([(r["port"][0] - r["bfloat16"][0]) ** 2 for r in steps]))
    own = np.sqrt(np.mean([(r["bfloat16"][0] - r["float32"][0]) ** 2 for r in steps]))
    assert own > 0 and port <= 1.2 * own, (port, own)
    update = sum(_sq(r["port"][1], r["bfloat16"][1]) for r in steps)
    own_update = sum(_sq(r["bfloat16"][1], r["float32"][1]) for r in steps)
    assert own_update > 0 and update <= 1.2 ** 2 * own_update, (np.sqrt(update / own_update),)
    for r in steps:
        assert len(r["port"][2]) == len(r["bfloat16"][2]) > 0
        got, own_stats = _rel(r["port"][2], r["bfloat16"][2]), _rel(r["bfloat16"][2], r["float32"][2])
        assert got.mean() <= STATS_MEAN_LIMIT * own_stats.mean(), (got.mean() / own_stats.mean(),)
        assert got.max() <= 2 * own_stats.max(), (got.max() / own_stats.max(),)
        for control in ("port32", "control"):
            off = _rel(r[control][2], r["bfloat16"][2])
            assert off.mean() > STATS_MEAN_LIMIT * own_stats.mean(), (control, off.mean() / own_stats.mean())


# ---------------------------------------------------------------------------
# The entry points with a 3-D baseline's model flags in bf16
# ---------------------------------------------------------------------------


def test_bf16_entry_points_take_the_baseline_flags(tmp_path, capsys):
    """``train``, ``evaluate``, ``inference`` and ``predict`` with
    ``--dtype bfloat16`` and StereoNet's model flags on four synthetic
    pairs: the train step's losses finite, its checkpoint float32, the EPE
    finite, the maps finite and of the pairs' size."""
    import json
    import os

    import chip_smoke
    from aanet_torch import cli
    from aanet_torch.data.file_io import read_disp

    data, lists = chip_smoke.write_synthetic(str(tmp_path / "set"), pairs=4, hw=(48, 96))
    model = ["--feature_type", "stereonet", "--feature_similarity", "difference",
             "--aggregation_type", "stereonet", "--refinement_type", "stereonet", "--max_disp", "48",
             "--dtype", "bfloat16", "--device", "cpu"]
    flags = [*model, "--data_dir", data, "--filename_root", lists, "--num_workers", "0"]
    ckpt = str(tmp_path / "run")
    cli.main(["train", *flags, "--checkpoint_dir", ckpt, "--img_height", "48", "--img_width", "96",
              "--batch_size", "2", "--max_epoch", "1", "--print_freq", "1", "--milestones", "10",
              "--no_validate"])
    losses = [json.loads(line)["total_loss"] for line in open(os.path.join(ckpt, "metrics.jsonl"))]
    assert len(losses) == 2 and np.isfinite(losses).all()
    weights = os.path.join(ckpt, "aanet_latest.pt")
    saved = torch.load(weights, weights_only=True)
    assert all(t.dtype in (torch.float32, torch.int64) for t in saved["model"].values())
    capsys.readouterr()
    cli.main(["evaluate", *flags, "--pretrained", weights, "--checkpoint_dir", str(tmp_path / "eval"),
              "--val_img_height", "48", "--val_img_width", "96", "--val_batch_size", "2"])
    assert np.isfinite(json.loads(capsys.readouterr().out.strip().splitlines()[-1])["epe"])
    out = str(tmp_path / "inference")
    cli.main(["inference", *flags, "--pretrained", weights, "--img_height", "48", "--img_width", "96",
              "--batch_size", "2", "--output_dir", out, "--save_type", "pfm"])
    maps = [read_disp(os.path.join(out, "left", f"{i}.pfm")) for i in range(4)]
    assert all(m.shape == (48, 96) and np.isfinite(m).all() for m in maps)
    pairs = str(tmp_path / "pairs")
    for side in ("left", "right"):
        os.makedirs(os.path.join(pairs, side))
        os.link(os.path.join(data, side, "0.png"), os.path.join(pairs, side, "0.png"))
    cli.main(["predict", *model, "--data_dir", pairs, "--pretrained", weights, "--save_type", "npy"])
    pred = np.load(os.path.join(pairs, "pred", "0.npy"))
    assert pred.shape == (48, 96) and np.isfinite(pred).all()
