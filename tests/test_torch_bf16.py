"""The port's bfloat16 serving path against the JAX package's, on the CPU.

The JAX package runs its ops and modules under a bf16 compute dtype
(``aanet_tpu/ops/precision.py``); the port's ``dtype="bfloat16"`` installs
the same policy (``aanet_torch/ops/precision.py``), and on the CPU its
kernel ops run their plain bf16 twins (float32 arithmetic on the widened
bf16 values, one rounding of the output). Inputs come from numpy seeds.

Tolerances, stated with their reasons:
* per op, in bf16 ulps of the output's scale (2^(floor(log2 max|ref|) - 7)):
  the deformable conv within 2 (the JAX op rounds each blended, modulated
  sample to bf16 before its contraction, the port does not: ROADMAP.md,
  "Known behaviours"), the correlation volume and the warp within 1 (the
  same float32 sums in another order, one rounding), the warp's mask
  exactly; soft-argmin's float32 disparity within 1e-5 px;
* per layer (``Conv``, ``ConvTranspose``, ``Norm``, ``DeformConv2dLayer``
  against flax's under ``precision(bfloat16)``): the convs and the
  BatchNorm bit for bit, the deformable conv within half an ulp of the
  output's scale (0.08 in the mean); a rounding control (float32
  arithmetic rounded at the output only) fails each limit;
* per stage (feature extraction, aggregation, refinement of the cut
  ``aanet`` and ``aanet+``, each fed the JAX stage's own bf16 input):
  bf16 rounds at the same places in both, but the deformable convs'
  known difference grows through the random layers as bf16's own
  rounding does, so each output is held to how far bf16 itself moves the
  JAX stage from float32 on the same input: mean |port - JAX bf16| at
  most 1.2 times (features, aggregation) or 0.9 times (refinement) the
  mean |JAX bf16 - float32|, and the max at most 2 times the max, the
  float32 stage being the port's (held to the JAX one within 5e-3 px and
  2e-3 by tests/test_torch_model.py, test_torch_layers.py and
  test_torch_ganet.py). A control whose layers compute in float32 and
  round only their outputs sits farther from JAX bf16 at every output
  and fails each stage's mean limit. A float32 stage (at 1 times) passes
  the features' and the aggregation's: the per-layer test is the one that
  places the roundings;
* the slice at the trained anchor (``aanet`` at max_disp 48 on
  tests/test_bf16_trained.py's in-distribution pair): against JAX float32
  that test's own bounds (mean < 0.15 px, 99th percentile < 0.6 px);
  against JAX bf16 mean < 0.05 px, 99th percentile < 0.2 px, max < 0.5 px.
"""
import dataclasses
import gzip
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from aanet_tpu import ops as jops
from aanet_tpu.config import preset as jax_preset
from aanet_tpu.models import layers as jlayers
from aanet_tpu.ops.precision import precision as jax_precision
from aanet_torch import cli, ops
from aanet_torch.config import Config, ModelConfig, preset
from aanet_torch.convert import flax_from_state_dict
from aanet_torch.models import layers
from aanet_torch.models.layers import ConvTranspose, DeformConv2dLayer, DtypeConv2d, Norm
from aanet_torch.ops import cost_volume, deform, softargmin, warp
from aanet_torch.ops.precision import canonical_dtype, compute_dtype, precision
from aanet_torch.train.trainer import Trainer

from _torch_port import calibrate_bn_, load_flax, nchw, output_rounding_hooks, random_variables

BF16 = torch.bfloat16
CUT = dict(max_disp=48, num_fusions=2, num_deform_blocks=1)
HW = (96, 192)
ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", "aanet_synthetic_best.msgpack.gz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small CPU runs (the test workers
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rng(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def jbf(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def tbf(x):
    return nchw(x).to(BF16)


def as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def ulp(ref):
    """One bf16 ulp at the scale of ``ref``'s largest value."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


# ---------------------------------------------------------------------------
# The ops' bf16 twins against the JAX ops in bf16 (the float32 op tests'
# shapes, tests/test_torch_ops.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("modulated,stride,groups", [(True, 1, 2), (True, 2, 2), (False, 1, 2)])
def test_deform_conv_bf16_matches_jax(modulated, stride, groups):
    b, h, w, cin, cout, dil = 2, 9, 11, 8, 6, 2
    ho = (h + 2 * dil - (2 * dil + 1)) // stride + 1
    wo = (w + 2 * dil - (2 * dil + 1)) // stride + 1
    x = rng(b, h, w, cin, seed=6)
    weight = rng(3, 3, cin, cout, seed=7, scale=0.2)
    bias = rng(cout, seed=8)
    offset = np.random.RandomState(9).uniform(-3, 3, (b, ho, wo, groups * 18)).astype(np.float32)
    mask = np.random.RandomState(10).uniform(0, 2, (b, ho, wo, groups * 9)).astype(np.float32)
    kw = dict(stride=stride, padding=dil, dilation=dil, deformable_groups=groups)
    want = jax.jit(lambda *a: jops.modulated_deform_conv2d(*a, **kw))(
        jbf(x), jnp.asarray(offset), jnp.asarray(mask) if modulated else None,
        jnp.asarray(weight), jnp.asarray(bias),
    )
    # as the layer hands them over: offsets, mask, weight and bias float32
    got = deform.modulated_deform_conv2d(
        tbf(x), nchw(offset), nchw(mask) if modulated else None,
        torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias), **kw,
    )
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    ref = as_f32(want)
    err = np.abs(got.float().numpy().transpose(0, 2, 3, 1) - ref).max()
    assert err <= 2 * ulp(ref), (err, ulp(ref))


@pytest.mark.parametrize("w,d", [(37, 8), (64, 16), (52, 48)])
def test_correlation_bf16_matches_jax(w, d):
    left, right = rng(2, 5, w, 16, seed=1), rng(2, 5, w, 16, seed=2)
    want = jax.jit(jops.correlation_cost_volume, static_argnums=2)(jbf(left), jbf(right), d)
    got = cost_volume.correlation_cost_volume(tbf(left), tbf(right), d)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    ref = as_f32(want)
    err = np.abs(got.float().numpy().transpose(0, 2, 3, 1) - ref).max()
    assert err <= ulp(ref), (err, ulp(ref))


@pytest.mark.parametrize("shape", [(2, 6, 7, 24), (2, 5, 7, 1), (3, 3, 5, 37)])
@pytest.mark.parametrize("match_similarity", [True, False])
def test_soft_argmin_bf16_matches_jax(shape, match_similarity):
    cost = rng(*shape, seed=3, scale=3.0)
    want = jax.jit(jops.soft_argmin, static_argnums=1)(jbf(cost), match_similarity)
    got = softargmin.soft_argmin(tbf(cost), match_similarity)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_disp_warp_bf16_matches_jax():
    b, h, w, c = 2, 5, 20, 3
    img = rng(b, h, w, c, seed=4)
    disp = np.random.RandomState(5).uniform(-6.0, 12.0, (b, h, w)).astype(np.float32)
    disp[0, 0, :4] = [0.0, 1.0, 2.5, -0.25]  # exact and fractional samples at the edge
    want, want_valid = jax.jit(jops.disp_warp)(jbf(img), jnp.asarray(disp))
    got, got_valid = warp.disp_warp(tbf(img), torch.from_numpy(disp))
    assert got.dtype == got_valid.dtype == BF16 and want.dtype == jnp.bfloat16
    ref = as_f32(want)
    err = np.abs(got.float().numpy().transpose(0, 2, 3, 1) - ref).max()
    assert err <= ulp(ref), (err, ulp(ref))
    np.testing.assert_array_equal(got_valid.float().numpy()[:, 0], as_f32(want_valid)[..., 0])
    assert 0.0 < got_valid.float().mean() < 1.0  # both outcomes occur


# ---------------------------------------------------------------------------
# The layers against flax's in bf16: where each rounds
# ---------------------------------------------------------------------------

# (flax layer, the port's, input NHWC shape, apply kwargs, limits on the
# max and mean error in ulps of the output's scale)
LAYER_CASES = {
    "conv_bias": (lambda: jlayers.Conv(12, 3, padding=1, use_bias=True),
                  lambda: layers.Conv(8, 12, 3, padding=1, bias=True), (2, 9, 11, 8), {}, (0, 0)),
    "conv_stride2": (lambda: jlayers.Conv(12, 3, stride=2, padding=1),
                     lambda: layers.Conv(8, 12, 3, stride=2, padding=1), (2, 9, 11, 8), {}, (0, 0)),
    "conv_transpose": (lambda: jlayers.ConvTranspose(6, use_bias=True),
                       lambda: ConvTranspose(8, 6, bias=True), (2, 5, 6, 8), {}, (0, 0)),
    "norm": (lambda: jlayers.Norm(), lambda: Norm(8), (2, 9, 11, 8), dict(train=False), (0, 0)),
    "deform": (lambda: jlayers.DeformConv2dLayer(6, use_bias=True),
               lambda: DeformConv2dLayer(8, 6, bias=True), (2, 10, 13, 8), {}, (0.5, 0.08)),
}


def _rounding_control(port, x):
    """The layer computed in float32 from the bf16 input with its float32
    parameters, rounded to bf16 only at its output; for ``Norm``, with its
    statistics and affine parameters rounded to bf16 as well (bf16
    arithmetic). Neither is flax's rounding."""
    if isinstance(port, Norm):
        bn = port.BatchNorm_0
        return torch.nn.functional.batch_norm(
            x, *(t.to(BF16) for t in (bn.running_mean, bn.running_var, bn.weight, bn.bias)),
            False, 0.0, bn.eps)
    return port(x.float()).to(BF16)


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_bf16_layer_rounds_as_flax(case):
    """Each layer under the bf16 policy against its flax counterpart under
    ``precision(bfloat16)`` on the same bf16 input: the convs and the
    BatchNorm bit for bit, the deformable conv (whose JAX op rounds each
    modulated sample, ROADMAP "Known behaviours") within half an ulp of the
    output's scale at most and 0.08 in the mean. The rounding control
    (``_rounding_control``) fails each limit: it differs in 36-49 % of the
    convs' and the BatchNorm's elements, and by 1 ulp (max) and 0.094 ulp
    (mean) at the deformable conv."""
    jmod, tmod, shape, kw, (max_ulps, mean_ulps) = LAYER_CASES[case]
    jmod = jmod()
    x = rng(*shape, seed=1)
    variables = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw), 2)
    with jax_precision(jnp.bfloat16):
        want = jax.jit(lambda v, a: jmod.apply(v, a, **kw))(variables, jbf(x))
    port = load_flax(tmod(), variables)
    with torch.no_grad():
        with precision(BF16):
            got = port(tbf(x))
        control = _rounding_control(port, tbf(x))
    assert got.dtype == control.dtype == BF16 and want.dtype == jnp.bfloat16
    ref = as_f32(want)
    scale = ulp(ref)
    errs = {}
    for what, t in (("port", got), ("control", control)):
        diff = np.abs(t.float().numpy().transpose(0, 2, 3, 1) - ref)
        errs[what] = (diff.max() / scale, diff.mean() / scale)
    port_max, port_mean = errs["port"]
    assert port_max <= max_ulps and port_mean <= mean_ulps, errs
    assert errs["control"][0] > max_ulps and errs["control"][1] > mean_ulps, errs


@pytest.mark.parametrize("name,want", [("float32", None), (torch.float32, None), (None, None),
                                       ("bfloat16", BF16), (BF16, BF16)])
def test_canonical_dtype(name, want):
    """float32 is the default and installs no policy, as flax's
    ``dtype=float32`` is its default."""
    assert canonical_dtype(name) is want


def test_float32_config_runs_the_default_path():
    """``dtype="float32"`` builds the same model as ``dtype=None``: no
    compute dtype is installed in its forward, and its pyramid is the
    default model's bit for bit."""
    left, right = (nchw(x) for x in _pair())
    seen = []
    pyramids = []
    state = None
    for dtype in (None, "float32"):
        model = dataclasses.replace(preset("aanet"), dtype=dtype, **CUT).build().eval()
        assert model.dtype is None
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        first = next(m for m in model.modules() if isinstance(m, DtypeConv2d))
        handle = first.register_forward_hook(lambda *_: seen.append(compute_dtype()))
        with torch.no_grad():
            pyramids.append(model(left, right))
        handle.remove()
    assert seen == [None, None]
    for a, b in zip(*pyramids):
        assert torch.equal(a, b)



# ---------------------------------------------------------------------------
# The policy, and the stages against the JAX stages in bf16
# ---------------------------------------------------------------------------


def _pair(seed=0, hw=HW):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(1, *hw, 3).astype(np.float32) for _ in range(2))


# every preset: the cut aanet and aanet+ of the stage tests, the others at
# the smallest sizes their extractors take (PSMNet's SPP pools 64-px
# windows at H/4) with their pyramids' lengths
POLICY_CASES = [
    ("aanet", HW, CUT, 5), ("aanet+", HW, CUT, 5), ("stereonet-aa", (48, 96), {}, 3),
    ("psmnet-aa", (256, 256), dict(max_disp=96), 3), ("ganet-aa", (96, 96), {}, 3),
    ("gcnet-aa", (96, 144), dict(max_disp=48), 2),
]


@pytest.mark.parametrize("name,hw,overrides,maps", POLICY_CASES, ids=[c[0] for c in POLICY_CASES])
def test_bf16_policy_dtypes(name, hw, overrides, maps):
    """Under each preset's bf16 forward (eval mode): every conv, BatchNorm
    and deformable conv gives bf16, the offset heads and soft-argmin
    float32; the pyramid is float32 and finite; parameters and buffers
    stay float32; the CPU launches no kernel."""
    left, right = (nchw(x) for x in _pair(hw=hw))
    model = dataclasses.replace(preset(name), dtype="bfloat16", **overrides).build().eval()
    seen = {}

    def hook(mod, inputs, output):
        seen.setdefault(type(mod).__name__ if "offset" not in names[mod] else "offset_conv",
                        set()).add(output.dtype)

    names = {m: n for n, m in model.named_modules()}
    kinds = (torch.nn.Conv2d, ConvTranspose, Norm, DeformConv2dLayer)
    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, kinds)]
    argmins = []

    def spy(cost, match_similarity=True):
        out = softargmin.soft_argmin_plain(cost, match_similarity)
        argmins.append((cost.dtype, out.dtype))
        return out

    with torch.no_grad(), mock.patch.object(softargmin, "soft_argmin", spy):
        pyramid = model(left, right)
    for h in handles:
        h.remove()
    offsets = seen.pop("offset_conv")
    assert offsets == {torch.float32}
    assert {"DtypeConv2d", "Norm", "DeformConv2dLayer"} <= set(seen), seen
    assert all(dtypes == {BF16} for dtypes in seen.values()), seen
    assert argmins and all(a == (BF16, torch.float32) for a in argmins), argmins
    assert len(pyramid) == maps and tuple(pyramid[-1].shape) == (1, *hw)
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in pyramid)
    assert all(t.dtype == torch.float32 for t in model.parameters())
    assert all(t.dtype in (torch.float32, torch.int64) for t in model.buffers())
    assert all(op.launches == op.launches_bf16 == 0 for op in ops.KERNEL_OPS[:4])


@pytest.mark.parametrize("name,hw,overrides,maps", POLICY_CASES, ids=[c[0] for c in POLICY_CASES])
def test_bf16_train_step_of_each_preset(name, hw, overrides, maps):
    """One bf16 train step of each preset (``gcnet-aa`` with the final map's
    loss only, as it trains in float32 too): a finite float32 loss, float32
    parameters, gradients and statistics, and an update that moves the
    parameters; the CPU launches no kernel."""
    from aanet_torch.train.optimizer import make_optimizer
    from aanet_torch.train.trainer import make_train_step

    model = dataclasses.replace(preset(name), dtype="bfloat16", **overrides).build()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    left, right = (nchw(x) for x in _pair(hw=hw))
    batch = dict(left=left, right=right,
                 disp=torch.from_numpy(np.random.RandomState(1).uniform(1, 20, (1, *hw)).astype(np.float32)))
    step = make_train_step(model, make_optimizer(model, 1e-3), model.max_disp,
                           highest_loss_only=name == "gcnet-aa")
    loss = step(batch)["total_loss"]
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss)) and float(loss) > 0
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype in (torch.float32, torch.int64) for t in model.buffers())
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    assert all(op.launches == op.launches_bf16 == 0 for op in ops.KERNEL_OPS[:4] + ops.BACKWARD_OPS[:5])


@pytest.fixture(scope="module", params=["aanet", "aanet+"])
def stages(request):
    """The cut preset with random weights and BatchNorms calibrated on the
    pair (``_torch_port.calibrate_bn_``). Per stage (features, aggregation,
    refinement): the port's bf16 output, the JAX stage's bf16 output, the
    port's float32 output on the same (bf16-valued) input, and the rounding
    control's (``_torch_port.output_rounding_hooks``)."""
    name = request.param
    left, right = _pair()
    jmodel = dataclasses.replace(jax_preset(name), **CUT).build()
    zeros = jnp.zeros((1, *HW, 3))
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), zeros, zeros, train=False), 1)
    port = load_flax(dataclasses.replace(preset(name), **CUT).build(), variables)
    calibrate_bn_(port, nchw(left), nchw(right))
    params, stats = flax_from_state_dict(port.state_dict())
    variables = {"params": params, "batch_stats": stats}

    def path(m, images):
        """The JAX eval path's stages: their inputs and outputs."""
        feats = m.feature_extraction(images, False)
        vols = m.cost_volume_construction([f[:1] for f in feats], [f[1:] for f in feats])
        agg = m.aggregation(vols, False)
        low_disp = m.disparity_computation(agg)[-1]
        return feats, vols, agg, low_disp, m.disparity_refinement(
            images[:1], images[1:], low_disp, False)

    images = jbf(np.concatenate([left, right]))
    with jax_precision(jnp.bfloat16):
        feats, vols, agg, low_disp, refined = jax.jit(
            lambda v, x: jmodel.apply(v, x, method=path))(variables, images)

    p16 = load_flax(dataclasses.replace(preset(name), dtype="bfloat16", **CUT).build(), variables)
    low = torch.from_numpy(np.array(low_disp))
    t = lambda x: nchw(as_f32(x))  # noqa: E731
    runs = {}
    for run, model, dt in (("bf16", p16, BF16), ("float32", port, None), ("control", port, None)):
        cast = (lambda x: t(x).to(dt)) if dt else t  # noqa: E731
        handles = output_rounding_hooks(model) if run == "control" else []
        with torch.no_grad(), precision(dt):
            runs[run] = (model._features(cast(images)), model.aggregation([cast(v) for v in vols]),
                         model._refine(cast(images[:1]), cast(images[1:]), low))
        for handle in handles:
            handle.remove()
    return runs["bf16"], (feats, agg, refined), runs["float32"], runs["control"]


# the mean |port - JAX bf16| per stage output, in units of the mean |JAX
# bf16 - float32|: the sound port read 0.955-1.170 in the features and the
# aggregation (the deformable convs' known rounding difference) and
# 0.467-0.781 in the refinement; the rounding control 1.213-1.359 and
# 1.109-1.162; a float32 stage sits at 1.
STAGE_MEAN_LIMITS = (1.2, 1.2, 0.9)


@pytest.mark.parametrize("stage", [0, 1, 2], ids=["features", "aggregation", "refinement"])
def test_bf16_stage_matches_jax(stages, stage):
    got, want, ref32, control = (s[stage] for s in stages)
    assert len(got) == len(want) == len(ref32) == len(control) > 0
    limit = STAGE_MEAN_LIMITS[stage]
    control_ratios = []
    for g, w, r, c in zip(got, want, ref32, control):
        assert g.dtype == (torch.float32 if stage == 2 else BF16)
        g, r, c, w = g.float().numpy(), r.numpy(), c.numpy(), as_f32(w)
        if w.ndim == 4:  # NHWC maps
            g, r, c = (a.transpose(0, 2, 3, 1) for a in (g, r, c))
        diff, own, off = np.abs(g - w), np.abs(w - r), np.abs(c - w)
        assert diff.mean() <= limit * own.mean(), (diff.mean(), own.mean())
        assert diff.max() <= 2 * own.max(), (diff.max(), own.max())
        assert diff.mean() < off.mean(), (diff.mean(), off.mean())  # nearer than the control
        control_ratios.append(off.mean() / own.mean())
    assert max(control_ratios) > limit, control_ratios  # the control fails the stage


# ---------------------------------------------------------------------------
# The slice at trained weights
# ---------------------------------------------------------------------------


def test_trained_anchor_in_bf16_matches_jax():
    """The committed anchor (``aanet`` at max_disp 48) read by the port's
    own reader, served in bf16 on tests/test_bf16_trained.py's pair,
    against the JAX model in float32 and in bf16."""
    from flax import serialization

    from aanet_torch.utils.checkpoint import load_pretrained

    h, w, shift = 96, 192, 6
    jcfg = dataclasses.replace(jax_preset("aanet"), max_disp=48)
    jmodel = jcfg.build()
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), jnp.zeros((1, h, w, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    with gzip.open(ARTIFACT, "rb") as f:
        variables = serialization.from_bytes(
            {"params": zeros["params"], "batch_stats": zeros["batch_stats"]}, f.read())
    rs = np.random.RandomState(7)
    base = rs.rand(h, w + 16, 3)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 2, 1)) / 3
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    rb = ((base[:, :w].astype(np.float32) - mean) / std)[None]
    lb = ((base[:, shift: w + shift].astype(np.float32) - mean) / std)[None]

    j16 = dataclasses.replace(jcfg, dtype="bfloat16").build()
    want32, want16 = (np.asarray(a) for a in jax.jit(lambda v, a, b: (  # one compile for both
        jmodel.apply(v, a, b, train=False)[-1], j16.apply(v, a, b, train=False)[-1]))(
            variables, lb, rb))
    port = dataclasses.replace(preset("aanet"), max_disp=48, dtype="bfloat16").build()
    load_pretrained(port, ARTIFACT, strict=True)
    with torch.no_grad():
        pyramid = port.eval()(nchw(lb), nchw(rb))
    got = pyramid[-1].numpy()
    assert pyramid[-1].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())  # served, not converted
    d32, d16 = np.abs(got - want32), np.abs(got - want16)
    assert d32.mean() < 0.15 and np.quantile(d32, 0.99) < 0.6, (d32.mean(), np.quantile(d32, 0.99))
    assert d16.mean() < 0.05 and np.quantile(d16, 0.99) < 0.2 and d16.max() < 0.5, (
        d16.mean(), np.quantile(d16, 0.99), d16.max())
    assert np.abs(want32 - shift).mean() < 2.0  # the checkpoint is trained


# ---------------------------------------------------------------------------
# bf16 training (its step against JAX's: tests/test_torch_bf16_train.py), the
# backwards' dtypes, and the 4-D volumes in bf16 (against JAX's:
# tests/test_torch_bf16_volumes.py)
# ---------------------------------------------------------------------------


def test_bf16_training_is_refused(tmp_path):
    """bf16 trains now (the name is the refusal's it replaced): the cut
    model's forward in training mode gives a float32 pyramid whose loss
    reaches every parameter with a float32 gradient, ``Trainer`` takes a
    bf16 config, and ``train --dtype bfloat16`` takes its step and writes
    a float32 checkpoint."""
    cfg = dataclasses.replace(preset("aanet"), dtype="bfloat16", **CUT)
    model = cfg.build()  # training mode, as modules start
    left, right = (nchw(x) for x in _pair(hw=(48, 96)))
    pyramid = model(left, right)
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in pyramid)
    sum(p.mean() for p in pyramid).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())
    train_cfg = Config(model=cfg)
    train_cfg.train.checkpoint_dir = str(tmp_path / "run")
    assert Trainer(train_cfg, steps_per_epoch=1, device="cpu").model.dtype == BF16
    data, lists = chip_smoke.write_synthetic(str(tmp_path / "set"), pairs=2, hw=(48, 96))
    ckpt = tmp_path / "cli"
    cli.main(["train", "--dtype", "bfloat16", "--data_dir", data, "--filename_root", lists,
              "--checkpoint_dir", str(ckpt), "--img_height", "48", "--img_width", "96",
              "--batch_size", "2", "--max_epoch", "1", "--num_workers", "0", "--milestones", "10",
              "--print_freq", "1", "--no_validate", *map(str, _cut_flags()), "--device", "cpu"])
    records = [json.loads(line) for line in open(ckpt / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1] and np.isfinite(records[0]["total_loss"])
    saved = torch.load(ckpt / "aanet_latest.pt", weights_only=True)
    assert saved["model"] and all(t.dtype in (torch.float32, torch.int64) for t in saved["model"].values())
    assert json.loads(open(ckpt / "args.json").read())["model"]["dtype"] == "bfloat16"


def _cut_flags():
    return [f for k, v in CUT.items() for f in (f"--{k}", v)]


@pytest.mark.parametrize("flags", [
    dict(feature_type="stereonet", feature_similarity="difference", aggregation_type="stereonet",
         refinement_type="stereonet", max_disp=16),
    dict(feature_type="gcnet", feature_similarity="concat", aggregation_type="gcnet",
         num_downsample=1, refinement_type="None", max_disp=32),
], ids=["difference", "concat"])
def test_bf16_with_a_4d_volume_is_refused(flags):
    """A bf16 model with a 4-D volume builds and runs now (the name is
    the refusal's it replaced): StereoNet's difference volume and GC-Net's
    concat volume (PSMNet's extractor needs 256x256) are built in bf16 and
    the pyramid comes back float32 and finite; float32 builds as before."""
    model = ModelConfig(dtype="bfloat16", **flags).build().eval()
    seen = []

    def record(left, right, max_disp, kind):
        out = real(left, right, max_disp, kind)
        seen.append(out.dtype)
        return out

    real = cost_volume._Volume.apply
    left, right = (nchw(x) for x in _pair(hw=(32, 64)))
    with mock.patch.object(cost_volume._Volume, "apply", record), torch.no_grad():
        pyramid = model(left, right)
    assert seen == [BF16]
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in pyramid)
    ModelConfig(**flags).build()  # float32 builds


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_backward_wrappers_refuse_bf16(device):
    """Each backward wrapper takes bf16 now (the name is the refusal's it
    replaced). On the CPU (the plain twins) each gradient comes in its
    primal's dtype: the deformable conv's x, mask and weight gradients
    bf16 and its offsets' float32, the correlation's bf16, soft-argmin's
    volume gradient bf16, the warp's disparity gradient float32. On a
    device that is neither the CPU nor CUDA (the meta device) each raises
    before any kernel launches."""
    t = lambda *s: torch.zeros(s, dtype=BF16, device=device)  # noqa: E731
    f32 = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    kw = dict(padding=2, dilation=2, deformable_groups=2)
    calls = [
        (lambda: deform.modulated_deform_conv2d_backward_data(
            t(1, 3, 5, 6), t(1, 4, 5, 6), f32(1, 36, 5, 6), t(1, 18, 5, 6), t(3, 4, 3, 3), **kw),
         (BF16, torch.float32, BF16)),
        (lambda: deform.modulated_deform_conv2d_backward_weight(
            t(1, 3, 5, 6), t(1, 4, 5, 6), f32(1, 36, 5, 6), t(1, 18, 5, 6), t(3, 4, 3, 3), **kw),
         (BF16,)),
        (lambda: cost_volume.correlation_cost_volume_backward(t(1, 4, 4, 9), t(1, 3, 4, 9),
                                                              t(1, 3, 4, 9)), (BF16, BF16)),
        (lambda: softargmin.soft_argmin_backward(f32(1, 2, 3), t(1, 5, 2, 3)), (BF16,)),
        (lambda: warp.disp_warp_backward(t(1, 2, 3, 8), t(1, 2, 3, 8), f32(1, 3, 8)),
         (torch.float32,)),
        (lambda: cost_volume.difference_cost_volume_backward(t(1, 3, 4, 4, 9), t(1, 3, 4, 9),
                                                             t(1, 3, 4, 9)), (BF16, BF16)),
        (lambda: cost_volume.concat_cost_volume_backward(t(1, 6, 4, 4, 9), t(1, 3, 4, 9),
                                                         t(1, 3, 4, 9)), (BF16, BF16)),
    ]
    assert len(calls) == len(ops.BACKWARD_OPS)
    for call, dtypes in calls:
        if device == "cpu":
            out = call()
            out = out if isinstance(out, tuple) else (out,)
            assert tuple(g.dtype for g in out) == dtypes
        else:
            with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
                call()
    assert all(op.launches == op.launches_bf16 == 0 for op in ops.BACKWARD_OPS)


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------


def test_cli_predict_and_evaluate_in_bf16(tmp_path, capsys):
    """``predict --dtype bfloat16`` on the cut ``aanet``, and ``evaluate
    --dtype bfloat16`` of the trained anchor's flax file (float32
    parameters served in bf16) within 0.15 px of its float32 EPE, on four
    pairs of the set it was trained on."""
    from PIL import Image

    pairs = tmp_path / "pairs"
    rs = np.random.RandomState(0)
    for sub in ("left", "right"):
        os.makedirs(pairs / sub)
    for i in range(2):
        base = rs.randint(0, 256, (40, 98, 3), dtype=np.uint8)
        Image.fromarray(base[:, 4:94]).save(pairs / "left" / f"{i}.png")
        Image.fromarray(base[:, :90]).save(pairs / "right" / f"{i}.png")
    out = tmp_path / "out"
    cli.main(["predict", "--data_dir", str(pairs), "--output_dir", str(out), "--dtype", "bfloat16",
              "--save_type", "npy", *map(str, _cut_flags()), "--device", "cpu"])
    maps = [np.load(out / f"{i}.npy") for i in range(2)]
    assert all(m.shape == (40, 90) and m.dtype == np.float32 and np.isfinite(m).all() for m in maps)

    data, lists = chip_smoke.write_synthetic(str(tmp_path / "synthetic"), pairs=4)
    epe = {}
    for dtype in ("float32", "bfloat16"):
        capsys.readouterr()
        cli.main(["evaluate", "--data_dir", data, "--filename_root", lists, "--checkpoint_dir",
                  str(tmp_path / "eval"), "--preset", "aanet", "--max_disp", "48", "--pretrained",
                  ARTIFACT, "--strict", "--dtype", dtype, "--val_img_height", "96",
                  "--val_img_width", "192", "--val_batch_size", "2", "--num_workers", "0",
                  "--device", "cpu"])
        epe[dtype] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["epe"]
    assert np.isfinite(epe["bfloat16"]) and abs(epe["bfloat16"] - epe["float32"]) < 0.15, epe
