"""Rules of the PyTorch port, checked on the CPU: it imports nothing of
JAX, converted weights load strictly, the CPU path launches no kernel, and
the entry points never fall back from CUDA to the CPU quietly."""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from aanet_tpu.config import preset as jax_preset
from aanet_torch import cli, infer, ops
from aanet_torch.config import MODEL_PRESETS, ModelConfig, preset
from aanet_torch.convert import state_dict_from_flax
from aanet_torch.ops import KERNEL_OPS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "aanet_tpu"}
CUT = dict(max_disp=48, num_fusions=2, num_deform_blocks=1)


def _port_sources():
    for root, dirs, files in os.walk(os.path.join(REPO, "aanet_torch")):
        dirs[:] = [d for d in dirs if d != "_build_out"]  # built kernels, not sources
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            bad = FORBIDDEN.intersection(roots)
            assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_converted_flax_tree_loads_strictly():
    """Every parameter and statistic of the full ``aanet`` preset maps onto
    exactly the port's state_dict keys, with matching shapes."""
    jmodel = jax_preset("aanet").build()
    img = jnp.zeros((1, 48, 96, 3))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), img, img, train=False)
    )
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = state_dict_from_flax(zeros["params"], zeros["batch_stats"])
    port = preset("aanet").build()
    want = port.state_dict()
    assert set(state) == set(want)
    assert all(state[k].shape == want[k].shape for k in want)
    port.load_state_dict(state, strict=True)


@pytest.mark.parametrize("name", ["psmnet-aa", "gcnet-aa", "ganet-aa", "aanet+"])
def test_aa_preset_flax_tree_loads_strictly(name):
    """Every parameter and statistic of the full ``psmnet-aa``,
    ``gcnet-aa``, ``ganet-aa`` and ``aanet+`` presets (the strided pyramid
    as ``fpn``, the single-output aggregation, GANet's UNet and the
    hourglass refinements) maps onto exactly the port's state_dict keys,
    with matching shapes."""
    jmodel = jax_preset(name).build()
    size = 96 if "ganet" in jax_preset(name).feature_type else 256  # PSMNet's SPP: 256 px
    img = jnp.zeros((1, size, size, 3))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), img, img, train=False)
    )
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = state_dict_from_flax(zeros["params"], zeros["batch_stats"])
    port = preset(name).build()
    want = port.state_dict()
    assert set(state) == set(want)
    assert all(state[k].shape == want[k].shape for k in want)
    port.load_state_dict(state, strict=True)
    heads = {k.split(".", 1)[1] for k in want if k.startswith("aggregation.")}
    assert ("final_conv_1.weight" in heads) == (name == "aanet+")  # intermediate supervision


@pytest.mark.parametrize(
    "overrides",
    # GANet's single scale under the FPN; an unknown refinement; float16
    # (the port runs float32 and bfloat16); a difference volume under the
    # adaptive aggregation; a 3-D aggregation of multi-scale features
    [dict(feature_type="ganet"), dict(refinement_type="bogus"), dict(dtype="float16"),
     dict(feature_similarity="difference"), dict(aggregation_type="gcnet")],
)
def test_build_refuses_what_the_port_does_not_run(overrides):
    with pytest.raises(NotImplementedError):
        dataclasses.replace(ModelConfig(feature_pyramid_network=True), **overrides).build()


def test_training_forward_updates_batchnorm_once_per_view():
    """Training mode runs two feature passes, left then right, so each
    feature BatchNorm moves twice per forward and every other once, also
    under checkpointing (remat on, as the preset has it)."""
    model = dataclasses.replace(preset("aanet"), **CUT).build()
    assert model.training and model.remat
    rs = np.random.RandomState(0)
    left, right = (torch.from_numpy(rs.randn(1, 3, 48, 96).astype(np.float32)) for _ in range(2))
    pyramid = model(left, right)
    sum(p.sum() for p in pyramid).backward()
    counts = {name: int(buf) for name, buf in model.named_buffers() if name.endswith("num_batches_tracked")}
    assert counts and all(
        n == (2 if name.startswith(("feature_extractor.", "fpn.")) else 1) for name, n in counts.items()
    ), counts
    assert [tuple(p.shape) for p in pyramid][-1] == (1, 48, 96)


def test_kernel_ops_are_autograd_functions():
    """Each kernel op returns a result whose gradient node is the op's own
    autograd Function (whose backward has a kernel), on the CPU as on the card."""
    rs = np.random.RandomState(1)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).requires_grad_(True)  # noqa: E731
    outputs = [
        ops.deform.modulated_deform_conv2d(t(1, 4, 5, 6), t(1, 36, 5, 6), t(1, 18, 5, 6), t(3, 4, 3, 3),
                                           t(3), padding=2, dilation=2, deformable_groups=2),
        ops.cost_volume.correlation_cost_volume(t(1, 3, 4, 9), t(1, 3, 4, 9), 4),
        ops.softargmin.soft_argmin(t(1, 5, 2, 3)),
        ops.warp.disp_warp(torch.zeros(1, 2, 3, 8), t(1, 3, 8))[0],
        ops.cost_volume.difference_cost_volume(t(1, 3, 4, 9), t(1, 3, 4, 9), 4),
        ops.cost_volume.concat_cost_volume(t(1, 3, 4, 9), t(1, 3, 4, 9), 4),
    ]
    assert len(outputs) == len(KERNEL_OPS)
    for op, out in zip(KERNEL_OPS, outputs):
        node = out.grad_fn
        assert isinstance(node, torch.autograd.function.BackwardCFunction), (op.__name__, node)
        assert node._forward_cls.__module__ == op.__module__, (op.__name__, node)


def test_every_launch_counter_is_listed():
    """``ops.KERNEL_OPS`` and ``ops.BACKWARD_OPS`` name every wrapper that
    counts kernel launches (the forward ops and the backward wrappers), so
    checks that read them miss none."""
    counters = {
        (module.__name__, name)
        for module in (ops.cost_volume, ops.deform, ops.softargmin, ops.warp)
        for name, fn in vars(module).items()
        if callable(fn) and hasattr(fn, "launches")
    }
    listed = {(op.__module__, op.__name__) for op in KERNEL_OPS + ops.BACKWARD_OPS}
    assert counters == listed
    assert all("backward" in op.__name__ for op in ops.BACKWARD_OPS)
    names = {op.__name__ for op in ops.BACKWARD_OPS}
    assert {"difference_cost_volume_backward", "concat_cost_volume_backward"} <= names
    # every op has a bf16 form, forward and backward, each counted apart in
    # ``launches_bf16``
    bf16 = {op.__name__ for op in KERNEL_OPS + ops.BACKWARD_OPS if hasattr(op, "launches_bf16")}
    assert bf16 == {op.__name__ for op in KERNEL_OPS + ops.BACKWARD_OPS}


def _write_pairs(root, h, w, n=2):
    rs = np.random.RandomState(0)
    for sub in ("left", "right"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        base = rs.randint(0, 256, (h, w + 8, 3), dtype=np.uint8)
        Image.fromarray(base[:, 4: w + 4]).save(os.path.join(root, "left", f"{i}.png"))
        Image.fromarray(base[:, :w]).save(os.path.join(root, "right", f"{i}.png"))


def test_predict_without_device_raises_when_cuda_is_absent(tmp_path, monkeypatch):
    _write_pairs(str(tmp_path), 40, 90, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(preset("aanet"), **CUT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.predict_pairs(cfg, str(tmp_path))


def test_predict_on_cpu_writes_cropped_outputs(tmp_path):
    _write_pairs(str(tmp_path), 40, 90)  # padded to 48x96, cropped back
    cfg = dataclasses.replace(preset("aanet"), **CUT)
    saved = infer.predict_pairs(cfg, str(tmp_path), device="cpu")
    assert [os.path.basename(s) for s in saved] == ["0.png", "1.png"]
    for name in saved:
        assert np.asarray(Image.open(name)).shape == (40, 90)
    assert [op.launches for op in KERNEL_OPS] == [0] * len(KERNEL_OPS)


@pytest.mark.parametrize("name", sorted(MODEL_PRESETS))
def test_predict_pads_to_the_references_multiple(name):
    """96 under hourglass refinement, else 48, as the JAX predict_pairs
    pads each preset (aanet_tpu/infer.py:304-305)."""
    want = 96 if jax_preset(name).refinement_type == "hourglass" else 48
    assert infer.pad_multiple(preset(name)) == want
    assert infer.pad_multiple(ModelConfig(refinement_type="hourglass")) == 96
    assert infer.pad_multiple(ModelConfig(refinement_type="stereodrnet")) == 48


def test_cli_predict_on_cpu_with_weights(tmp_path):
    data = tmp_path / "pairs"
    _write_pairs(str(data), 50, 100, n=1)
    cfg = dataclasses.replace(preset("aanet"), max_disp=48)
    weights = str(tmp_path / "weights.pt")
    torch.save(cfg.build().state_dict(), weights)
    out = tmp_path / "out"
    cli.main([
        "predict", "--preset", "aanet", "--max_disp", "48", "--data_dir", str(data),
        "--output_dir", str(out), "--pretrained", weights, "--save_type", "npy",
        "--device", "cpu",
    ])
    pred = np.load(out / "0.npy")
    assert pred.shape == (50, 100) and np.isfinite(pred).all()


BASELINE_FLAGS = {
    "psmnet": ["--feature_type", "psmnet", "--feature_similarity", "concat",
               "--aggregation_type", "psmnet_hourglass", "--refinement_type", "None"],
    "psmnet_basic": ["--feature_type", "psmnet", "--feature_similarity", "concat",
                     "--aggregation_type", "psmnet_basic", "--refinement_type", "None"],
    "stereonet": ["--feature_type", "stereonet", "--feature_similarity", "difference",
                  "--aggregation_type", "stereonet", "--refinement_type", "stereonet"],
    "stereonet-aa": ["--preset", "stereonet-aa"],
    "gcnet": ["--feature_type", "gcnet", "--feature_similarity", "concat",
              "--aggregation_type", "gcnet", "--num_downsample", "1", "--refinement_type", "None"],
    "psmnet-aa": ["--preset", "psmnet-aa"],
    "gcnet-aa": ["--preset", "gcnet-aa"],
    "ganet-aa": ["--preset", "ganet-aa"],
    "aanet+": ["--preset", "aanet+"],
}
# image size (padded to a multiple of 48) and max_disp per configuration:
# the PSMNet extractor needs 256 px at least; GC-Net's four stride-2 levels
# need H/2, W/2 and max_disp/2 to be multiples of 16; psmnet-aa's ISA convs
# of max_disp / 16 channels take two deformable groups
PREDICT_SIZES = {"psmnet": ((260, 270), 48), "psmnet_basic": ((260, 270), 48),
                 "gcnet": ((90, 90), 32), "psmnet-aa": ((260, 270), 96)}


@pytest.mark.parametrize("name", sorted(BASELINE_FLAGS))
def test_cli_predict_runs_the_baselines_on_cpu(tmp_path, name):
    """``predict`` reaches the 3-D-aggregation baselines through the JAX
    CLI's model flags, and the stereonet-aa, psmnet-aa, gcnet-aa,
    ganet-aa and aanet+ (padded to 96x96) presets, on the CPU. GC-Net's
    map is one pixel short of the padded pair, so its crop has one row
    fewer than the image, as the JAX ``predict`` gives it."""
    data = tmp_path / "pairs"
    (h, w), max_disp = PREDICT_SIZES.get(name, ((40, 90), 48))  # padded to 288, 96 or 48x96
    _write_pairs(str(data), h, w, n=1)
    out = tmp_path / "out"
    cli.main(["predict", *BASELINE_FLAGS[name], "--max_disp", str(max_disp), "--data_dir", str(data),
              "--output_dir", str(out), "--save_type", "npy", "--device", "cpu"])
    pred = np.load(out / "0.npy")
    assert pred.shape == ((h - 1, w) if name == "gcnet" else (h, w)) and np.isfinite(pred).all()
    assert all(op.launches == 0 for op in KERNEL_OPS + ops.BACKWARD_OPS)
