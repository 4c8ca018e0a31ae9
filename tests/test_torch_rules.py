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
from aanet_torch import cli, infer
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


@pytest.mark.parametrize(
    "overrides",
    [dict(MODEL_PRESETS[name].__dict__) for name in sorted(MODEL_PRESETS) if name != "aanet"]
    + [dict(dtype="bfloat16"), dict(feature_similarity="difference")],
)
def test_build_refuses_what_the_port_does_not_run(overrides):
    with pytest.raises(NotImplementedError):
        dataclasses.replace(ModelConfig(feature_pyramid_network=True), **overrides).build()


def test_forward_refuses_training_mode():
    model = dataclasses.replace(preset("aanet"), **CUT).build()
    img = torch.zeros(1, 3, 48, 96)
    with pytest.raises(NotImplementedError, match="eval"):
        model(img, img)


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
    assert [op.launches for op in KERNEL_OPS] == [0, 0, 0, 0]


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
