"""The weight bridge and the port's independence from JAX.

``params_from_jax`` must give exactly the reference keys the JAX package's
``flax_to_torch_keymap`` names (after its match0 bias fix-up), for the tiny
net and for RefVSR_MFID_8K's full widths, and the port's net must take them
with ``load_state_dict(strict=True)``. No module of the port, nor
chip_smoke.py or tests/test_torch_cuda.py, may import jax, flax or
refvsr_tpu, nor PIL, cv2 or imageio, which the card's machine lacks."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refvsr_tpu.models.refvsr import RefVSRNet as JaxNet
from refvsr_tpu.models.refvsr import init_stream_state
from refvsr_tpu.utils.convert import _fix_match0_bias_keys, flax_to_torch_keymap
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.models.refvsr import RefVSRNet, build_refvsr
from refvsr_tpu_torch.utils.convert import (load_reference_state_dict,
                                            params_from_jax)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _init_shapes(num_blocks, mid):
    """The flax param tree of an HD-in scale-4 net, as zero numpy arrays of
    the init shapes (traced with eval_shape; nothing is computed)."""
    net = JaxNet(scale=4, num_blocks=num_blocks, mid_channels=mid,
                 matching_ksize=8, flag_HD_in=True)
    x = jnp.zeros((1, 3, 16, 16, 3))
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.PRNGKey(0), x, x,
        init_stream_state(1, 16, 16, mid, num_frames=3)))["params"]
    return shapes, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.mark.parametrize("num_blocks,mid", [(2, 8), (30, 48)])
def test_params_from_jax_keys_and_strict_load(num_blocks, mid):
    shapes, tree = _init_shapes(num_blocks, mid)
    sd = params_from_jax(tree)
    want = _fix_match0_bias_keys(flax_to_torch_keymap(shapes), sd)
    assert set(sd) == set(want)
    assert ".map128." in " ".join(sd)
    net = RefVSRNet(scale=4, num_blocks=num_blocks, mid_channels=mid,
                    matching_ksize=8, flag_HD_in=True)
    assert set(net.state_dict()) == set(sd)
    net.load_state_dict(sd, strict=True)
    for k, v in net.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


def test_params_from_jax_transposes_kernels():
    tree = {"conv_hr": {"conv": {
        "kernel": np.arange(3 * 3 * 2 * 4, dtype=np.float32).reshape(
            3, 3, 2, 4),
        "bias": np.ones(4, np.float32)}}}
    sd = params_from_jax({"params": tree})
    w = tree["conv_hr"]["conv"]["kernel"]
    assert set(sd) == {"conv_hr.weight", "conv_hr.bias"}
    np.testing.assert_array_equal(sd["conv_hr.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))


def test_load_reference_state_dict_strips_module_prefix():
    net = build_refvsr(get_config("RefVSR_MFID_8K", num_blocks=1,
                                  mid_channels=8), device="cpu", seed=1)
    sd = {"module." + k: v.numpy() * 0 + 0.5
          for k, v in net.state_dict().items()}
    sd["module.sub_mean.weight"] = np.zeros(3, np.float32)  # not held
    fresh = build_refvsr(get_config("RefVSR_MFID_8K", num_blocks=1,
                                    mid_channels=8), device="cpu", seed=2)
    load_reference_state_dict(fresh, sd)
    assert all(bool((v == 0.5).all()) for v in fresh.state_dict().values())


def test_build_refvsr_is_seeded():
    cfg = get_config("RefVSR_MFID_8K", num_blocks=1, mid_channels=8)
    assert (cfg.scale, cfg.flag_HD_in, cfg.matching_ksize) == (4, True, 8)
    a = build_refvsr(cfg, device="cpu", seed=4).state_dict()
    b = build_refvsr(cfg, device="cpu", seed=4).state_dict()
    c = build_refvsr(cfg, device="cpu", seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def _port_files():
    """Every module of the port, and what runs on the card's machine,
    which has neither JAX nor PIL, cv2, imageio, matplotlib or
    tensorboard."""
    files = sorted((ROOT / "refvsr_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "tests/test_torch_cuda.py"]


def test_port_files_include_the_multi_device_modules():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"refvsr_tpu_torch/parallel/__init__.py",
            "refvsr_tpu_torch/parallel/mesh.py",
            "refvsr_tpu_torch/parallel/spatial.py",
            "refvsr_tpu_torch/parallel/serve.py"} <= names


def test_port_files_include_the_bench_and_parity_modules():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"refvsr_tpu_torch/bench/e2e.py",
            "refvsr_tpu_torch/eval/parity_check.py"} <= names


def test_port_files_include_the_serving_slice():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"refvsr_tpu_torch/data/png.py",
            "refvsr_tpu_torch/serving/predictor.py",
            "refvsr_tpu_torch/eval/stream.py"} <= names


def test_port_files_include_the_training_entry_slice():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {f"refvsr_tpu_torch/{m}.py" for m in (
        "configs/__init__", "data/np_ops", "data/datasets", "data/loader",
        "data/prefetch", "train/ckpt", "train/runner", "utils/console",
        "utils/profiling", "utils/events", "run")} <= names


def test_port_files_include_the_ir_and_eval_slice():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {f"refvsr_tpu_torch/{m}.py" for m in (
        "models/edvr", "models/refvsr_ir", "eval/metrics", "eval/runner",
        "data/jpeg", "utils/colormap")} <= names


def test_params_from_jax_loads_the_ir_net():
    """Every leaf of the JAX IR net (EDVR's level-keyed PCD convs, its
    make_layer blocks, mmcv ConvModules' doubled conv, the deformable
    convolutions' own weight and bias) maps to the key the JAX key map
    gives it, and the port's IR net loads the result strictly."""
    from refvsr_tpu.models.refvsr_ir import RefVSRIRNet as JaxIRNet
    from refvsr_tpu_torch.models.refvsr_ir import RefVSRIRNet
    jnet = JaxIRNet(scale=4, num_blocks=1, mid_channels=8,
                    keyframe_stride=2)
    x = jnp.zeros((1, 5, 8, 8, 3))
    r = jnp.zeros((1, 5, 16, 16, 3))
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), x, r, init_stream_state(1, 8, 8, 8,
                                                       num_frames=5),
        np.ones(5, bool)))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    sd = params_from_jax(tree)
    want = _fix_match0_bias_keys(flax_to_torch_keymap(tree["params"]), sd)
    assert set(sd) == set(want)
    dcn = "edvr.pcd_alignment.dcn_pack.l1.weight"
    assert dcn in sd and tuple(sd[dcn].shape) == (64, 64, 3, 3)
    np.testing.assert_array_equal(
        sd[dcn].numpy(), tree["params"]["edvr"]["pcd_alignment"][
            "dcn_pack_l1"]["weight"].transpose(3, 2, 0, 1))
    net = RefVSRIRNet(scale=4, num_blocks=1, mid_channels=8,
                      keyframe_stride=2)
    net.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    banned = {"jax", "jaxlib", "flax", "refvsr_tpu", "PIL", "cv2",
              "imageio", "tensorboard", "matplotlib"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, (path, name)
            # the card's machine has no tensorboard package behind it
            assert not name.startswith("torch.utils.tensorboard"), (path,
                                                                    name)


def test_cuda_entry_points_raise_without_card():
    """Entry points default to the card; without one they raise rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from refvsr_tpu_torch.eval.stream import StreamRunner
    cfg = get_config("RefVSR_MFID_8K", num_blocks=1, mid_channels=8)
    with pytest.raises(RuntimeError):
        build_refvsr(cfg)
    net = build_refvsr(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        StreamRunner(net, None)
