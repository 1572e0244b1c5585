"""The port's reference-checkpoint parity command
(``python -m refvsr_tpu_torch.eval.parity_check``) beside the JAX package's
``scripts/parity_check.py`` on the same tree and checkpoint, on the CPU in
f32.

The tree: a RealMCVSR test split of two videos (3 and 2 frames; LRx4
16x16, LRx2 32x32, HR 64x64) written by PIL. The checkpoint: the port's
seeded net of the config, saved as a reference-keyed ``.pytorch`` state
dict. The config named on the command line gets a tiny width in both
packages' ``get_config`` (2 blocks, 8 channels, T = 3, f32): the default
``RefVSR_small_L1`` (LRx4 input) and ``RefVSR_MFID_8K`` (HD input, scored
after the bicubic 1/4 downscale). The JAX Trainer's ``init_state`` only
shapes the parameters (``tests/test_torch_eval_cli.py``); the checkpoint
fills every leaf.

Compared: the ``converted`` counts and the ``MISSING``/``UNUSED`` keys
equal (the JAX script names a missing key by its flax path and the torch
key it wanted, the port by the torch key); every per-frame, ``[MEAN ...]``
and ``[TOTAL] ...`` line equal apart from its numbers, and PSNR/SSIM within
1e-4 (outputs within ~1e-6 of each other, as the net tests hold; the
metrics are float64 of those); the ``--max_frames`` cap; a checkpoint with
one key renamed, listed as MISSING and UNUSED by both; ``--save_converted``
writing a ``torch.save`` state dict equal to the checkpoint."""

import importlib.util
import os
import re
import sys
import warnings

import numpy as np
import pytest
import torch

import refvsr_tpu.configs as jax_configs
from conftest import write_clip_triplet
from refvsr_tpu.train import trainer as jax_trainer
from refvsr_tpu_torch import configs
from refvsr_tpu_torch.eval import parity_check
from refvsr_tpu_torch.models.refvsr import build_refvsr
from test_torch_eval_cli import _shape_only_init_state

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEOS = (("0007", 3), ("0008", 2))
TINY = dict(num_blocks=2, mid_channels=8, frame_num=3, is_amp=False)
CONFIGS = ("RefVSR_small_L1", "RefVSR_MFID_8K")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_check", os.path.join(ROOT, "scripts", "parity_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity_check")
    for i, (clip, n) in enumerate(VIDEOS):
        for j, cam in enumerate(("UW", "W", "T")):
            write_clip_triplet(root / "RealMCVSR", "test", cam, clip, n, 16,
                               16, seed=20 * i + j)
    for name in CONFIGS:
        net = build_refvsr(configs.get_config(name, **TINY), device="cpu",
                           seed=11)
        sd = net.state_dict()
        torch.save(sd, str(root / f"{name}.pytorch"))
        # one key renamed: MISSING under its own name, UNUSED under the new
        renamed = {("renamed." + k if i == 5 else k): v
                   for i, (k, v) in enumerate(sd.items())}
        torch.save(renamed, str(root / f"{name}_renamed.pytorch"))
    return root


def _tiny(get):
    def get_config(name, **kw):
        return get(name, **{**kw, **TINY})
    return get_config


_RUNS = {}


def _run(tree, capsys, name, *extra, ckpt=None):
    """(JAX script's lines, port's lines) of one command on the tree."""
    key = (name, ckpt) + extra
    if key in _RUNS:
        return _RUNS[key]
    args = [str(tree / f"{ckpt or name}.pytorch"), str(tree), "--config",
            name, "--output_offset", str(tree / "out"), *extra]
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_configs, "get_config",
                       _tiny(jax_configs.get_config))
            mp.setattr(configs, "get_config", _tiny(configs.get_config))
            mp.setattr(jax_trainer.Trainer, "init_state",
                       _shape_only_init_state)
            mp.setattr(sys, "argv", ["parity_check.py", *args])
            capsys.readouterr()
            _jax_script().main()
            out.append(capsys.readouterr().out)
            parity_check.main([*args, "-cpu"])
            out.append(capsys.readouterr().out)
    _RUNS[key] = tuple([ln for ln in text.splitlines()
                        if ln.startswith(("converted:", "  MISSING",
                                          "  UNUSED", "["))]
                       for text in out)
    return _RUNS[key]


_COUNTS = re.compile(r"converted: (\d+) torch tensors; missing [a-z ]+: "
                     r"(\d+), unused torch keys: (\d+)$")
_MISSING_JAX = re.compile(r"  MISSING \S+ \(wanted (\S+)\)$")
_NUM = re.compile(r"(PSNR: |SSIM: )(-?\d+\.\d+)")


def _keys(lines, jax_side):
    counts = [tuple(int(v) for v in _COUNTS.match(ln).groups())
              for ln in lines if ln.startswith("converted:")]
    missing = [(_MISSING_JAX.match(ln).group(1) if jax_side else
                ln[len("  MISSING "):]) for ln in lines
               if ln.startswith("  MISSING")]
    unused = [ln for ln in lines if ln.startswith("  UNUSED")]
    return counts, missing, unused


def _compare_scores(want, got):
    want = [ln for ln in want if ln.startswith("[")]
    got = [ln for ln in got if ln.startswith("[")]
    assert len(got) == len(want)
    for lw, lg in zip(want, got):
        assert _NUM.sub(r"\1#", lw) == _NUM.sub(r"\1#", lg)
        np.testing.assert_allclose(
            [float(v) for _, v in _NUM.findall(lg)],
            [float(v) for _, v in _NUM.findall(lw)], rtol=0, atol=1e-4,
            err_msg=lw)
    return got


@pytest.mark.parametrize("name", CONFIGS)
def test_key_report_matches_jax(tree, capsys, name):
    want, got = _run(tree, capsys, name)
    (counts_j, missing_j, unused_j) = _keys(want, True)
    (counts_t, missing_t, unused_t) = _keys(got, False)
    assert counts_t == counts_j and len(counts_t) == 1
    assert counts_t[0][1:] == (0, 0)
    assert missing_t == missing_j == [] and unused_t == unused_j == []


@pytest.mark.parametrize("name", CONFIGS)
def test_scores_match_jax(tree, capsys, name):
    want, got = _run(tree, capsys, name)
    got = _compare_scores(want, got)
    n = sum(f for _, f in VIDEOS)
    assert sum(not ln.startswith(("[MEAN", "[TOTAL")) for ln in got) == n
    assert [ln[:11] for ln in got if ln.startswith("[MEAN")] == [
        "[MEAN 0007]", "[MEAN 0008]"]
    assert got[-1].startswith("[TOTAL] PSNR: ")
    assert got[-1].endswith(f"({n} frames)")


def test_max_frames_cap_matches_jax(tree, capsys):
    want, got = _run(tree, capsys, CONFIGS[0], "--max_frames", "4")
    got = _compare_scores(want, got)
    assert got[-1].endswith("(4 frames)")
    # the cap cuts the second video after its first frame
    assert sum(ln.startswith("[0008]") for ln in got) == 1


def test_renamed_key_is_missing_and_unused(tree, capsys):
    name = CONFIGS[0]
    want, got = _run(tree, capsys, name, "--max_frames", "0",
                     ckpt=f"{name}_renamed")
    (counts_j, missing_j, unused_j) = _keys(want, True)
    (counts_t, missing_t, unused_t) = _keys(got, False)
    assert counts_t == counts_j
    assert counts_t[0][1:] == (1, 1)
    sd = torch.load(str(tree / f"{name}.pytorch"), weights_only=True)
    key = list(sd)[5]
    assert missing_t == missing_j == [key]
    assert unused_t == unused_j == [f"  UNUSED  renamed.{key}"]
    assert not [ln for ln in got if ln.startswith("[")]


def test_save_converted_writes_the_state_dict(tree, capsys):
    name = CONFIGS[0]
    path = tree / "converted.pt"
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("ignore")
        mp.setattr(configs, "get_config", _tiny(configs.get_config))
        parity_check.main([str(tree / f"{name}.pytorch"), str(tree),
                           "--config", name, "--output_offset",
                           str(tree / "out"), "--max_frames", "0",
                           "--save_converted", str(path), "-cpu"])
    assert f"saved converted state dict -> {path}" in capsys.readouterr().out
    saved = torch.load(str(path), weights_only=True)
    ckpt = torch.load(str(tree / f"{name}.pytorch"), weights_only=True)
    assert set(saved) == set(ckpt)
    assert all(torch.equal(saved[k], ckpt[k]) for k in ckpt)
