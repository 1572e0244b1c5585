"""The port's checkpoint manager against the JAX package's, on the CPU.

The same sequence of saves (epochs and scores, with ties and rotation at
``max_files_to_keep=2``), then a resume prune, leaves a byte-equal
``checkpoints.txt`` and the same files in both; loading by score, recency,
name and epoch picks the same entry; what is saved comes back bit for bit
(the files are ``torch.save`` archives in the port, flax msgpack in JAX)."""

import os
import warnings

import numpy as np
import pytest
import torch

from refvsr_tpu.train.ckpt import CkptManager as JaxCkptManager
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.models.refvsr import build_refvsr
from refvsr_tpu_torch.train.ckpt import CkptManager

# (epoch, score): a new best, a worse one, a tie, a new best that rotates
# the worst out, and a worst one that is only kept as the most recent
SAVES = [(0, 30.5), (1, 29.25), (2, 30.5), (3, 31.0), (4, 12.0), (5, 30.75)]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _pair(tmp_path, saves, keep=2):
    jax_mgr = JaxCkptManager(str(tmp_path / "jax"), "m",
                             max_files_to_keep=keep)
    mgr = CkptManager(str(tmp_path / "port"), "m", max_files_to_keep=keep)
    for epoch, score in saves:
        jax_mgr.save({"w": np.full(3, epoch, np.float32)},
                     {"step": np.int32(epoch), "epoch": epoch}, epoch, score)
        mgr.save({"w": torch.full((3,), float(epoch))},
                 {"step": epoch, "epoch": epoch}, epoch, score)
    return jax_mgr, mgr


def _lines(mgr):
    with open(mgr.list_path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n_saves", [1, 3, len(SAVES)])
def test_checkpoints_txt_matches_jax(tmp_path, n_saves):
    jax_mgr, mgr = _pair(tmp_path, SAVES[:n_saves])
    assert _lines(mgr) == _lines(jax_mgr)
    assert _files(mgr.root_dir) == _files(jax_mgr.root_dir)


@pytest.mark.parametrize("resume_epoch", [0, 2, 3, 5])
def test_resume_prune_matches_jax(tmp_path, resume_epoch):
    jax_mgr, mgr = _pair(tmp_path, SAVES, keep=4)
    jax_mgr.resume_prune(resume_epoch)
    mgr.resume_prune(resume_epoch)
    assert _lines(mgr) == _lines(jax_mgr)
    assert _files(mgr.root_dir) == _files(jax_mgr.root_dir)


@pytest.mark.parametrize("how", [dict(), dict(by_score=False),
                                 dict(name="m_00005.ckpt"), dict(epoch=3)])
def test_load_picks_the_jax_entry(tmp_path, how):
    jax_mgr, mgr = _pair(tmp_path, SAVES, keep=4)
    _, want = jax_mgr.load_params({"w": np.zeros(3, np.float32)}, **how)
    net = torch.nn.Module()
    net.register_buffer("w", torch.zeros(3))
    got = mgr.load_params(net, **how)
    assert got == want
    epoch = int(want.split("_")[1].split(".")[0])
    assert torch.equal(net.w, torch.full((3,), float(epoch)))


def test_state_round_trips_bit_for_bit(tmp_path):
    cfg = get_config("RefVSR_MFID_8K", num_blocks=1, mid_channels=8)
    net = build_refvsr(cfg, device="cpu", seed=3)
    sd = net.state_dict()
    gen = torch.Generator().manual_seed(0)
    state = {"mu": [torch.randn(p.shape, generator=gen)
                    for p in net.parameters()],
             "nu": [torch.rand(p.shape, generator=gen)
                    for p in net.parameters()],
             "step": 9, "epoch": 0}
    mgr = CkptManager(str(tmp_path), "m")
    mgr.save(sd, state, 0, 27.5)
    fresh = build_refvsr(cfg, device="cpu", seed=4)
    assert mgr.load_params(fresh, epoch=0) == "m_00000.ckpt"
    got = fresh.state_dict()
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    back = mgr.load_train_state(0)
    assert (back["step"], back["epoch"]) == (9, 0)
    for k in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(back[k], state[k]))


def test_reference_checkpoint_warns_on_unmapped_keys(tmp_path):
    """A .pytorch state dict loads through the converter; keys that map to
    nothing warn, as in the JAX manager."""
    cfg = get_config("RefVSR_MFID_8K", num_blocks=1, mid_channels=8)
    src = build_refvsr(cfg, device="cpu", seed=3).state_dict()
    path = tmp_path / "ref.pytorch"
    torch.save({"module." + k: v for k, v in src.items()}, path)
    net = build_refvsr(cfg, device="cpu", seed=4)
    mgr = CkptManager(str(tmp_path / "run"), "m")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert mgr.load_params(net, abs_path=str(path)) == "ref.pytorch"
    assert all(torch.equal(v, src[k]) for k, v in net.state_dict().items())
    torch.save(dict(src, **{"bogus.weight": torch.zeros(1)}), path)
    with pytest.warns(UserWarning, match="did not fully map"):
        mgr.load_params(net, abs_path=str(path))
