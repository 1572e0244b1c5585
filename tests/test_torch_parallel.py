"""The port's data parallelism (``refvsr_tpu_torch/parallel/mesh.py``) on
gloo CPU ranks: the rank-sharded loaders, the averaged training step, the
train CLI's ``--devices`` and the data-parallel eval.

One spawned group of two ranks runs every multi-rank case (its join has a
timeout of its own): first the eval CLI on the ``torchrun`` environment
(``run.main`` forms and leaves its group), then a group of its own on a
second port for the training windows. The JAX side and the one-process
references run in the pytest process; the ranks hand their results back
through files.

Tolerances, with their reasons:

- the loaders: bit-equal to the JAX package's, which hold the same
  ``order[rank::world]``;
- a window's averaged gradients: relative L2 1e-5 per tensor against one
  process on the concatenated batch of 2, from the same parameters and
  state (the all-reduce adds the ranks' halves in another order than one
  batch's reductions, and the contextual loss's channel mean is summed
  over the ranks, ``mesh.batch_mean``);
- the logged errors: 1e-5 relative, the same sums;
- the parameters: bit-identical across the ranks after every window
  (one all-reduce, one update on equal numbers);
- the updated parameters against the one-process run: 2 x the sum of the
  step rates, since Adam's first steps move an entry by about the rate
  whatever its gradient's size, so an entry whose gradient is near zero
  may move either way;
- the eval's per-frame lines equal the one-rank lines to the printed
  digits (the same per-video streams on one rank each); the global TOTAL
  within 1e-4 of the one-rank TOTAL (float32 sums, as the JAX package)."""

import glob
import json
import os
import re
import warnings

import numpy as np
import pytest
import torch

from conftest import write_clip_triplet
from refvsr_tpu.configs import get_config as jax_get_config
from refvsr_tpu.data.datasets import TrainDataset as JaxTrainDataset
from refvsr_tpu.data.datasets import TrainLoader as JaxTrainLoader
from refvsr_tpu.configs import set_data_path as jax_set_data_path
from refvsr_tpu_torch import run
from refvsr_tpu_torch.configs import get_config, save_config, set_data_path
from refvsr_tpu_torch.data.datasets import TrainDataset, TrainLoader
from refvsr_tpu_torch.data.loader import MultiWorkerLoader
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.refvsr import RefVSRNet, StreamState
from refvsr_tpu_torch.parallel import mesh
from refvsr_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

JOIN_TIMEOUT_S = 240
SMALL = dict(num_blocks=2, mid_channels=8, frame_itr_num=2, patch_size=16,
             spynet_ckpt=None, vgg19_ckpt=None)
DDP_CONFIGS = {
    "RefVSR_MFID": dict(SMALL, frame_num=3),
    "RefVSR_IR_MFID": dict(SMALL, frame_num=5, keyframe_stride=2)}
VIDEOS = (("0003", 3), ("0004", 2), ("0005", 3))
EVAL_TINY = dict(num_blocks=2, mid_channels=8, frame_num=3,
                 spynet_ckpt=None, vgg19_ckpt=None)


def _batch(n, cfg, seed=0):
    rng = np.random.default_rng(seed)
    t_total = cfg.frame_num + cfg.frame_itr_num - 1
    p = cfg.patch_size

    def img(side):
        return rng.random((n, t_total, side, side, 3), dtype=np.float32)
    return {"LR_UW": img(p), "LR_REF_W": img(2 * p), "HR_UW": img(4 * p),
            "HR_REF_W": img(4 * p), "HR_REF_T": img(4 * p)}


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

def _record_windows(trainer, log):
    """Wrap the trainer so that every window logs its inputs, the
    parameters it starts from, the averaged gradients and errors, and the
    parameters after the update."""
    real_step, real_avg = trainer.train_step, trainer.average

    def average(grads, errs):
        g, e = real_avg(grads, errs)
        log[-1]["grads"] = [None if x is None else x.clone() for x in g]
        log[-1]["errs"] = {k: float(v) for k, v in e.items()}
        return g, e

    def train_step(state, lrs, refs, hr, ref_frames, kf=None):
        log.append({"params": [p.detach().clone() for p in trainer.params],
                    "state": {k: v.clone() for k, v in vars(state).items()
                              if torch.is_tensor(v)},
                    "inputs": (lrs.clone(), refs.clone(), hr.clone(),
                               ref_frames.clone()), "kf": kf})
        out = real_step(state, lrs, refs, hr, ref_frames, kf)
        log[-1]["after"] = [p.detach().clone() for p in trainer.params]
        return out
    trainer.average, trainer.train_step = average, train_step


def _ddp_case(name, out_dir):
    cfg = get_config(name, batch_size=2, **DDP_CONFIGS[name])
    tr = Trainer(cfg, device="cpu")
    log = []
    _record_windows(tr, log)
    r = mesh.rank()
    batch = {k: v[r:r + 1] for k, v in _batch(2, cfg).items()}
    means, _ = tr.iteration(batch)
    torch.save({"log": log, "means": means},
               os.path.join(out_dir, f"ddp_{name}_r{r}.pt"))


def _broadcast_case(out_dir):
    """A Trainer seeded differently on each rank: rank 0's values win."""
    cfg = get_config("RefVSR_MFID", batch_size=2, **DDP_CONFIGS[
        "RefVSR_MFID"])
    tr = Trainer(cfg, device="cpu", seed=40 + mesh.rank())
    torch.save([p.detach().clone() for p in tr.net.parameters()],
               os.path.join(out_dir, f"broadcast_r{mesh.rank()}.pt"))


def _group_main(out_dir, eval_argv, port_b):
    torch.set_num_threads(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # absent pretrained assets
        run.main(eval_argv)
        os.environ["MASTER_PORT"] = str(port_b)
        mesh.init_from_env("cpu")
        try:
            _broadcast_case(out_dir)
            for name in DDP_CONFIGS:
                _ddp_case(name, out_dir)
        finally:
            mesh.destroy()
    return "ok"


# ---------------------------------------------------------------------------
# the group, once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """Three test videos of 3, 2 and 3 frames (HD-in 64x64), a tiny
    RefVSR_MFID_8K config.json and its seeded checkpoint."""
    root = tmp_path_factory.mktemp("dp_eval")
    for i, (clip, n) in enumerate(VIDEOS):
        for j, cam in enumerate(("UW", "W", "T")):
            write_clip_triplet(root / "RealMCVSR", "test", cam, clip, n, 16,
                               16, seed=10 * i + j)
    net = RefVSRNet(scale=4, num_blocks=2, mid_channels=8,
                    matching_ksize=8, flag_HD_in=True)
    init_weights(net, torch.Generator().manual_seed(3))
    cfg = get_config("RefVSR_MFID_8K", mode="tiny8k", **EVAL_TINY)
    save_config(cfg, str(root / "logs" / "RefVSR_TPU" / "tiny8k" / "config"
                         / "config.json"))
    torch.save(net.state_dict(), str(root / "tiny8k.pytorch"))
    return root


def _eval_argv(root, out):
    return ["--mode", "tiny8k", "-cpu", "--data_offset", str(root),
            "--log_offset", str(root / "logs"), "--output_offset", str(out),
            "--ckpt_abs_name", str(root / "tiny8k.pytorch"),
            "--quantitative_only"]


@pytest.fixture(scope="module")
def group(eval_tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_group")
    res = mesh.spawn(_group_main, (str(out), _eval_argv(eval_tree,
                                                        out / "eval2"),
                                   mesh.free_port()), 2, JOIN_TIMEOUT_S)
    assert res == "ok"
    return out


# ---------------------------------------------------------------------------
# loaders (no group needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (3, 2)])
def test_loaders_shard_like_jax(fake_dataset, world, rank):
    kw = dict(batch_size=1, patch_size=16, frame_num=3, frame_itr_num=2,
              data_offset=fake_dataset)
    cj = jax_set_data_path(jax_get_config("RefVSR_MFID", **kw), True)
    ct = set_data_path(get_config("RefVSR_MFID", **kw), True)
    want = list(JaxTrainLoader(JaxTrainDataset(cj), 1, seed=5,
                               world_size=world, rank=rank))
    ds = TrainDataset(ct)
    one = TrainLoader(ds, 1, seed=5, world_size=world, rank=rank)
    many = MultiWorkerLoader(ds, 1, seed=5, num_workers=2,
                             world_size=world, rank=rank)
    try:
        for loader in (one, many):
            got = list(loader)
            assert len(got) == len(want)
            for b_got, b_want in zip(got, want):
                for k in ("LR_UW", "LR_REF_W", "HR_UW", "HR_REF_T"):
                    np.testing.assert_array_equal(b_got[k], b_want[k])
        n = len(ds)
        assert len(one) == len(many) == -(-n // world)
    finally:
        many.close()


# ---------------------------------------------------------------------------
# the averaged training step
# ---------------------------------------------------------------------------

def _rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _load_ranks(group, name):
    return [torch.load(str(group / f"ddp_{name}_r{r}.pt"),
                       weights_only=False) for r in (0, 1)]


@pytest.mark.parametrize("name", list(DDP_CONFIGS))
def test_ddp_window_gradients_match_one_process(group, name):
    """Each window's averaged gradients and errors against one process on
    the concatenated batch, from the window's own parameters and state."""
    r0, r1 = _load_ranks(group, name)
    cfg = get_config(name, batch_size=2, **DDP_CONFIGS[name])
    ref = Trainer(cfg, device="cpu")
    for w, (a, b) in enumerate(zip(r0["log"], r1["log"])):
        with torch.no_grad():
            for p, v in zip(ref.params, a["params"]):
                p.copy_(v)
        state = StreamState(**{k: torch.cat([a["state"][k], b["state"][k]])
                               for k in a["state"]})
        ins = [torch.cat([x, y]) for x, y in zip(a["inputs"], b["inputs"])]
        errs, _, _, grads = ref.gradients(state, *ins, a["kf"])
        for i, (g, gw) in enumerate(zip(a["grads"], grads)):
            assert (g is None) == (gw is None), (w, i)
            if g is not None and float(gw.abs().max()) > 0:
                assert _rel_l2(g, gw) <= 1e-5, (w, i, _rel_l2(g, gw))
        for k, v in a["errs"].items():
            np.testing.assert_allclose(v, float(errs[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{w} {k}")


@pytest.mark.parametrize("name", list(DDP_CONFIGS))
def test_ddp_parameters_stay_identical_across_ranks(group, name):
    r0, r1 = _load_ranks(group, name)
    assert len(r0["log"]) == len(r1["log"]) == 2
    for a, b in zip(r0["log"], r1["log"]):
        for key in ("params", "after"):
            for x, y in zip(a[key], b[key]):
                assert torch.equal(x, y)
        assert a["errs"] == b["errs"]
    assert r0["means"] == r1["means"]


def test_trainer_broadcasts_rank0_parameters(group):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = Trainer(get_config("RefVSR_MFID", batch_size=2,
                                  **DDP_CONFIGS["RefVSR_MFID"]),
                       device="cpu", seed=40)
        other = Trainer(get_config("RefVSR_MFID", batch_size=2,
                                   **DDP_CONFIGS["RefVSR_MFID"]),
                        device="cpu", seed=41)
    ranks = [torch.load(str(group / f"broadcast_r{r}.pt")) for r in (0, 1)]
    params = [p.detach() for p in want.net.parameters()]
    assert not all(torch.equal(a, b) for a, b in zip(
        params, other.net.parameters()))         # the seeds do differ
    for got in ranks:
        assert all(torch.equal(a, b) for a, b in zip(got, params))


@pytest.mark.parametrize("name", list(DDP_CONFIGS))
def test_ddp_iteration_matches_one_process(group, name):
    r0, _ = _load_ranks(group, name)
    cfg = get_config(name, batch_size=2, **DDP_CONFIGS[name])
    ref = Trainer(cfg, device="cpu")
    means, _ = ref.iteration(_batch(2, cfg))
    for k, v in means.items():
        np.testing.assert_allclose(r0["means"][k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    limit = 2 * sum(float(ref.schedule(s)) for s in range(ref.opt.step))
    for p, q in zip(r0["log"][-1]["after"], ref.params):
        assert float((p - q).abs().max()) <= limit


# ---------------------------------------------------------------------------
# the data-parallel eval
# ---------------------------------------------------------------------------

_SEC = re.compile(r"\(\d+\.\d+sec\)")


def _lines(path):
    with open(path) as f:
        return [_SEC.sub("(sec)", ln) for ln in f.read().splitlines()]


def _frame_lines(lines):
    return [ln for ln in lines if ln.startswith("[EVAL ")]


def _total(lines):
    (ln,) = [ln for ln in lines if ln.startswith("[TOTAL")]
    return ln, [float(v) for v in re.findall(r"(?:PSNR|SSIM): (-?\d+\.\d+)",
                                             ln)]


def test_data_parallel_eval_matches_one_rank(group, eval_tree, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = run.main(_eval_argv(eval_tree, tmp_path / "one"))
    (d1,) = glob.glob(str(tmp_path / "one" / "RealMCVSR" / "*"))
    (d2,) = glob.glob(str(group / "eval2" / "RealMCVSR" / "*"))
    want = _lines(os.path.join(d1, "score_RealMCVSR_quan_qual.txt"))
    parts = [_lines(os.path.join(d2, f"score_RealMCVSR_quan_qual_p{r}.txt"))
             for r in (0, 1)]
    # rank r holds the videos whose index is r modulo 2: 0003 and 0005 on
    # rank 0, 0004 on rank 1, each with the one-rank run's lines
    assert sorted(_frame_lines(parts[0]) + _frame_lines(parts[1])) == \
        sorted(_frame_lines(want))
    assert all("|0004]" in ln for ln in _frame_lines(parts[1]))
    for p in parts:
        assert "(shard p" in _total(p)[0]
    glob_lines = _lines(os.path.join(d2, "score_RealMCVSR_quan_qual.txt"))
    line, vals = _total(glob_lines)
    _, want_vals = _total(want)
    assert "shard" not in line
    np.testing.assert_allclose(vals, want_vals, atol=1e-4)
    assert one["frames"] == 8


# ---------------------------------------------------------------------------
# the train CLI's --devices
# ---------------------------------------------------------------------------

TRAIN_TINY = dict(patch_size=16, frame_num=3, frame_itr_num=2, num_blocks=2,
                  mid_channels=8, reset_branch=2, loss="1*L1_lf",
                  write_ckpt_every_epoch=1, write_log_every_itr_train=2,
                  spynet_ckpt=None, vgg19_ckpt=None)


def _tiny_train_main(argv, writes_file):
    """A rank of the spawned train CLI with the tiny config; rank 1 records
    every file it opens for writing."""
    import builtins

    import refvsr_tpu_torch.configs as configs
    torch.set_num_threads(1)
    real = configs.get_config
    configs.get_config = lambda name, **kw: real(name, **dict(kw,
                                                              **TRAIN_TINY))
    opened = []
    if os.environ.get("RANK") == "1":
        real_open = builtins.open

        def spy(file, mode="r", *a, **k):
            if any(c in mode for c in "wax+"):
                opened.append(str(file))
            return real_open(file, mode, *a, **k)
        builtins.open = spy
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run.main(argv)
    if os.environ.get("RANK") == "1":
        builtins.open = real_open
        with open(writes_file, "w") as f:
            json.dump(opened, f)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  .split("events.out")[0]
                  for d, _, fs in os.walk(root) for f in fs)


def test_train_cli_devices_writes_one_rank_tree(fake_dataset, tmp_path,
                                                monkeypatch):
    writes = str(tmp_path / "rank1_writes.json")
    real_spawn = mesh.spawn

    def spawn(fn, args, world, timeout_s=None):
        assert fn is run.main and world == 2 and timeout_s is None
        return real_spawn(_tiny_train_main, (args[0], writes), world,
                          JOIN_TIMEOUT_S)
    monkeypatch.setattr(mesh, "spawn", spawn)
    argv = ["--is_train", "-cpu", "--config", "config_RefVSR_MFID",
            "--mode", "tiny", "-b", "2", "-th", "0", "--data_offset",
            fake_dataset, "--total_itr", "4"]
    assert run.main(argv + ["--devices", "2", "--log_offset",
                            str(tmp_path / "two")]) is None
    with open(writes) as f:
        assert json.load(f) == []
    import refvsr_tpu_torch.configs as configs
    real = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda name, **kw: real(
        name, **dict(kw, **TRAIN_TINY)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = run.main(argv + ["--log_offset", str(tmp_path / "one")])
    log_two = os.path.join(str(tmp_path / "two"), "RefVSR_TPU", "tiny")
    assert _tree(log_two) == _tree(one.config.log_dir)
    assert any(f.endswith("checkpoints.txt") for f in _tree(log_two))


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (3, "gloo")])
def test_backend_rule(monkeypatch, world, backend):
    """nccl when each rank has a card of its own, gloo when they share
    one; the CPU is always gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.choose_backend("cuda", world) == backend
    assert mesh.choose_backend("cpu", world) == "gloo"


def test_parts_split_rows_evenly_or_by_floor():
    assert [mesh.part(1080, 4, k) for k in range(4)] == [
        (0, 270), (270, 540), (540, 810), (810, 1080)]
    assert [mesh.part(270, 4, k) for k in range(4)] == [
        (0, 67), (67, 135), (135, 202), (202, 270)]
