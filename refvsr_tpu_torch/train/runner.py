"""Training orchestrator: the epoch loop, validation, scalars and
checkpoints on validation PSNR; counterpart of
``refvsr_tpu/train/runner.py`` (the reference's run.py Runner).

Kept from the JAX Runner: one epoch is one pass of the loader, each batch
one ``Trainer.iteration`` (``frame_itr_num`` optimizer steps); the train
line and the ``train_itr/*`` scalars every ``write_log_every_itr_train``
steps; per-epoch means as ``train_epoch/*``; every
``write_ckpt_every_epoch`` epochs (and at the last step) a streaming
validation PSNR, ``valid_epoch/PSNR`` and a checkpoint scored by it;
``resume(epoch)`` and ``resume_abs(path)``; training stops at
``total_itr``. The run's log tree: ``config/config.json``,
``source_snapshot/``, ``cost.txt`` (the parameter count),
``log/train/scalar/`` (TensorBoard events, written by ``utils/events.py``)
and ``checkpoint/train/epoch/`` (``train/ckpt.py``), with the sample tiles
under ``sample/valid/`` when ``save_sample``.

Data parallelism (a process group of more than one rank, as the JAX
Runner's process count): each rank reads its shard of the epoch
(``order[rank::world]``) in batches of ``batch_size // world``, and every
rank stops at the batch count of the smallest shard, so that no rank
waits in a collective for a batch another rank does not have. The log
tree (config, sources, ``cost.txt``, TensorBoard, checkpoints, sample
tiles) and the console lines are rank 0's alone; every rank validates and
resumes. The Trainer needs no batch to initialise, so the Runner draws
none; the batches are the same, since each sample has its own rng."""

from __future__ import annotations

import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from refvsr_tpu_torch import resolve_device
from refvsr_tpu_torch.configs import Config, save_config
from refvsr_tpu_torch.data.datasets import (TestDataset, TrainDataset,
                                            TrainLoader)
from refvsr_tpu_torch.data.loader import MultiWorkerLoader
from refvsr_tpu_torch.data.np_ops import np_resize
from refvsr_tpu_torch.data.png import write_image
from refvsr_tpu_torch.data.prefetch import prefetch
from refvsr_tpu_torch.eval.stream import StreamRunner
from refvsr_tpu_torch.losses import cx_options
from refvsr_tpu_torch.parallel import mesh
from refvsr_tpu_torch.train.ckpt import CkptManager
from refvsr_tpu_torch.train.trainer import Trainer
from refvsr_tpu_torch.utils.console import (end_status, format_train_line,
                                            print_status)
from refvsr_tpu_torch.utils.events import EventWriter
from refvsr_tpu_torch.utils.profiling import write_cost_report


def _norm_res_vis(m):
    m = m - m.min()
    return m / max(m.max(), 1e-12)


class Runner:
    """Trains `config` on `device` (the card unless the caller asks for the
    CPU); ``thread_num > 0`` reads the data with that many worker
    processes."""

    def __init__(self, config: Config, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        world, rank = mesh.world_size(), mesh.rank()
        if config.batch_size % world:
            raise SystemExit(
                f"batch_size {config.batch_size} not divisible by the "
                f"{world}-device data mesh (pass -b or --devices)")
        self.is_main = rank == 0
        self.trainer = Trainer(config, device=self.device)
        self.train_ds = TrainDataset(config)
        self.valid_ds = TestDataset(config, is_valid=True)
        per_rank = config.batch_size // world
        kw = dict(seed=config.manual_seed, world_size=world, rank=rank)
        if config.thread_num > 0:
            self.loader = MultiWorkerLoader(
                self.train_ds, per_rank, num_workers=config.thread_num, **kw)
        else:
            self.loader = TrainLoader(self.train_ds, per_rank, **kw)
        # the smallest shard's batches: every rank takes as many steps
        self.n_batches = (len(self.train_ds) // world) // per_rank
        self.ckpt = CkptManager(
            os.path.join(config.log_dir, "checkpoint", "train", "epoch"),
            config.mode, max_files_to_keep=config.max_ckpt_num)
        if self.is_main:
            Path(config.log_dir).mkdir(parents=True, exist_ok=True)
            save_config(config, os.path.join(config.log_dir, "config",
                                             "config.json"))
            self._snapshot_sources()
            write_cost_report(os.path.join(config.log_dir, "cost.txt"),
                              self.trainer.net)
        self._tb = None
        self.epoch0 = 0

    def _snapshot_sources(self):
        """Copy the model and trainer sources into the log dir, so a run's
        code can be reconstructed."""
        import refvsr_tpu_torch.models.refvsr as m_refvsr
        import refvsr_tpu_torch.models.refvsr_ir as m_ir
        import refvsr_tpu_torch.train.trainer as m_trainer
        dst = Path(self.config.log_dir) / "source_snapshot"
        dst.mkdir(parents=True, exist_ok=True)
        for mod in (m_refvsr, m_ir, m_trainer):
            shutil.copy2(mod.__file__, dst / os.path.basename(mod.__file__))

    class _NullWriter:
        def add_scalar(self, *a, **k):
            pass

        def close(self):
            pass

    @property
    def tb(self):
        if self._tb is None and not self.is_main:
            self._tb = Runner._NullWriter()
        if self._tb is None:
            self._tb = EventWriter(os.path.join(self.config.log_dir, "log",
                                                "train", "scalar"))
        return self._tb

    def close(self):
        """Stop the data workers and close the event file."""
        if isinstance(self.loader, MultiWorkerLoader):
            self.loader.close()
        if self._tb is not None:
            self._tb.close()

    # ---------------- resume ----------------

    def resume(self, epoch: int):
        """Continue from the checkpoint of `epoch`: the net, the Adam
        moments and the step; entries newer than it are removed."""
        self.ckpt.load_params(self.trainer.net, epoch=epoch)
        state = self.ckpt.load_train_state(epoch)
        opt = self.trainer.opt
        with torch.no_grad():
            for dst, src in zip(opt.mu + opt.nu, state["mu"] + state["nu"]):
                dst.copy_(src)
        opt.step = int(state["step"])
        self.epoch0 = int(state["epoch"]) + 1
        # every rank has read the checkpoint before rank 0 prunes the list
        mesh.barrier(self.device)
        if self.is_main:
            self.ckpt.resume_prune(epoch)

    def resume_abs(self, path: str):
        """Start from the network weights at `path` (a checkpoint of this
        package or a reference ``.pytorch``), with a fresh optimizer."""
        self.ckpt.load_params(self.trainer.net, abs_path=path)

    # ---------------- train ----------------

    def _train_state(self, epoch):
        opt = self.trainer.opt
        return {"mu": [m.detach().cpu() for m in opt.mu],
                "nu": [v.detach().cpu() for v in opt.nu],
                "step": opt.step, "epoch": epoch}

    def train(self, max_epochs: int | None = None, max_itr: int | None = None):
        """Train from ``epoch0`` for `max_epochs` epochs (default: as many
        as ``total_itr`` needs), stopping at `max_itr` (default
        ``total_itr``) steps. Returns the trainer."""
        cfg = self.config
        tr = self.trainer
        total_itr = max_itr or cfg.total_itr
        itr_per_epoch = max(1, self.n_batches * cfg.frame_itr_num)
        n_epochs = max_epochs or max(1, -(-total_itr // itr_per_epoch))

        for epoch in range(self.epoch0, n_epochs):
            self.loader.set_epoch(epoch)
            t0 = time.time()
            train_errs, n_batches = {}, 0
            t_batch = time.time()
            for batch in prefetch(self.loader, depth=2):
                if n_batches == self.n_batches:
                    break
                errs, _ = tr.iteration(batch)
                n_batches += 1
                for k, v in errs.items():
                    train_errs[k] = train_errs.get(k, 0.0) + v
                itr = tr.opt.step
                if self.is_main and itr % max(
                        1, cfg.write_log_every_itr_train) < \
                        cfg.frame_itr_num:
                    print_status(format_train_line(
                        cfg.mode, epoch, itr, itr_per_epoch, errs,
                        tr.current_lr(), time.time() - t_batch))
                    for k, v in errs.items():
                        self.tb.add_scalar(f"train_itr/{k}", v, itr)
                t_batch = time.time()
                if itr >= total_itr:
                    break
            train_errs = {k: v / max(n_batches, 1)
                          for k, v in train_errs.items()}
            for k, v in train_errs.items():
                self.tb.add_scalar(f"train_epoch/{k}", v, epoch)
            self.tb.add_scalar("train_epoch/lr", tr.current_lr(), epoch)

            if (epoch + 1) % cfg.write_ckpt_every_epoch == 0 or \
                    tr.opt.step >= total_itr:
                val_psnr = self.validate()
                self.tb.add_scalar("valid_epoch/PSNR", val_psnr, epoch)
                if self.is_main:
                    self.ckpt.save(
                        {k: v.detach().cpu()
                         for k, v in tr.net.state_dict().items()},
                        self._train_state(epoch), epoch, val_psnr)
            if self.is_main:
                end_status()
                print(f"[epoch {epoch}] itr={tr.opt.step} "
                      f"{ {k: round(v, 5) for k, v in train_errs.items()} } "
                      f"({time.time() - t0:.1f}s)")
            if tr.opt.step >= total_itr:
                break
        return tr

    # ---------------- validate ----------------

    def _warped_ref_vis(self, item, t):
        """'FW_aa2_fm_ref_aligned' sample tile: the ref image warped onto
        the 2x canvas by the matching's index map (RefVSR.py:305), in f32
        on the trained weights."""
        net = self.trainer.net

        def frame(key):
            return torch.as_tensor(item[key][None, t // 2]).to(self.device)
        lr, ref = frame("LR_UW"), frame("LR_REF_W")
        with torch.inference_mode():
            _, idx = net.feature_match(lr, ref)
            out = net.aa2(lr, ref, idx, ref, return_fm=True)
        return out[0].float().cpu().numpy()

    def _loss_cx_vis(self, item, sr, t):
        """The loss's contextual confidence tiles (LossModule.vis_maps) on a
        centre crop the size of a training patch (the CX cost grows with the
        square of the feature positions); each crop covers the same region
        at its tensor's own resolution."""
        cfg = self.config
        loss_mod = self.trainer.loss_mod
        if not any(cx_options(lt) for _, lt in loss_mod.terms):
            return []
        sr_h, sr_w = sr.shape[0], sr.shape[1]
        tgt = 4 * cfg.patch_size

        def crop(a):
            h, w = a.shape[-3:-1]
            ch, cw = min(h, tgt * h // sr_h), min(w, tgt * w // sr_w)
            y, x = (h - ch) // 2, (w - cw) // 2
            return torch.as_tensor(np.ascontiguousarray(
                a[..., y:y + ch, x:x + cw, :])[None]).to(self.device)

        ref_key = "HR_REF_T" if cfg.is_use_T else "HR_REF_W"
        with torch.inference_mode():
            maps = loss_mod.vis_maps(crop(sr), crop(item["HR_UW"][t // 2]),
                                     crop(item[ref_key][:t]))
        return [(k, v[0, ..., 0].float().cpu().numpy())
                for k, v in maps.items()]

    def _save_samples(self, i, item, out, gt, conf, t):
        sample_dir = os.path.join(self.config.log_dir, "sample", "valid")
        conf_bw, conf_fw, conf_match = [
            c[0, ..., 0].float().cpu().numpy() for c in conf]
        tiles = [("SR", out), ("HR", gt), ("LR", item["LR_UW"][t // 2]),
                 ("conf_map_norm", _norm_res_vis(conf_match)),
                 ("conf_map_prop_backward_norm", _norm_res_vis(conf_bw)),
                 ("conf_map_prop_forward_norm", _norm_res_vis(conf_fw)),
                 ("conf_map_prop_norm",
                  _norm_res_vis(np.maximum(conf_bw, conf_fw))),
                 ("FW_aa2_fm_ref_aligned", self._warped_ref_vis(item, t))]
        tiles.extend(self._loss_cx_vis(item, out, t))
        for tag, img in tiles:
            write_image(os.path.join(sample_dir, f"{i:03d}_{tag}.png"), img)

    def validate(self, max_items: int | None = None) -> float:
        """Mean PSNR of the valid split streamed through ``StreamRunner`` in
        the trainer's compute dtype (HD input: the SR frame downscaled by
        the scale first). The trainer's net keeps its dtype and mode."""
        cfg = self.config
        t = cfg.frame_num
        runner = StreamRunner(self.trainer.net, cfg.reset_branch,
                              device=self.device,
                              compute_dtype=self.trainer.compute_dtype,
                              keyframe_stride=(cfg.keyframe_stride
                                               if cfg.network == "RefVSR_IR"
                                               else None))
        vals = []
        n = len(self.valid_ds) if max_items is None else min(
            max_items, len(self.valid_ds))
        for i in range(n):
            item = self.valid_ds[i]
            if item.get("is_continue"):
                continue
            sr, conf = runner.process(item["LR_UW"][None, :t],
                                      item["LR_REF_W"][None, :t],
                                      item["is_first"])
            gt = item["HR_UW"][t // 2]
            out = sr[0]
            if cfg.save_sample and i < 4 and self.is_main:
                self._save_samples(i, item, out, gt, conf, t)
            if cfg.flag_HD_in:
                out = np.clip(np_resize(out, scale_factor=1 / cfg.scale,
                                        mode="bicubic"), 0, 1)
            mse = np.mean((out - gt) ** 2)
            vals.append(10 * np.log10(1.0 / mse))
        return float(np.mean(vals)) if vals else 0.0
