"""Sliding-window recurrent trainer; counterpart of
``refvsr_tpu/train/trainer.py`` (the reference's trainers/trainer.py and
baseTrainer.py) for the RefVSR and RefVSR-IR networks.

Semantics kept from the JAX package:

- one optimizer step per sliding-window position, ``frame_itr_num`` steps
  per batch; the recurrent state is re-initialised at window 0 and carried,
  detached, from one step to the next;
- the MFID ref set grows with the window position (``HR_REF_*[:, :i+t]``);
- the IR network (``RefVSR_IR``) gets a sliding keyframe mask per window,
  anchored again at each batch's first window;
- the update is optax's ``chain(clip_by_global_norm(gc),
  scale_by_adam(beta1, 0.999, 1e-8), scale_by_learning_rate(schedule))``:
  the global norm over all trained gradients, ``g * gc / norm`` when
  ``norm >= gc`` (optax's own formula, not ``clip_grad_norm_``'s ``+1e-6``),
  bias-corrected Adam moments, and ``-schedule(step) * update`` with the
  step counted from 0 before each update. A parameter with no gradient in a
  step counts as a zero gradient, as it does in JAX;
- SPyNet (its flows run without gradients) and the loss VGGs are frozen
  and outside the optimizer; the network's matching VGG prefix trains;
- the pretrained SPyNet and VGG19 are loaded from ``config.spynet_ckpt``
  and ``config.vgg19_ckpt`` when the files exist, with a loud warning when
  they do not (``utils/convert.load_pretrained_assets``);
- data parallelism (a process group of more than one rank, each on its
  own share of the batch): the parameters are broadcast from rank 0 once,
  and every window's gradients, with the errors that are logged, are
  averaged over the ranks in one flattened bucket before the update, the
  psum the JAX mesh inserts (the PSNR through its MSE, which is the
  batch mean); the contextual loss's channel mean, which
  couples the batch items, runs over every rank's batch
  (``parallel.mesh.batch_mean``), so the averaged gradients are the whole
  batch's;
- ``is_amp`` is the bf16 policy: the network runs in bf16 on bf16 copies
  of its f32 parameters, cast inside the graph (``torch.func.
  functional_call``), so the gradients reach the f32 masters; the window's
  inputs and the recurrent state are bf16, the output is cast to f32 before
  the loss, and the parameters, the Adam moments and the loss stay f32.

One host-to-device upload per batch; the window slices are views on the
device and the errors are summed on the device and read once per batch."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from refvsr_tpu_torch import resolve_device
from refvsr_tpu_torch.losses import LossModule
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.refvsr import build_refvsr, init_stream_state
from refvsr_tpu_torch.models.refvsr_ir import sliding_keyframe_mask
from refvsr_tpu_torch.parallel import mesh
from refvsr_tpu_torch.train import schedule as schedules
from refvsr_tpu_torch.utils.convert import load_pretrained_assets


class ClippedAdam:
    """optax.chain(clip_by_global_norm(gc), scale_by_adam(b1, b2, eps),
    scale_by_learning_rate(schedule)) over a list of tensors, which it
    updates in place. ``step`` counts the updates made."""

    def __init__(self, params, gc: float, b1: float, schedule,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.gc, self.b1, self.b2, self.eps = gc, b1, b2, eps
        self.schedule = schedule
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.step = 0

    @torch.no_grad()
    def update(self, grads):
        """One update from ``grads`` (a tensor or None per parameter; None
        counts as zero). Returns the global norm before clipping."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        clip = norm >= self.gc
        b1, b2 = self.b1, self.b2
        count = self.step + 1
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        lr = self.schedule(self.step)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(clip, g / norm * self.gc, g)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
        self.step += 1
        return norm


def _psnr_to_mse(p):
    """The MSE of a PSNR against peak 1 (``losses.psnr``)."""
    return torch.pow(10.0, -p / 10.0)


class Trainer:
    """Holds the network, the loss module and the optimizer state of one
    training run (RefVSR or RefVSR-IR). ``device`` is the card unless the
    caller asks for the CPU; ``seed`` (default ``config.manual_seed``)
    seeds the random weights of the network and of the loss VGGs, which
    the pretrained assets then overwrite where the configured files exist
    (``assets`` reports what was filled)."""

    def __init__(self, config, device="cuda", seed: Optional[int] = None):
        self.config = config
        self.device = resolve_device(device)
        self.seed = config.manual_seed if seed is None else seed
        self.compute_dtype = torch.bfloat16 if config.is_amp else \
            torch.float32
        self.net = build_refvsr(config, device=self.device, seed=self.seed)
        self.net.train()
        self.net.FlowNet.requires_grad_(False)
        self.loss_mod = LossModule(config.loss, scale=config.scale,
                                   flag_HD_in=config.flag_HD_in,
                                   vgg_layer=config.CX_vgg_layer)
        init_weights(self.loss_mod,
                     torch.Generator().manual_seed(self.seed + 1))
        self.loss_mod.to(self.device)
        self.assets = load_pretrained_assets(config, self.net, self.loss_mod)
        self.schedule = schedules.from_config(config)
        self.params = [p for p in self.net.parameters() if p.requires_grad]
        # seeded init already agrees across ranks; rank 0's values win
        mesh.broadcast_(list(self.net.parameters())
                        + list(self.loss_mod.parameters()))
        self.opt = ClippedAdam(self.params, config.gc, config.beta1,
                               self.schedule)

    def current_lr(self) -> float:
        """The rate of the next update."""
        return float(self.schedule(self.opt.step))

    def gradients(self, state, lrs, refs, hr, ref_frames,
                  keyframe_mask=None):
        """forward_train and the loss on one window, and the loss's
        gradients. `keyframe_mask`: the IR net's (None for RefVSR).
        Returns (errs dict, out, new detached state, grads: a tensor or
        None per entry of ``self.params``)."""
        cdt = self.compute_dtype
        kf = () if keyframe_mask is None else (keyframe_mask,)
        if cdt == torch.float32:
            out, new_state = self.net.forward_train(lrs, refs, state, *kf)
        else:
            # the net holds no buffers; its parameters are all floating
            cast = {k: p.to(cdt) for k, p in self.net.named_parameters()}
            out, new_state = torch.func.functional_call(
                self.net, cast, (lrs.to(cdt), refs.to(cdt), state, *kf))
        with mesh.sync_batch_stats():
            errs = self.loss_mod(out.float(), hr, ref_frames)
            grads = torch.autograd.grad(errs["total"], self.params,
                                        allow_unused=True)
        return errs, out, new_state, grads

    def average(self, grads, errs):
        """The ranks' mean of `grads` (a tensor or None per parameter) and
        of the errors, by one all-reduce in the order of ``self.params``;
        the errors come back detached. One rank returns its inputs. Raises
        if the ranks disagree on which gradients are None."""
        if mesh.world_size() == 1:
            return grads, errs
        keys = sorted(errs)
        have = [g for g in grads if g is not None]
        flags = torch.tensor([g is not None for g in grads],
                             dtype=torch.float32, device=self.device)
        # the PSNR is not a mean over the batch; its MSE is
        vals = torch.stack([_psnr_to_mse(errs[k].detach().float())
                            if k == "PSNR" else errs[k].detach().float()
                            for k in keys])
        red = mesh.all_reduce_mean(have + [flags, vals])
        if not bool(((red[-2] == 0) | (red[-2] == 1)).all()):
            raise RuntimeError("the ranks disagree on which parameters "
                               "have gradients")
        it = iter(red[:-2])
        grads = [None if g is None else next(it) for g in grads]
        errs = dict(zip(keys, red[-1].unbind()))
        if "PSNR" in errs:
            errs["PSNR"] = -10.0 * torch.log10(errs["PSNR"])
        return grads, errs

    # ---------------- one window ----------------

    def train_step(self, state, lrs, refs, hr, ref_frames,
                   keyframe_mask=None):
        """One optimizer step on one window: forward_train, the loss, its
        gradients, the update. Returns (errs dict of detached f32 scalars,
        the new detached state)."""
        errs, _, new_state, grads = self.gradients(state, lrs, refs, hr,
                                                   ref_frames, keyframe_mask)
        grads, errs = self.average(grads, errs)
        self.opt.update(grads)
        return {k: v.detach().float() for k, v in errs.items()}, new_state

    # ---------------- sliding-window iteration ----------------

    def iteration(self, batch):
        """One training batch: ``frame_itr_num`` sliding-window optimizer
        steps. batch: dict of numpy arrays (b, T_total, h, w, 3), keys
        LR_UW, LR_REF_W, HR_UW and HR_REF_T (is_use_T) or HR_REF_W.
        Returns (the mean of each error over the windows, the last
        state); ``window_errs`` keeps each window's errors, on the
        device."""
        cfg = self.config
        t = cfg.frame_num
        ref_key = "HR_REF_T" if cfg.is_use_T else "HR_REF_W"

        def upload(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)
        lr_all, ref_all, hr_all, hr_ref_all = (
            upload(batch[k]) for k in ("LR_UW", "LR_REF_W", "HR_UW", ref_key))
        n, total, h, w = lr_all.shape[:4]
        sums = {}
        norm = 0
        state = kf_mask = None
        kf_first = None
        self.window_errs = []
        for i in range(total - (t - 1)):
            if i == 0:
                state = init_stream_state(n, h, w, cfg.mid_channels,
                                          self.compute_dtype, num_frames=t,
                                          device=self.device)
                kf_first = None
            if cfg.network == "RefVSR_IR":
                kf_mask, kf_first = sliding_keyframe_mask(
                    t, cfg.keyframe_stride, kf_first)
            errs, state = self.train_step(
                state, lr_all[:, i:i + t], ref_all[:, i:i + t],
                hr_all[:, i + t // 2], hr_ref_all[:, :i + t], kf_mask)
            norm += n
            self.window_errs.append(errs)
            for k, v in errs.items():
                sums[k] = sums.get(k, 0.0) + v * n
        return {k: float(v) / norm for k, v in sums.items()}, state
