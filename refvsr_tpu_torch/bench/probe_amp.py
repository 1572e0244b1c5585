"""Probe the bf16 training policy's (``is_amp``) gradients on the card: how
far the card's are from the CPU's, how far the card's kernels take them
from their plain versions, and what a faulty backward kernel would show.

    python -m refvsr_tpu_torch.bench.probe_amp

One window of a tiny ``RefVSR_small_MFID_8K`` net (2 blocks, 8 channels,
T = 3, patch 16, batch 1) from seeded weights and inputs, three ways:

- on the CPU (the plain versions);
- on the card;
- on the card with the four kernel wrappers routed to their plain versions
  (each computed in f32 and rounded once), its discrete choices held to the
  card run's: the matching picks, and the affine alignment's sampling
  positions (each ``AlignedConv2d.p_conv`` output takes the held value and
  keeps its own gradient path). cuDNN runs deterministic in both card runs,
  so the kernels are all that differ.

``compare`` returns the relative L2 of the card's gradients against the
CPU's and against the plain versions', for each trained tensor and over all
of them. ``chip_smoke.py`` checks one seed of it; this entry point reads it
over eight seeds, and again with each backward kernel's output scaled, to
show the margin a fault would cross."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from refvsr_tpu_torch.configs import get_config

# the tiny net of the check and its seeds: (inputs, weights)
TINY = dict(num_blocks=2, mid_channels=8, frame_itr_num=1, patch_size=16,
            batch_size=1, spynet_ckpt=None, vgg19_ckpt=None)
SEEDS = ((14, 3), (15, 4), (16, 5), (17, 6), (18, 7), (19, 8), (20, 9),
         (21, 10))


@contextlib.contextmanager
def patched(owner, name, make):
    """Replace `owner.name` by make(original) for the block."""
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def cudnn_deterministic():
    was = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = was


@contextlib.contextmanager
def plain_kernels():
    """Route the four kernel wrappers' calls to their plain versions, each
    computed in f32 and rounded once to the input's dtype, for the
    block."""
    from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod

    def k1_fwd(x, flow):
        return k1_mod.warp_sample_plain(x.float(), flow.float()).to(x.dtype)

    def k1_bwd(g, flow, x_shape, x=None, need_dx=True):
        dx, dflow = k1_mod.warp_sample_backward_plain(
            g.float(), flow.float(), x_shape,
            None if x is None else x.float())
        return ((dx.to(g.dtype) if need_dx else None),
                None if dflow is None else dflow.to(flow.dtype))

    def k2_bwd(ref_p, lr_p, index, g, needs=(True, True)):
        d_ref, d_lr = k2_mod.argmax_matmul_backward_plain(ref_p, lr_p, index,
                                                          g)
        return (d_ref if needs[0] else None), (d_lr if needs[1] else None)
    with patched(k1_mod, "_forward", lambda _: k1_fwd), \
            patched(k1_mod, "warp_sample_backward", lambda _: k1_bwd), \
            patched(k2_mod, "_forward",
                    lambda _: k2_mod.argmax_matmul_plain), \
            patched(k2_mod, "argmax_matmul_backward", lambda _: k2_bwd):
        yield


class HeldPicks(torch.autograd.Function):
    """argmax_matmul with the picks given: conf is each LR patch's product
    with its given ref patch (f32), and the backward is the K2-bwd
    wrapper's on those picks."""

    @staticmethod
    def forward(ctx, ref_p, lr_p, index):
        bidx = torch.arange(ref_p.shape[0], device=ref_p.device)[:, None]
        conf = (ref_p[bidx, index.long()].float() * lr_p.float()).sum(-1)
        ctx.save_for_backward(ref_p, lr_p, index)
        ctx.mark_non_differentiable(index)
        return conf, index

    @staticmethod
    def backward(ctx, g_conf, _g_index):
        from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
        return (*k2_mod.argmax_matmul_backward(
            *ctx.saved_tensors, g_conf, needs=ctx.needs_input_grad[:2]),
            None)


def tiny_window(cfg, seed):
    """Window 0 of a seeded batch with the HD-in geometry: lrs p^2, refs
    (2p)^2, the centre HR frame p^2, the T ref frames (4p)^2."""
    rng = np.random.default_rng(seed)
    t, p = cfg.frame_num, cfg.patch_size

    def img(side, frames):
        return rng.random((1, frames, side, side, 3), dtype=np.float32)
    lrs, refs, hr, hr_refs = img(p, t), img(2 * p, t), img(p, t), \
        img(4 * p, t)
    return lrs, refs, hr[:, t // 2], hr_refs


def amp_window(d, data_seed, weight_seed, held=None):
    """One is_amp window (bf16 on f32 masters) of the tiny net on device
    `d`; with `held` (what an earlier call saw), its discrete choices held
    to that call's. Returns (losses, gradients by trained tensor on the
    host, what it saw: picks and p_conv outputs)."""
    from refvsr_tpu_torch.models import matching as matching_mod
    from refvsr_tpu_torch.models.refvsr import init_stream_state
    from refvsr_tpu_torch.train.trainer import Trainer

    cfg = get_config("RefVSR_small_MFID_8K", **TINY)
    seen = {"picks": [], "p_conv": []}

    def spy(orig):
        def f(ref_p, lr_p):
            conf, index = orig(ref_p, lr_p)
            seen["picks"].append(index.cpu())
            if held is None:
                return conf, index
            return HeldPicks.apply(
                ref_p, lr_p, held["picks"][len(seen["picks"]) - 1].to(d))
        return f

    def hook(_module, _args, out):
        seen["p_conv"].append(out.detach().cpu())
        if held is None:
            return out
        want = held["p_conv"][len(seen["p_conv"]) - 1].to(d)
        return out + (want - out).detach()
    tr = Trainer(cfg, device=d, seed=weight_seed)
    hooks = [m.p_conv.register_forward_hook(hook) for m in tr.net.modules()
             if isinstance(m, matching_mod.AlignedConv2d)]
    state = init_stream_state(1, cfg.patch_size, cfg.patch_size,
                              cfg.mid_channels, torch.bfloat16,
                              num_frames=cfg.frame_num, device=d)
    win = [torch.from_numpy(a).to(d) for a in tiny_window(cfg, data_seed)]
    try:
        with patched(matching_mod, "argmax_matmul", spy):
            errs, _, _, grads = tr.gradients(state, *win)
    finally:
        for h in hooks:
            h.remove()
    if not (hooks and seen["p_conv"] and seen["picks"]):
        raise RuntimeError("is_amp window: no matching or AlignedConv2d ran")
    names = [k for k, p in tr.net.named_parameters() if p.requires_grad]
    return ({k: float(v.detach()) for k, v in errs.items()},
            {k: g.detach().float().cpu() for k, g in zip(names, grads)},
            seen)


def rel_l2(a, b):
    den = float(b.norm())
    return float((a - b).norm()) / den if den > 0 else float(a.norm())


def compare(dev, data_seed=14, weight_seed=3):
    """The window on the CPU, on `dev` and on `dev` with the plain versions
    held to its choices. Returns {losses: {k: (card, CPU)}, flipped: (picks
    the card made otherwise than the CPU, picks), vs_cpu: {tensor: relative
    L2 of the card's gradient against the CPU's}, overall: that over all
    trained tensors as one vector, vs_plain: {tensor: relative L2 of the
    card's gradient against the plain versions'}}."""
    errs_c, grads_c, seen_c = amp_window("cpu", data_seed, weight_seed)
    with cudnn_deterministic():
        errs_g, grads_g, seen_g = amp_window(dev, data_seed, weight_seed)
        with plain_kernels():
            _, grads_p, _ = amp_window(dev, data_seed, weight_seed,
                                       held=seen_g)
    if not set(grads_g) == set(grads_c) == set(grads_p):
        raise RuntimeError("is_amp window: gradient sets differ")
    names = sorted(grads_c)
    flat = lambda g: torch.cat([g[k].ravel() for k in names])  # noqa: E731
    return dict(
        losses={k: (errs_g[k], v) for k, v in errs_c.items()},
        flipped=(sum(int((a != b).sum()) for a, b in
                     zip(seen_g["picks"], seen_c["picks"])),
                 sum(a.numel() for a in seen_c["picks"])),
        vs_cpu={k: rel_l2(grads_g[k], grads_c[k]) for k in names},
        overall=rel_l2(flat(grads_g), flat(grads_c)),
        vs_plain={k: rel_l2(grads_g[k], grads_p[k]) for k in names})


def worst(d, n=3):
    return ", ".join(f"{k} {v:.3e}" for v, k in sorted(
        ((v, k) for k, v in d.items()), reverse=True)[:n])


def _scaled(fn, which, factor):
    """The backward wrapper `fn` with output `which` scaled: a fault."""
    def f(*args, **kw):
        out = list(fn(*args, **kw))
        if out[which] is not None:
            out[which] = out[which] * factor
        return tuple(out)
    f.launches = 0      # the wrapper counts its launches through its name
    return f


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_amp needs a card")
    from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for data_seed, weight_seed in SEEDS:
        r = compare("cuda", data_seed, weight_seed)
        print(f"seeds {data_seed}, {weight_seed}: {r['flipped'][0]} of "
              f"{r['flipped'][1]} picks differ from the CPU's; card vs CPU "
              f"{r['overall']:.4e} over all tensors, worst "
              f"{worst(r['vs_cpu'])}; kernels vs plain, worst "
              f"{worst(r['vs_plain'])}", flush=True)
    for label, mod, name, which, factor in (
            ("K2-bwd d_ref", k2_mod, "argmax_matmul_backward", 0, 1.1),
            ("K2-bwd d_lr", k2_mod, "argmax_matmul_backward", 1, 1.1),
            ("K1-bwd dx", k1_mod, "warp_sample_backward", 0, 1.1),
            ("K2-bwd d_ref", k2_mod, "argmax_matmul_backward", 0, 0.0)):
        with patched(mod, name, lambda fn: _scaled(fn, which, factor)):
            r = compare("cuda", *SEEDS[0])
        print(f"{label} x {factor} (seeds {SEEDS[0]}): card vs CPU "
              f"{r['overall']:.4e} over all tensors; kernels vs plain, "
              f"worst {worst(r['vs_plain'])}", flush=True)


if __name__ == "__main__":
    main()
