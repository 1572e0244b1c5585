"""Parity harness: from a released reference checkpoint to a parity number
in one command; counterpart of the JAX package's
``scripts/parity_check.py``.

    python -m refvsr_tpu_torch.eval.parity_check <ckpt.pytorch> \\
        <data_offset> [--config RefVSR_small_L1] [--vid_name 0024 ...] \\
        [--test_set test] [--max_frames N] [--output_offset ./parity_out] \\
        [--save_converted out.pt] [-cpu]

Builds the evaluation config (``quan_qual``, quantitative only) and the net
with its ``StreamRunner`` through ``eval/runner.init_eval``, loads the
reference-keyed checkpoint (``utils/convert.load_torch_checkpoint``: CPU
remap, a top-level ``state_dict`` unwrapped; ``load_reference_state_dict``
with ``strict=False``: ``module.`` prefixes stripped, the reference's
statistics buffers dropped), and reports the keys that did not map: a
``converted:`` line with the counts, then up to 20 ``MISSING`` (parameters
of the net the checkpoint lacks) and 20 ``UNUSED`` (checkpoint keys the net
does not hold) lines. ``--save_converted`` writes the converted state dict
with ``torch.save``, the port's checkpoint format, where the JAX script
writes msgpack. Then it streams the test clips and scores each centre frame
with ``eval/metrics.py``'s PSNR and SSIM in the reference protocol (for
HD input after the bicubic 1/scale downscale, clipped to [0, 1]), printing
per-frame, per-video ``[MEAN ...]`` and ``[TOTAL] ... (n frames)`` lines in
the JAX script's format, and stops after ``--max_frames`` scored frames.

Runs on the card unless given ``-cpu``. It fetches nothing: the checkpoint
is a file the caller has."""

from __future__ import annotations

import argparse
import dataclasses
import warnings

import numpy as np
import torch

from refvsr_tpu_torch import configs
from refvsr_tpu_torch.data.np_ops import np_resize
from refvsr_tpu_torch.eval.metrics import psnr, ssim
from refvsr_tpu_torch.eval.runner import init_eval
from refvsr_tpu_torch.models.refvsr import build_refvsr
from refvsr_tpu_torch.utils.convert import (load_reference_state_dict,
                                            load_torch_checkpoint)

# key lines printed of each kind
KEY_LINES = 20


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt", help=".pytorch/.pth checkpoint to convert+eval")
    p.add_argument("data_offset", help="dir containing RealMCVSR/")
    p.add_argument("--config", default="RefVSR_small_L1")
    p.add_argument("--vid_name", nargs="*", default=None,
                   help="restrict to specific clip(s)")
    p.add_argument("--test_set", default="test")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--output_offset", default="./parity_out")
    p.add_argument("--save_converted", default=None,
                   help="also save the converted state dict (torch.save)")
    p.add_argument("-cpu", "--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    return p


def eval_config(a):
    """The evaluation config of the JAX script: quan_qual, quantitative
    only, data paths of both splits derived."""
    config = configs.get_config(a.config, mode=a.config,
                                data_offset=a.data_offset,
                                output_offset=a.output_offset,
                                spynet_ckpt=None, vgg19_ckpt=None)
    config = config.replace(EVAL=dataclasses.replace(
        config.EVAL, vid_name=a.vid_name, test_set=a.test_set,
        eval_mode="quan_qual", quantitative_only=True))
    config = configs.set_data_path(config, is_train=False)
    return configs.set_data_path(config, is_train=True)


def convert(config, path: str, save_to: str | None = None):
    """The net of `config` (seeded, f32, on the CPU) with the checkpoint at
    `path` loaded over it; prints the key report and, with `save_to`, saves
    the converted state dict. Returns the net."""
    sd = load_torch_checkpoint(path)
    net = build_refvsr(config, device="cpu", seed=config.manual_seed)
    res = load_reference_state_dict(net, sd, strict=False)
    print(f"converted: {len(sd)} torch tensors; missing parameters: "
          f"{len(res.missing_keys)}, unused torch keys: "
          f"{len(res.unexpected_keys)}")
    for k in res.missing_keys[:KEY_LINES]:
        print(f"  MISSING {k}")
    for k in res.unexpected_keys[:KEY_LINES]:
        print(f"  UNUSED  {k}")
    if save_to:
        torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()},
                   save_to)
        print(f"saved converted state dict -> {save_to}")
    return net


def score(config, ds, runner, max_frames: int | None = None):
    """Stream the test split and print the score lines (the reference's
    evaluation/eval_qual_quan.py protocol). Returns [(PSNR, SSIM)] of the
    scored frames."""
    t = config.frame_num
    psnr_v = ssim_v = 0.0
    n_v = 0
    per_video, totals = {}, []
    cur_video = None
    for i in range(len(ds)):
        if max_frames is not None and len(totals) >= max_frames:
            break
        item = ds[i]
        if item.get("is_continue"):
            continue
        if item["is_first"] and cur_video is not None and n_v:
            per_video[cur_video] = (psnr_v / n_v, ssim_v / n_v)
            psnr_v = ssim_v = 0.0
            n_v = 0
        cur_video = item["video_name"]
        sr, _ = runner.process(item["LR_UW"][None, :t],
                               item["LR_REF_W"][None, :t], item["is_first"])
        out = sr[0]
        gt = item["HR_UW"][t // 2]
        if config.flag_HD_in:
            out = np.clip(np_resize(out, scale_factor=1 / config.scale,
                                    mode="bicubic"), 0, 1)
        fp, fs = psnr(out, gt), ssim(out, gt)
        print(f"[{item['video_name']}] {item['frame_name']} "
              f"PSNR: {fp:.5f} SSIM: {fs:.5f}")
        psnr_v += fp
        ssim_v += fs
        n_v += 1
        totals.append((fp, fs))
    if cur_video is not None and n_v:
        per_video[cur_video] = (psnr_v / n_v, ssim_v / n_v)
    for vid, (pv, sv) in per_video.items():
        print(f"[MEAN {vid}] PSNR: {pv:.5f} SSIM: {sv:.5f}")
    if totals:
        tp = sum(v[0] for v in totals) / len(totals)
        tssim = sum(v[1] for v in totals) / len(totals)
        print(f"[TOTAL] PSNR: {tp:.5f} SSIM: {tssim:.5f} "
              f"({len(totals)} frames)")
    return totals


def main(argv=None):
    a = build_parser().parse_args(argv)
    config = eval_config(a)
    device = "cpu" if a.cpu else "cuda"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the assets come from the checkpoint
        ds, runner, _, _ = init_eval(config, device=device)
    net = convert(config, a.ckpt, a.save_converted)
    runner.net.load_state_dict(net.state_dict())
    return score(config, ds, runner, a.max_frames)


if __name__ == "__main__":
    main()
