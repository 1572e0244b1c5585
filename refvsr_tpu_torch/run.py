"""The port's command line, with the JAX package's flag surface (``run.py``
at the repository root). Training:

    python -m refvsr_tpu_torch.run --is_train --mode RefVSR_MFID_8K \\
        --config config_RefVSR_MFID_8K -b 2 --data_offset ./datasets

Evaluation (``--eval_mode`` quan_qual, FOV or conf; ``eval/runner.py``):

    python -m refvsr_tpu_torch.run --mode RefVSR_IR_MFID \\
        --config config_RefVSR_IR_MFID --eval_mode quan_qual \\
        --data_offset ./datasets --output_offset ./out

Both run on the card; ``-cpu`` runs on the CPU. Without ``--config`` an
evaluation rebuilds the config from the training run's ``config.json``
(``<log_offset>/<project>/<mode>/config/``) where there is one. More than
one device (``--devices``/``--spatial_devices`` above 1, ROADMAP Queue 1,
item 7) exits with a message. ``-dist`` is accepted and changes nothing,
as in the JAX package."""

from __future__ import annotations

import argparse
import dataclasses
import random

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="RefVSR (PyTorch/CUDA port)")
    p.add_argument("--is_train", action="store_true")
    p.add_argument("--project", type=str, default="RefVSR_TPU")
    p.add_argument("--mode", type=str, default="RefVSR_MFID")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data", type=str, default="RealMCVSR")
    p.add_argument("-b", "--batch_size", type=int, default=None)
    p.add_argument("-LRS", "--LRS", type=str, default="CA")
    p.add_argument("-th", "--thread_num", type=int, default=None)
    p.add_argument("-r", "--resume", type=str, default=None)
    p.add_argument("-ra", "--resume_abs", type=str, default=None)
    p.add_argument("-ss", "--save_sample", action="store_true")
    p.add_argument("-dl", "--delete_log", action="store_true",
                   help="wipe the run's log tree before training "
                        "(ignored when resuming)")
    p.add_argument("-vs", "--is_verbose", action="store_true")
    p.add_argument("--data_offset", type=str, default=None)
    p.add_argument("--output_offset", type=str, default=None)
    p.add_argument("--log_offset", type=str, default=None)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--total_itr", type=int, default=None)
    # eval flags
    p.add_argument("--eval_mode", type=str, default="quan_qual")
    p.add_argument("--ckpt_name", type=str, default=None)
    p.add_argument("--ckpt_epoch", type=int, default=None)
    p.add_argument("--ckpt_abs_name", type=str, default=None)
    p.add_argument("--ckpt_sc", action="store_true",
                   help="load best-by-score checkpoint")
    p.add_argument("--qualitative_only", action="store_true")
    p.add_argument("--quantitative_only", action="store_true")
    p.add_argument("--vid_name", type=str, nargs="*", default=None)
    p.add_argument("--test_set", type=str, default="test")
    p.add_argument("-is_debug", "--is_debug", action="store_true",
                   help="debug mode: eval stops after 3 frames, no score "
                        "file")
    p.add_argument("-cpu", "--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("-dist", "--dist", action="store_true",
                   help="accepted for the reference's flag surface; "
                        "changes nothing")
    p.add_argument("--devices", type=int, default=None,
                   help="devices of the data-parallel mesh (one only)")
    p.add_argument("--spatial_devices", type=int, default=None,
                   help="eval: devices each frame is split over (one only)")
    p.add_argument("--spatial_halo", type=int, default=None,
                   help="halo rows exchanged per neighbour (default 32)")
    p.add_argument("--pipeline_lanes", type=int, default=None,
                   help="eval: batch L in-flight backward chains per "
                        "dispatch (pipelined streaming, models/refvsr.py); "
                        "outputs identical, L-1 windows late")
    return p


def build_config(args):
    """Variant (``--config`` or ``config_<mode>``; for an evaluation
    without ``--config``, the training run's ``config.json`` where it
    exists), then the flags that were given, then the data paths: the
    training ones, and for an evaluation the test split's too."""
    import os

    from refvsr_tpu_torch.configs import (get_config, load_config,
                                          set_data_path)

    name = args.config or f"config_{args.mode}"
    overrides = {"mode": args.mode, "is_train": args.is_train,
                 "LRS": args.LRS, "data": args.data}
    for field, val in (("batch_size", args.batch_size),
                       ("thread_num", args.thread_num),
                       ("data_offset", args.data_offset),
                       ("output_offset", args.output_offset),
                       ("log_offset", args.log_offset),
                       ("total_itr", args.total_itr),
                       ("spatial_devices", args.spatial_devices),
                       ("spatial_halo", args.spatial_halo),
                       ("pipeline_lanes", args.pipeline_lanes)):
        if val is not None:
            overrides[field] = val
    if args.save_sample:
        overrides["save_sample"] = True
    if args.is_verbose:
        overrides["is_verbose"] = True

    saved_json = None
    if not args.is_train and args.config is None:
        cand = os.path.join(args.log_offset or "./logs", args.project,
                            args.mode, "config", "config.json")
        if os.path.exists(cand):
            saved_json = cand
    if saved_json is not None:
        c = load_config(saved_json).replace(**overrides)
    else:
        c = get_config(name, **overrides)

    ev = dataclasses.replace(
        c.EVAL, eval_mode=args.eval_mode, ckpt_name=args.ckpt_name,
        ckpt_epoch=args.ckpt_epoch, ckpt_abs_name=args.ckpt_abs_name,
        load_ckpt_by_score=bool(args.ckpt_sc or args.ckpt_abs_name is None),
        qualitative_only=args.qualitative_only,
        quantitative_only=args.quantitative_only,
        vid_name=args.vid_name, test_set=args.test_set,
        is_debug=args.is_debug)
    c = set_data_path(c.replace(EVAL=ev), is_train=args.is_train)
    if not args.is_train:
        c = set_data_path(c, is_train=True)
    return c


def main(argv=None):
    """Parse `argv`, seed, and train (returns the Runner) or evaluate
    (returns the summary)."""
    args = build_parser().parse_args(argv)
    for flag in ("devices", "spatial_devices"):
        n = getattr(args, flag)
        if n is not None and n > 1:
            raise SystemExit(
                f"--{flag} {n}: the port runs on one device (more than one "
                "is ROADMAP Queue 1, item 7)")
    config = build_config(args)
    device = "cpu" if args.cpu else "cuda"

    random.seed(config.manual_seed)
    np.random.seed(config.manual_seed)
    if not args.is_train:
        from refvsr_tpu_torch.eval.runner import evaluate
        summary = evaluate(config, device=device)
        print(summary)
        return summary

    if args.delete_log and args.resume is None and args.resume_abs is None:
        from refvsr_tpu_torch.utils.console import handle_directory
        handle_directory(config, True)
    from refvsr_tpu_torch.train.runner import Runner
    runner = Runner(config, device=device)
    try:
        if args.resume is not None:
            runner.resume(int(args.resume))
        elif args.resume_abs is not None:
            runner.resume_abs(args.resume_abs)
        runner.train(max_epochs=args.max_epochs)
    finally:
        runner.close()
    return runner


if __name__ == "__main__":
    main()
