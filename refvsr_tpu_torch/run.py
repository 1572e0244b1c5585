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
(``<log_offset>/<project>/<mode>/config/``) where there is one.

More than one device, one rule for every entry point:

- under ``torchrun`` (``WORLD_SIZE`` set) each rank joins the group the
  environment describes; a ``--devices`` (training) or
  ``--spatial_devices`` (evaluation) above 1 must equal ``WORLD_SIZE``;
- without it, ``--devices N`` (training) or ``--spatial_devices N``
  (evaluation) spawns N ranks of this command with the environment
  ``torchrun`` would give them, so the JAX package's command line works
  as written.

Training on N ranks is data-parallel: ``batch_size`` is the whole batch
and must divide by N. An evaluation on ``torchrun`` ranks without
``--spatial_devices`` is data-parallel over whole videos; with it, every
frame's H axis is split over the ranks (``parallel/serve.py``). As in the
JAX package, training ignores ``--spatial_devices``, an evaluation
ignores ``--devices``, and ``-dist`` changes nothing. Rank r runs on
``cuda:(LOCAL_RANK % device_count)``; the backend (``nccl`` when each
rank has a card of its own, else ``gloo``) is printed on rank 0's first
line."""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import sys

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
                   help="training: ranks of the data-parallel group")
    p.add_argument("--spatial_devices", type=int, default=None,
                   help="eval: ranks each frame's rows are split over")
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


def _refuse_disagreement(args, n: int, world: int):
    if n > 1 and n != world:
        flag = "--devices" if args.is_train else "--spatial_devices"
        raise SystemExit(f"{flag} {n} disagrees with WORLD_SIZE {world}: "
                         "under torchrun the flag must equal the rank count")


def _precheck(args, config, n: int):
    """What the ranks would refuse, refused before they are spawned."""
    if args.is_train:
        if config.batch_size % n:
            raise SystemExit(
                f"batch_size {config.batch_size} not divisible by the "
                f"{n}-device data mesh (pass -b or --devices)")
        return
    from refvsr_tpu_torch.data.datasets import TestDataset
    from refvsr_tpu_torch.parallel.serve import validate_spatial_shapes
    ds = TestDataset(config, is_valid=False)
    if len(ds):
        h, w = ds[0]["LR_UW"].shape[1:3]
        validate_spatial_shapes(h, w, n, config.spatial_halo)


def _run(args, config, device):
    random.seed(config.manual_seed)
    np.random.seed(config.manual_seed)
    if not args.is_train:
        from refvsr_tpu_torch.eval.runner import evaluate
        summary = evaluate(config, device=device)
        print(summary)
        return summary

    if args.delete_log and args.resume is None and args.resume_abs is None:
        from refvsr_tpu_torch.parallel import mesh
        if mesh.is_main():
            from refvsr_tpu_torch.utils.console import handle_directory
            handle_directory(config, True)
        mesh.barrier(device)
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


def _run_rank(args, config):
    """One rank: join the group, run, leave. Returns what rank 0 can pass
    back to a spawning parent (an evaluation's summary)."""
    from refvsr_tpu_torch.parallel import mesh
    want = "cpu" if args.cpu else "cuda"
    backend = mesh.init_from_env(want)
    try:
        if mesh.is_main():
            print(f"# process group: backend {backend}, "
                  f"{mesh.world_size()} ranks", flush=True)
        out = _run(args, config, mesh.device_for_rank(want))
        return out if not args.is_train else None
    finally:
        mesh.destroy()


def main(argv=None):
    """Parse `argv`, seed, and train (returns the Runner) or evaluate
    (returns the summary); with more than one rank, see the module
    docstring (a spawning parent returns rank 0's evaluation summary, and
    None for training)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    n = (args.devices if args.is_train else args.spatial_devices) or 1
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        _refuse_disagreement(args, n, world)
        config = build_config(args)
        if world > 1:
            return _run_rank(args, config)
    else:
        config = build_config(args)
        if n > 1:
            _precheck(args, config, n)
            from refvsr_tpu_torch.parallel import mesh
            # no deadline: a training run lasts as long as it lasts, and a
            # rank that hangs fails its collectives (mesh.COLLECTIVE_TIMEOUT_S)
            return mesh.spawn(main, (argv,), n)
    return _run(args, config, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
