"""The control of the comparison: the reference itself, put in the
program's place and computed in the precision below the configuration's
(its ``control`` key: fp8 e4m3 for bf16, TF32 for f32), must come out as
not correct.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3
                                 --frames <n>

For each seed it draws the cell's weights and clip as a run does, picks
the frames a run of `n` window frames would compare, replays the stream
through the reference in f32 and in the control's precision side by side,
and prints the comparison's numbers and whether the control passed the
configuration's limits (it must not). Not part of a benchmark run."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import compare, core
from benchmark.generators import stream


def compared_windows(cfg, traffic, seed, frames):
    """The windows a run whose window held `frames` frames compares."""
    keeper = stream.Keeper(seed, traffic["compare"])
    first = traffic["warmup_windows"]
    for w in range(first, first + frames):
        keeper.offer(w, stream.kind_of(w, cfg["reset_branch"]), None)
    return sorted(keeper.kept())


def readings(registry, workload, seed, frames, device="cuda"):
    """(compared, failed frames, seconds) of the control on one seed."""
    cell = registry.cell(workload)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    precision = cfg["control"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sd = stream.make_weights(cfg, seed, device)
    clip = stream.Clip(traffic, seed, stream.DTYPES[cfg["dtype"]], device)
    wanted = compared_windows(cfg, traffic, seed, frames)
    per_frame = []
    for (w, ref, ref_st, base), (w2, low, low_st, _) in zip(
            stream.reference_frames(cfg, sd, clip, wanted, "f32"),
            stream.reference_frames(cfg, sd, clip, wanted, precision)):
        if w != w2:
            raise RuntimeError(f"windows {w} and {w2} out of step")
        per_frame.append(compare.frame_numbers(
            low.permute(0, 2, 3, 1), ref,
            {k: v.permute(0, 2, 3, 1) for k, v in low_st.items()}, ref_st,
            base))
    compared, failed = compare.judge(per_frame, cfg.get("limits", {}))
    return compared, failed, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, required=True)
    a = p.parse_args(argv)
    reg = core.Registry()
    for seed in a.seeds:
        compared, failed, secs = readings(reg, a.workload, seed, a.frames)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control_failed_frames": failed,
                          "compared": compared, "seconds": secs}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
