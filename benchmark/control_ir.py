"""The control of the comparison for the RefVSR-IR cells:
``benchmark/control.py``'s check with the IR generator's weights and
reference. The reference computed in the precision below the
configuration's (its ``control`` key) must come out as not correct.

    python3 -m benchmark.control_ir --workload <name> --seeds 1 2 3
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

from benchmark import compare, control, core
from benchmark.generators import stream_ir


def readings(registry, workload, seed, frames, device="cuda"):
    """(compared, failed frames, seconds) of the control on one seed."""
    cell = registry.cell(workload)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sd = stream_ir.make_weights(cfg, seed, device)
    clip = stream_ir.stream.Clip(traffic, seed,
                                 stream_ir.DTYPES[cfg["dtype"]], device)
    wanted = control.compared_windows(cfg, traffic, seed, frames)
    per_frame = []
    for (w, ref, ref_st, bic), (w2, low, low_st, _) in zip(
            stream_ir.reference_frames(cfg, sd, clip, wanted, "f32"),
            stream_ir.reference_frames(cfg, sd, clip, wanted,
                                       cfg["control"])):
        if w != w2:
            raise RuntimeError(f"windows {w} and {w2} out of step")
        per_frame.append(compare.frame_numbers(
            low.permute(0, 2, 3, 1), ref,
            {k: v.permute(0, 2, 3, 1) for k, v in low_st.items()}, ref_st,
            bic))
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
