"""Probe when a ``torch.profiler`` pass misses a kernel that its wrapper
launched, on the card: the K1 backward kernel, as ``chip_smoke.py`` traces
it (``call_device_ms``).

    python -m refvsr_tpu_torch.bench.probe_trace [--procs 3]

Runs `--procs` fresh processes one after another (a new process has never
started a profiler session). Each builds the kernels (or loads them from
``refvsr_tpu_torch/_build``), makes the training step's feature-warp inputs
(g 2x128x128x49 f32, dx and dflow) and traces three passes of ten
``warp_sample_backward`` calls. For each pass it reports the wrapper's
launches, the device events whose name holds the smoke's tag
(``warp_sample_backward_kernel``), those that name the backward kernel in
another way, the launcher's memsets, the streams of the device events, and
the names of every device event. Prints one JSON line. Needs the card."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

TAG = "warp_sample_backward_kernel"


def passes(n_passes=3, reps=10):
    """[{what one traced pass of `reps` calls saw}] in this process."""
    from torch.profiler import ProfilerActivity, profile

    from refvsr_tpu_torch.ops.kernels import build
    from refvsr_tpu_torch.ops.kernels import warp_sample as k1
    build.LIBS.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand((2, 128, 128, 49), generator=gen, device=dev) * 2 - 1
    flow = (torch.rand((2, 128, 128, 2), generator=gen, device=dev) * 2
            - 1) * 6
    g = torch.rand_like(x) * 2 - 1
    out = []
    for _ in range(n_passes):
        torch.cuda.synchronize()
        before = k1.warp_sample_backward.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                k1.warp_sample_backward(g, flow, tuple(x.shape), x)
            torch.cuda.synchronize()
        events = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        names = sorted({ev.name for ev in events})
        out.append(dict(
            launches=k1.warp_sample_backward.launches - before,
            tagged=sum(TAG in ev.name for ev in events),
            named_otherwise=sum("warp_sample_backward" in ev.name
                                and TAG not in ev.name for ev in events),
            memsets=sum("Memset" in ev.name for ev in events),
            streams=sorted({getattr(ev, "device_resource_id", -1)
                            for ev in events}),
            device_events=len(events), names=[n[:80] for n in names]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_trace needs a CUDA card")
    if args.child:
        print(json.dumps(passes()))
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    procs = []
    for _ in range(args.procs):
        res = subprocess.run([sys.executable, "-m", __spec__.name,
                              "--child"], capture_output=True, text=True,
                             check=True)
        procs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    for i, ps in enumerate(procs):
        for j, p in enumerate(ps):
            print(f"process {i} pass {j}: {p['launches']} launches, "
                  f"{p['tagged']} tagged kernel events, "
                  f"{p['named_otherwise']} named otherwise, {p['memsets']} "
                  f"memsets, streams {p['streams']}, {p['device_events']} "
                  f"device events")
    print(json.dumps(dict(card=card, processes=procs)))


if __name__ == "__main__":
    main()
