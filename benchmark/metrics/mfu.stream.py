"""mfu.stream (%): the floating-point operations the window's frames need,
counted from the configuration's shapes (``benchmark/work.py``), over the
window's host time, as a share of the configuration dtype's peak (bf16:
989 TFLOP/s; f32: the TF32 rate, 495 TFLOP/s)."""

from benchmark import work

LAYER = "network, whole step"
MOVES = "stream_fps"
RANGES = {}


def read(run):
    cfg, tr = run.cfg, run.traffic
    flops = sum(work.frame_flops(cfg, tr["lr_hw"], tr["ref_hw"],
                                 "stream" if f["kind"] == "stream"
                                 else "first")
                for f in run.frames)
    return 100.0 * flops / run.window_s / work.PEAK_FLOPS[cfg["dtype"]]
