"""mfu.ir (%): the floating-point operations the window's RefVSR-IR frames
need, counted from the configuration's shapes and each window's keyframes,
which follow from its index (``benchmark/work_ir.py``), over the window's
host time, as a share of the configuration dtype's peak (f32: the TF32
rate, 495 TFLOP/s)."""

from benchmark import work, work_ir

LAYER = "network, whole step"
MOVES = "stream_fps"
RANGES = {}


def read(run):
    cfg, tr = run.cfg, run.traffic
    flops = sum(work_ir.frame_flops(cfg, tr["lr_hw"], tr["ref_hw"], f["w"],
                                    f["kind"])
                for f in run.frames)
    return 100.0 * flops / run.window_s / work.PEAK_FLOPS[cfg["dtype"]]
