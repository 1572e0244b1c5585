"""conv_ms_per_frame.stream (ms): device time of the kernels launched
inside the benchmark's range around each ``Conv2d.forward`` of the port
(cuDNN's convolution and its bias add, and whatever a later kernel puts in
their place), over the traced frames. A range entered with no device time
fails the run."""

LAYER = "library convolutions"
MOVES = "stream_fps"
RANGES = {"bench.conv": "refvsr_tpu_torch.models.blocks:Conv2d.forward"}


def read(run):
    s = run.trace.device_s("bench.conv")
    if s is None:
        return None
    return 1e3 * s / run.trace.frames
