"""matching_ms_per_frame.stream (ms): the self device time of the program's
span ``refvsr.net.matching``, the matching: VGG features, patches and K2
(``compute_matching``), over the traced frames, a frame. A device span's
time is taken by CUDA events on its stream; its self time is that less the
time of the device spans directly inside it
(``refvsr_tpu_torch/utils/trace.py``). Nothing to read where the program
keeps no span log."""

from benchmark import spans

LAYER = "network stages"
MOVES = "stream_fps"
RANGES = {}


def read(run):
    return spans.self_ms_per_frame(run, "refvsr.net.matching")
