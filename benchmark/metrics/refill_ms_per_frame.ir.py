"""refill_ms_per_frame.ir (ms): the self device time of the program's span
``refvsr.net.refill``, RefVSR-IR's information refill: EDVR-M on each
keyframe's 5-frame neighbourhood, its PCD alignment's deformable
convolutions included (``compute_refill_features``, one a frame), over the
traced frames, a frame. A device span's time is taken by CUDA events on
its stream; its self time is that less the time of the device spans
directly inside it (``refvsr_tpu_torch/utils/trace.py``). Nothing to read
where the program keeps no span log or its frames hold no such span."""

from benchmark import spans

LAYER = "network stages"
MOVES = "stream_fps"
RANGES = {}
SPAN = "refvsr.net.refill"


def read(run):
    frames = spans.traced_frames(run)
    if frames is None or not any(s["name"] == SPAN for f in frames
                                 for s in f["spans"]):
        return None
    return spans.self_ms_per_frame(run, SPAN)
