"""stream_fps (frames/s): every SR frame the window completed over the
window's time, from its start to the end of its last frame (a whole
number of cycles)."""


def read(run):
    return len(run.frames) / run.window_s
