"""idle_share.stream (%): the share of the traced window's host time in
which no operation ran on the card."""

LAYER = "device"
MOVES = "stream_fps"
RANGES = {}


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
