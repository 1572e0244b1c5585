"""setup_s (s): from the process's start, before PyTorch is imported,
until the measured window starts: imports, the kernels' build where it is
not cached, weights, the clip, the warm-up windows."""


def read(run):
    return run.setup_s
