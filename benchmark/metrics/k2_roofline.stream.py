"""k2_roofline.stream (%): the least time the matching products of the
traced frames could take on the chip (2 L_lr L_ref D operations against the
dtype's peak, the patches read once and the max and index written once;
``work.k2_work``), as a share of the device time of the kernels launched
inside the benchmark's range around the argmax call of
``models/matching.py``. A range entered with no device time fails the
run."""

from benchmark import work

LAYER = "hand-written kernels"
MOVES = "stream_fps"
RANGES = {"bench.k2": "refvsr_tpu_torch.models.matching:argmax_matmul"}


def read(run):
    t = run.trace
    s = t.device_s("bench.k2")
    if s is None:
        return None
    bound = 0.0
    for (ref, dt), (lr, _) in t.calls["bench.k2"]:
        nbytes, ops = work.k2_work(ref, lr, dt)
        bound += work.bound_s(nbytes, ops, dt)
    return 100.0 * bound / s
