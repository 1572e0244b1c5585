"""k1_roofline.stream (%): the least time the flow warps of the traced
frames could take on the chip (each call's input and flow read once, each
at its own dtype, its output written once, against 3.35 TB/s;
``work.k1_work``), as a share of the device time of the kernels launched
inside the benchmark's range around the model's warp entry
(``ops/warp.py``'s ``warp`` as ``models/refvsr.py`` calls it). A range
entered with no device time fails the run."""

from benchmark import work

LAYER = "hand-written kernels"
MOVES = "stream_fps"
RANGES = {"bench.k1": "refvsr_tpu_torch.models.refvsr:warp"}


def read(run):
    t = run.trace
    s = t.device_s("bench.k1")
    if s is None:
        return None
    bound = 0.0
    for (x, xdt), (flow, fdt) in t.calls["bench.k1"]:
        nbytes, ops = work.k1_work(x, flow, xdt, fdt)
        bound += work.bound_s(nbytes, ops, xdt)
    return 100.0 * bound / s
