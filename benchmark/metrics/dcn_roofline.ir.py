"""dcn_roofline.ir (%): the least time the modulated deformable
convolutions of the traced frames could take on the chip (each call's
input, offsets, mask, weight and bias read once and its output written
once, the contraction's 2 N H W 9 C O operations and four corners'
multiply-adds a sampled value, against the dtype's peaks;
``work_ir.dcn_work``), as a share of the device time of the kernels
launched inside the benchmark's range around the program's deformable
convolution (``models/edvr.py``'s ``modulated_deform_conv``, whatever
computes it). A range entered with no device time fails the run."""

from benchmark import work, work_ir

LAYER = "deformable convolution"
MOVES = "stream_fps"
RANGES = {"bench.dcn": "refvsr_tpu_torch.models.edvr:modulated_deform_conv"}


def read(run):
    t = run.trace
    s = t.device_s("bench.dcn")
    if s is None:
        return None
    bound = 0.0
    for (x, dt), (off, _), (mask, _), (wgt, _), *_ in t.calls["bench.dcn"]:
        nbytes, ops = work_ir.dcn_work(x, off, mask, wgt, dt)
        bound += work.bound_s(nbytes, ops, dt)
    return 100.0 * bound / s
