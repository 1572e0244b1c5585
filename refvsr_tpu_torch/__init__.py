"""RefVSR in PyTorch and CUDA for NVIDIA Hopper (H100), beside the JAX
package ``refvsr_tpu`` that stays the reference.

Layout mirrors ``refvsr_tpu``: ``configs``, ``ops`` (with ``ops/kernels``
holding the hand-written CUDA kernels and their plain PyTorch versions:
the flow warp and the matching argmax, forward and backward, on the
stream and training paths; the 3x3 conv + bias and the row gather, run by
the microbenchmarks in ``bench``), ``models``, ``losses``, ``train``,
``utils``, ``eval`` and ``bench``. Public op and model functions take and
return NHWC tensors, like the JAX package.

Device: entry points (``eval.stream.StreamRunner``,
``models.refvsr.build_refvsr``, ``train.trainer.Trainer``,
``eval.runner.evaluate``, the microbenchmarks' ``run``) run on
``"cuda"`` unless the caller passes ``device="cpu"``; asking for ``"cuda"``
without a card raises. A kernel wrapper runs its plain version only for
CPU tensors; for CUDA tensors it launches its kernel or raises, and so does
its backward pass.

Numerics the port relies on:

* The streaming path runs in bf16 on the card (``RefVSR_MFID_8K``): the
  weights are cast with ``utils.precision.cast_floating`` and the inputs
  are cast by the stream runner. cuDNN convolutions accumulate bf16 in f32.
* Coordinates (flow warp, AlignedConv2d taps) are f32 whatever the compute
  dtype, as in the JAX package.
* f32 comparisons against the plain versions on the card set
  ``torch.backends.cuda.matmul.allow_tf32 = False`` and
  ``torch.backends.cudnn.allow_tf32 = False`` (PyTorch's defaults are
  False and True): TF32 keeps 10 mantissa bits, which would hide a kernel
  error behind the reference's own rounding. ``chip_smoke.py`` sets both.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for and
    there is no card (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain CPU path")
    return dev
