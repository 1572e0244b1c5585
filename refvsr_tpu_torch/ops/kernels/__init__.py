"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``warp_sample`` (K1): the propagation flow warp, ``csrc/warp_sample.cu``.
- ``argmax_matmul`` (K2): the matching max/argmax, ``csrc/argmax_matmul.cu``.
- ``conv3x3_bias`` (K3): 3x3 SAME conv + bias, ``csrc/conv3x3.cu``; run by
  ``models/blocks.Conv2d.forward`` for the square 3x3 convolutions of bf16
  inference on one image (``blocks.takes_k3``; the rest stay cuDNN) and by
  the microbenchmark ``bench.microbench_conv``.
- ``gather_rows`` (K4): row gather with clamped indices,
  ``csrc/gather_rows.cu``; run by the microbenchmark
  ``bench.microbench_gather``.

Each wrapper runs its plain version for CPU tensors only, launches its kernel
for CUDA tensors (or raises), and counts launches in ``<wrapper>.launches``.
Under a profiler session each forward call of K1 (``warp_sample``,
``warp_sample_banded``) is the span ``refvsr.k1``, each of K2 the span
``refvsr.k2`` and each of K3 the span ``refvsr.k3`` (``utils/trace.py``):
the checks, the output's allocation and the launch, so that the host's
time on the launch path has a name on the timeline.
"""
