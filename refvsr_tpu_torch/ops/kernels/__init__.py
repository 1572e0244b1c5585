"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``warp_sample`` (K1): the propagation flow warp, ``csrc/warp_sample.cu``.
- ``argmax_matmul`` (K2): the matching max/argmax, ``csrc/argmax_matmul.cu``.
- ``conv3x3_bias`` (K3): 3x3 SAME conv + bias, ``csrc/conv3x3.cu``; run by
  ``models/blocks.Conv2d.forward`` for the square 3x3 convolutions of bf16
  inference on one image (``blocks.routed_kernel``; the rest stay cuDNN)
  and by the microbenchmark ``bench.microbench_conv``.
- ``conv3x3_f32`` (K6): K3's f32 counterpart, three TF32 products on the
  tensor cores, ``csrc/conv3x3_f32.cu``; run by ``Conv2d.forward`` for the
  square 3x3 convolutions of f32 inference on one image at C 32, 36 or 48
  (``blocks.routed_kernel``).
- ``deform_conv`` (K5): the modulated deformable convolution in f32,
  ``csrc/deform_conv.cu``; run by ``models/edvr.modulated_deform_conv``
  for RefVSR-IR's f32 inference on the card (``edvr.takes_k5``; training
  and other operands keep the row-gather path).
- ``gather_rows`` (K4): row gather with clamped indices,
  ``csrc/gather_rows.cu``; run by the microbenchmark
  ``bench.microbench_gather``.

Each wrapper runs its plain version for CPU tensors only, launches its kernel
for CUDA tensors (or raises), and counts launches in ``<wrapper>.launches``.
Under a profiler session each forward call of K1 (``warp_sample``,
``warp_sample_banded``) is the span ``refvsr.k1``, each of K2 the span
``refvsr.k2``, each of K3 the span ``refvsr.k3``, each of K5 the span
``refvsr.k5`` and each of K6 the span ``refvsr.k6`` (``utils/trace.py``):
the checks, the output's allocation and the launch, so that the host's
time on the launch path has a name on the timeline.
"""
