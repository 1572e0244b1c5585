"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``warp_sample`` (K1): the propagation flow warp, ``csrc/warp_sample.cu``.
- ``argmax_matmul`` (K2): the matching max/argmax, ``csrc/argmax_matmul.cu``.
- ``conv3x3_bias`` (K3): 3x3 SAME conv + bias, ``csrc/conv3x3.cu``; run by
  the microbenchmark ``bench.microbench_conv`` (the net's convolutions stay
  cuDNN).
- ``gather_rows`` (K4): row gather with clamped indices,
  ``csrc/gather_rows.cu``; run by the microbenchmark
  ``bench.microbench_gather``.

Each wrapper runs its plain version for CPU tensors only, launches its kernel
for CUDA tensors (or raises), and counts launches in ``<wrapper>.launches``.
"""
