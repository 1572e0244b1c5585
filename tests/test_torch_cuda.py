"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without a card each skips. The
card's machine has no JAX, so this file imports only torch, numpy and the
port, and runs there without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 1e-5 * max|x| in f32 (f32 weights, the four products summed
in another order), 2^-6 * max|x| in bf16 (the plain version sums in bf16,
the kernel in f32); dead and NaN points exact zeros. K2 conf 1e-5 in f32
(3xTF32 products, dot products of length 144 in another order), indices
equal, ties to the lowest index; in bf16 conf within 1e-4 (f32 sums of
exact bf16 products in another order) and planted exact ties, placed across
the kernels' ref-tile boundaries and between the lanes that share a row
(``refvsr_tpu_torch/bench/ties.py``), resolved to the lowest index. Each
bf16 D (16 to 144) has a build of its own and runs once; the f32 kernel runs
at both ends of its D range. The backward kernels against the plain
backward passes against the plain backward in f32 on the same values: K1
dx and dflow within 1e-5 (f32) or 2^-7 (bf16, one rounding of an f32 sum)
of the largest plain value (register sums and atomics in another order),
exact zeros at dead points, at every channel grouping, grid and alignment
the forward test covers and past 2^31 elements of x; K2 d_lr within 1e-6
and d_ref within 1e-5 (f32) or 2^-7 (bf16) of the largest, no gradient for
duplicated ref rows that never win, at every D the forward kernels take,
ragged L_lr and with every LR row picking one ref row; a gradient not asked
for is not computed; what the forward refuses (D not a multiple of 16,
unaligned rows) the backward refuses too.
K3 (bf16) within 2^-7 |plain| + 2^-8 max|plain| elementwise: two bf16
roundings of f32 sums taken in another order; at every C, at shapes that
end mid-tile in both H and W (the tile height is 8, 4 or 2 rows by C, the
tile width 64 pixels), a single row narrower than a tile, images of more
tiles than the card holds blocks (each block walks several tiles and its
halo ring wraps), and the model's 1080x1920x48. K3 in the path
(``models/blocks.Conv2d.forward``): the 8K net's bf16 stream at a small
frame launches it once for each convolution ``routed_kernel`` names "k3",
each such output within K3's tolerance of the library convolution on the same
input, and the SR frames and carried state within the 8K configuration's
``sr_rmse`` and ``state_rel`` limits of the library-only run. K6 (f32, three
TF32 products) against a convolution in f64 on the same inputs: its largest
and its RMS error each at most twice cuDNN's f32 convolution's (TF32 off),
at the f32 cells' shapes (270x480 at C 48, 36 and 32, 540x960x48,
135x240x48), at odd sizes (9x13, 29x101, a single row, more rows than the
card holds blocks); the same kernel with the low terms dropped (x rounded
to TF32, the weights' low part zero: one TF32 pass) beyond that limit on
both; at one-row and one-pixel shapes within 1e-5 of the largest plain
output; its launch counter and its refusals on the card. K6 in the path:
one first and one streamed window of RefVSR_MFID and of RefVSR_IR_MFID at
their widths (f32) route each convolution ``routed_kernel`` names "k6",
the launches equal to the ``refvsr.k6`` spans, each inside a
``refvsr.conv``, and the SR frames within the cells' ``sr_rmse`` limit
(1e-5) of the run whose convolutions all go to cuDNN. K4 bitwise,
out-of-range indices clamped, at sizes up to its microbenchmark's (R 2048,
L 128 bf16, P 2^20). The microbenchmark entry points at small sizes: each
launches its own kernel and no other, K3 within its envelope, K4's check
mode bitwise.

The serving slice: the PNG codec round-trips exactly on this machine's
zlib and numpy (no card needed: it also runs on the CPU); K1 at batch 2 on
zero flows (a pipelined dispatch's lanes) against its plain version; and
the ``Predictor`` on the card against its CPU run of the same seeded
weights, both in f32 with TF32 off, within the 1e-3 that ``chip_smoke.py``
allows the stream's card-vs-CPU check.

Multi-device: the banded K1 kernel (the H-sharded stream's warp) against
its plain version on the 8K feature and UP bands at N = 2 and 4 (first,
interior and last band, flows past the halo, dead points; tolerances as
K1's), the banded launcher on the trivial band bit-equal to the unbanded
one (one kernel serves both), and two gloo
ranks on one card running the port's collectives on CUDA tensors
(values exact).

The bench's stream leg at a small size, plain and pipelined: its record
and the kernels' launches a window or dispatch.

RefVSR-IR and the eval CLI: the plain deformable convolution on the card
against the CPU within 1e-5 of the largest output (f32, TF32 off); a tiny
IR net's windows on the card against the CPU within 1e-3, with the
kernels' launches per window; the JPEG encoder's header and the inferno
table (no card needed). K5, the deformable convolution kernel, against the
plain version within 1e-5 of the largest plain output (f32 sums of 9C
products split into TF32 halves, in another order than the matmul's): at
the IR cell's three level shapes with N = 2 and 3 (C 64, 8 groups, x a
frame slice of an (N, 5, H, W, C) tensor) and at ragged shapes of the
other widths and groups it takes (C 32 with 4 or 8, C 64 with 4); with
taps far outside, anchors on exactly -1 and S - 1, integer and NaN offsets (a NaN tap held against the plain version
given a far one; a pixel whose every tap is dead gives the bias exactly);
its launch counter one a call, its refusals on the card; and one IR window
at the configuration's widths routing 20 of 20 deformable convolutions to
K5 (``refvsr.k5`` inside each ``refvsr.dcn``), its SR frame within the
cell's ``sr_rmse`` limit, 1e-5, of the row-gather path's."""

import os

import numpy as np
import pytest
import torch

from refvsr_tpu_torch.ops.kernels.argmax_matmul import (
    argmax_matmul, argmax_matmul_backward, argmax_matmul_backward_plain,
    argmax_matmul_plain)
from refvsr_tpu_torch.bench.microbench_conv import (envelope_ratio,
                                                    make_inputs)
from refvsr_tpu_torch.bench import dcn_cases
from refvsr_tpu_torch.bench.ties import tied_rows
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.data.png import (decode_png, encode_png, read_image,
                                       write_image)
from refvsr_tpu_torch.ops.kernels import conv3x3_f32 as k6
from refvsr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_bias,
                                                  conv3x3_bias_plain)
from refvsr_tpu_torch.models.edvr import modulated_deform_conv_plain
from refvsr_tpu_torch.ops.kernels.deform_conv import deform_conv
from refvsr_tpu_torch.ops.kernels.gather_rows import (gather_rows,
                                                      gather_rows_plain)
from refvsr_tpu_torch.ops.kernels.warp_sample import (
    warp_coords, warp_sample, warp_sample_backward,
    warp_sample_backward_plain, warp_sample_plain)
from refvsr_tpu_torch.serving.predictor import Predictor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,ho,wo", [(2, 33, 131, 49, 66, 262),
                                           (1, 40, 140, 5, 37, 130)])
def test_warp_kernel_matches_plain(gen, cuda_device, n, h, w, c, ho, wo):
    x = torch.from_numpy(gen.standard_normal((n, h, w, c))
                         .astype(np.float32)).to(cuda_device)
    flow = gen.uniform(-6, 6, (n, ho, wo, 2)).astype(np.float32)
    flow[:, :3, :5] += 5000.0                      # dead: out of range
    flow[gen.random((n, ho, wo)) < 0.02, 1] = np.nan   # dead: NaN
    flow = torch.from_numpy(flow).to(cuda_device)
    before = warp_sample.launches
    got = warp_sample(x, flow)
    assert warp_sample.launches == before + 1
    want = warp_sample_plain(x, flow)
    assert bool((got[:, :3, :5] == 0).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(x.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["odd", "2x", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [5, 8, 16, 48, 49, 56])
def test_warp_kernel_channel_groups(gen, cuda_device, c, dtype, grid):
    """Every channel count the forward kernel groups differently: the 16-byte
    path (C % 8 == 0 in bf16, C % 4 == 0 in f32) and the one-channel-at-a-time
    path, onto an odd-width grid, onto the 2x grid, and from an x whose data
    is not 16-byte aligned (the one-channel path whatever C)."""
    n, h, w = 2, 33, 47
    ho, wo = (37, 53) if grid == "odd" else (2 * h, 2 * w)
    x = torch.from_numpy(gen.standard_normal((n, h, w, c))
                         .astype(np.float32)).to(cuda_device, dtype)
    if grid == "unaligned":
        x = torch.cat([torch.zeros(1, dtype=dtype, device=cuda_device),
                       x.reshape(-1)])[1:].view(n, h, w, c)
        assert x.is_contiguous() and x.data_ptr() % 16
    flow = gen.uniform(-6, 6, (n, ho, wo, 2)).astype(np.float32)
    flow[:, :3, :5] += 5000.0                      # dead: out of range
    flow[gen.random((n, ho, wo)) < 0.02, 0] = np.nan   # dead: NaN
    flow = torch.from_numpy(flow).to(cuda_device, dtype)
    before = warp_sample.launches
    got = warp_sample(x, flow)
    assert warp_sample.launches == before + 1
    want = warp_sample_plain(x, flow)
    sx, sy = warp_coords((h, w), flow)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    dead = ~((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1))
    assert bool(dead.any()) and bool((got[dead] == 0).all())
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert float((got.float() - want.float()).abs().max()) <= tol * float(
        x.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(3, 16), (9, 5)])
def test_warp_kernel_64bit_offsets(gen, cuda_device, n, c):
    """x of more than 2^31 elements (6 GB of bf16), so the forward kernel
    takes its 64-bit offsets: batch item 2 (C = 16, the 16-byte path) or
    items 7 and 8 (C = 5, one channel at a time) start past 2^31."""
    h = w = 8192
    assert n * h * w * c >= 2 ** 31
    x = torch.randn((n, h, w, c), dtype=torch.bfloat16, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    flow = gen.uniform(-6, 6, (n, 256, 384, 2)).astype(np.float32)
    flow[:, :3, :5] += 50000.0                     # dead: out of range
    flow = torch.from_numpy(flow).to(cuda_device, torch.bfloat16)
    got = warp_sample(x, flow)
    want = warp_sample_plain(x, flow)
    assert bool((got[:, :3, :5] == 0).all())
    assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -6 * \
        float(x.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,ho,wo", [(2, 33, 131, 49, 66, 262),
                                           (1, 40, 140, 5, 37, 130)])
def test_warp_backward_kernel_matches_plain(gen, cuda_device, n, h, w, c,
                                            ho, wo):
    x = torch.from_numpy(gen.standard_normal((n, h, w, c))
                         .astype(np.float32)).to(cuda_device)
    flow = gen.uniform(-6, 6, (n, ho, wo, 2)).astype(np.float32)
    flow[:, :3, :5] += 5000.0                      # dead: out of range
    flow[gen.random((n, ho, wo)) < 0.02, 1] = np.nan   # dead: NaN
    flow = torch.from_numpy(flow).to(cuda_device)
    g = torch.from_numpy(gen.standard_normal((n, ho, wo, c))
                         .astype(np.float32)).to(cuda_device)
    before = warp_sample_backward.launches
    dx, dflow = warp_sample_backward(g, flow, x.shape, x)
    assert warp_sample_backward.launches == before + 1
    dx_p, dflow_p = warp_sample_backward_plain(g, flow, x.shape, x)
    sx, sy = warp_coords((h, w), flow)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    dead = ~((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1))
    assert bool(dead.any()) and bool((dflow[dead] == 0).all())
    for got, want in ((dx, dx_p), (dflow, dflow_p)):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def _dead_points(h, w, flow):
    sx, sy = warp_coords((h, w), flow)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    return ~((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("with_dflow", [False, True])
@pytest.mark.parametrize("grid", ["odd", "2x", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [5, 8, 16, 48, 49, 56])
def test_warp_backward_kernel_channel_groups(gen, cuda_device, c, dtype, grid,
                                             with_dflow):
    """The backward kernel at every channel grouping of the forward test
    (16-byte loads of g and x, and one channel at a time; float4 reductions
    into the padded dx), onto an odd-width grid, from the low-res grid onto
    the 2x one, and with unaligned g and x; dx alone and dx + dflow."""
    n, h, w = 2, 33, 47
    ho, wo = (37, 53) if grid == "odd" else (2 * h, 2 * w)

    def tensor(shape):
        t = torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                             ).to(cuda_device, dtype)
        if grid == "unaligned":
            t = torch.cat([torch.zeros(1, dtype=dtype, device=cuda_device),
                           t.reshape(-1)])[1:].view(shape)
            assert t.is_contiguous() and t.data_ptr() % 16
        return t

    x = tensor((n, h, w, c))
    g = tensor((n, ho, wo, c))
    flow = gen.uniform(-6, 6, (n, ho, wo, 2)).astype(np.float32)
    flow[:, :3, :5] += 5000.0                      # dead: out of range
    flow[gen.random((n, ho, wo)) < 0.02, 0] = np.nan   # dead: NaN
    flow = torch.from_numpy(flow).to(cuda_device, dtype)
    before = warp_sample_backward.launches
    dx, dflow = warp_sample_backward(g, flow, x.shape,
                                     x if with_dflow else None)
    assert warp_sample_backward.launches == before + 1
    dx_p, dflow_p = warp_sample_backward_plain(
        g.float(), flow.float(), x.shape, x.float() if with_dflow else None)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert dx.shape == x.shape and dx.dtype == dtype
    assert float((dx.float() - dx_p).abs().max()) <= tol * float(
        dx_p.abs().max())
    dead = _dead_points(h, w, flow)
    assert bool(dead.any())
    if with_dflow:
        assert dflow.shape == flow.shape and dflow.dtype == dtype
        assert bool((dflow[dead] == 0).all())
        assert float((dflow.float() - dflow_p).abs().max()) <= tol * float(
            dflow_p.abs().max())
    else:
        assert dflow is None
    # a gradient carried by dead points alone leaves dx all zeros
    dx_dead, _ = warp_sample_backward(
        torch.where(dead[..., None], g, torch.zeros_like(g)), flow, x.shape)
    assert bool((dx_dead == 0).all())


@pytest.mark.cuda
def test_warp_backward_kernel_64bit_offsets(gen, cuda_device):
    """dx of more than 2^31 elements (x 3 x 8192 x 8192 x 16 bf16), so the
    backward kernel takes its 64-bit offsets: batch item 2 starts past
    2^31. Compared one batch item at a time against the plain backward in
    f32."""
    n, h, w, c = 3, 8192, 8192, 16
    assert n * h * w * c >= 2 ** 31
    g = torch.randn((n, 256, 384, c), dtype=torch.bfloat16,
                    device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    flow = gen.uniform(-6, 6, (n, 256, 384, 2)).astype(np.float32)
    flow[:, :3, :5] += 50000.0                     # dead: out of range
    flow = torch.from_numpy(flow).to(cuda_device, torch.bfloat16)
    dx, _ = warp_sample_backward(g, flow, (n, h, w, c))
    assert dx.shape == (n, h, w, c) and dx.dtype == torch.bfloat16
    for b in range(n):
        want, _ = warp_sample_backward_plain(g[b:b + 1].float(),
                                             flow[b:b + 1].float(),
                                             (1, h, w, c))
        assert float((dx[b:b + 1].float() - want).abs().max()) <= \
            2.0 ** -7 * float(want.abs().max())
        del want


@pytest.mark.cuda
def test_warp_autograd_runs_backward_kernel(gen, cuda_device):
    x = torch.from_numpy(gen.standard_normal((1, 20, 30, 8))
                         .astype(np.float32)).to(cuda_device)
    flow = torch.from_numpy(gen.uniform(-3, 3, (1, 40, 60, 2))
                            .astype(np.float32)).to(cuda_device)
    xg = x.clone().requires_grad_(True)
    before = (warp_sample.launches, warp_sample_backward.launches)
    warp_sample(xg, flow).square().sum().backward()
    assert (warp_sample.launches, warp_sample_backward.launches) == (
        before[0] + 1, before[1] + 1)
    xp = x.clone().requires_grad_(True)
    warp_sample_plain(xp, flow).square().sum().backward()
    assert float((xg.grad - xp.grad).abs().max()) <= 1e-5 * float(
        xp.grad.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,l_ref,l_lr,d", [
    (torch.float32, 2, 300, 517, 144), (torch.float32, 1, 77, 130, 144),
    (torch.float32, 2, 300, 517, 16), (torch.float32, 2, 300, 517, 288)] + [
    (torch.bfloat16, 2, 300, 517, d) for d in range(16, 145, 16)])
def test_argmax_kernel_matches_plain(gen, cuda_device, dtype, n, l_ref, l_lr,
                                     d):
    """f32: conf within 1e-5 and indices equal; bf16: conf within 1e-4 and
    every pick within 1e-4 of the row's max. Both: the duplicated ref rows
    never win over the rows they copy."""
    dup = 20
    ref = gen.standard_normal((n, l_ref, d)).astype(np.float32)
    ref[:, -dup:] = ref[:, :dup]
    lr = gen.standard_normal((n, l_lr, d)).astype(np.float32)
    lr[:, :dup] = ref[:, :dup]
    ref /= np.linalg.norm(ref, axis=2, keepdims=True)
    lr /= np.linalg.norm(lr, axis=2, keepdims=True)
    ref_t = torch.from_numpy(ref).to(cuda_device, dtype)
    lr_t = torch.from_numpy(lr).to(cuda_device, dtype)
    before = argmax_matmul.launches
    conf, idx = argmax_matmul(ref_t, lr_t)
    assert argmax_matmul.launches == before + 1
    conf_p, idx_p = argmax_matmul_plain(ref_t, lr_t)
    assert torch.equal(idx[:, :dup].cpu(),
                       torch.arange(dup, dtype=torch.int32).expand(n, dup))
    if dtype == torch.float32:
        assert float((conf - conf_p).abs().max()) <= 1e-5
        assert torch.equal(idx, idx_p)
    else:
        assert float((conf - conf_p).abs().max()) <= 1e-4
        score = (ref_t.float().gather(1, idx.long()[..., None].expand(
            -1, -1, d)) * lr_t.float()).sum(-1)
        assert float((conf_p - score).max()) <= 1e-4


@pytest.mark.cuda
def test_argmax_bf16_kernel_ties_at_ragged_sizes(gen, cuda_device):
    n, l_ref, l_lr, d = 3, 1000, 3001, 144
    ref, lr, first = tied_rows(gen, n, l_ref, l_lr, d)
    ref, lr = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in (ref, lr))
    before = argmax_matmul.launches
    conf, idx = argmax_matmul(ref, lr)
    assert argmax_matmul.launches == before + 1
    conf_p, _ = argmax_matmul_plain(ref, lr)
    assert float((conf - conf_p).abs().max()) <= 1e-4
    assert torch.equal(idx[:, :first.size].cpu(),
                       torch.from_numpy(first).expand(n, first.size))
    # every pick scores within 1e-4 of the row's max
    score = (ref.float().gather(1, idx.long()[..., None].expand(-1, -1, d))
             * lr.float()).sum(-1)
    assert float((conf_p - score).max()) <= 1e-4


@pytest.mark.cuda
def test_argmax_f32_kernel_at_training_shape(gen, cuda_device):
    n, l_ref, l_lr, d = 14, 1024, 1024, 144
    ref, lr, first = tied_rows(gen, n, l_ref, l_lr, d)
    ref, lr = torch.from_numpy(ref).to(cuda_device), torch.from_numpy(
        lr).to(cuda_device)
    conf, idx = argmax_matmul(ref, lr)
    conf_p, idx_p = argmax_matmul_plain(ref, lr)
    assert float((conf - conf_p).abs().max()) <= 1e-5
    assert torch.equal(idx, idx_p)
    assert torch.equal(idx[:, :first.size].cpu(),
                       torch.from_numpy(first).expand(n, first.size))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 192),
                                     (torch.float32, 304),
                                     (torch.float32, 72)])
def test_argmax_kernel_refuses_what_it_cannot_take(cuda_device, dtype, d):
    ref = torch.zeros((1, 8, d), dtype=dtype, device=cuda_device)
    with pytest.raises(ValueError):
        argmax_matmul(ref, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,l_ref,l_lr,d", [(2, 300, 517, 144),
                                            (14, 1024, 1024, 144)])
def test_argmax_backward_kernel_matches_plain(gen, cuda_device, n, l_ref,
                                              l_lr, d):
    dup = 20
    ref = gen.standard_normal((n, l_ref, d)).astype(np.float32)
    ref[:, -dup:] = ref[:, :dup]
    lr = gen.standard_normal((n, l_lr, d)).astype(np.float32)
    lr[:, :dup] = ref[:, :dup]
    ref /= np.linalg.norm(ref, axis=2, keepdims=True)
    lr /= np.linalg.norm(lr, axis=2, keepdims=True)
    ref_t = torch.from_numpy(ref).to(cuda_device).requires_grad_(True)
    lr_t = torch.from_numpy(lr).to(cuda_device).requires_grad_(True)
    conf, idx = argmax_matmul(ref_t, lr_t)
    g = torch.from_numpy(gen.standard_normal((n, l_lr)).astype(np.float32)
                         ).to(cuda_device)
    before = argmax_matmul_backward.launches
    conf.backward(g)
    assert argmax_matmul_backward.launches == before + 1
    d_ref_p, d_lr_p = argmax_matmul_backward_plain(ref_t.detach(),
                                                   lr_t.detach(), idx, g)
    assert float((lr_t.grad - d_lr_p).abs().max()) <= 1e-6
    assert float((ref_t.grad - d_ref_p).abs().max()) <= 1e-5 * float(
        d_ref_p.abs().max())
    assert bool((ref_t.grad[:, -dup:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, d)
                                     for d in range(16, 289, 16)]
                         + [(torch.bfloat16, d) for d in range(16, 145, 16)])
@pytest.mark.parametrize("one_row", [False, True])
def test_argmax_backward_kernel_every_d(gen, cuda_device, dtype, d, one_row):
    """Every D the forward kernels take, at a ragged L_lr; with `one_row`,
    every LR row of a batch item picks one ref row, so all of its
    reductions meet there."""
    n, l_ref, l_lr = 3, 211, 517
    ref = torch.from_numpy(gen.standard_normal((n, l_ref, d))
                           .astype(np.float32)).to(cuda_device, dtype)
    lr = torch.from_numpy(gen.standard_normal((n, l_lr, d))
                          .astype(np.float32)).to(cuda_device, dtype)
    idx = (np.full((n, l_lr), 17) if one_row
           else gen.integers(0, l_ref, (n, l_lr)))
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
    g = torch.from_numpy(gen.standard_normal((n, l_lr)).astype(np.float32)
                         ).to(cuda_device)
    before = argmax_matmul_backward.launches
    d_ref, d_lr = argmax_matmul_backward(ref, lr, idx, g)
    assert argmax_matmul_backward.launches == before + 1
    assert d_ref.dtype == dtype and d_lr.dtype == dtype
    # d_lr: one f32 product rounded once to the input type, as the plain
    # version does
    _, d_lr_p = argmax_matmul_backward_plain(ref, lr, idx, g)
    assert float((d_lr.float() - d_lr_p.float()).abs().max()) <= 1e-6 * \
        float(d_lr_p.float().abs().max())
    d_ref_p, _ = argmax_matmul_backward_plain(ref.float(), lr.float(), idx,
                                              g)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert float((d_ref.float() - d_ref_p).abs().max()) <= tol * float(
        d_ref_p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("needs", [(True, False), (False, True)])
def test_argmax_backward_kernel_computes_what_is_asked(gen, cuda_device,
                                                       needs):
    n, l_ref, l_lr, d = 2, 300, 517, 144
    ref = torch.from_numpy(gen.standard_normal((n, l_ref, d))
                           .astype(np.float32)).to(cuda_device)
    lr = torch.from_numpy(gen.standard_normal((n, l_lr, d))
                          .astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(gen.integers(0, l_ref, (n, l_lr)).astype(
        np.int32)).to(cuda_device)
    g = torch.from_numpy(gen.standard_normal((n, l_lr)).astype(np.float32)
                         ).to(cuda_device)
    d_ref, d_lr = argmax_matmul_backward(ref, lr, idx, g, needs)
    d_ref_p, d_lr_p = argmax_matmul_backward_plain(ref, lr, idx, g)
    assert (d_ref is None) != needs[0] and (d_lr is None) != needs[1]
    got, want, tol = ((d_ref, d_ref_p, 1e-5) if needs[0]
                      else (d_lr, d_lr_p, 1e-6))
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,offset", [(torch.float32, 36, 0),
                                            (torch.bfloat16, 20, 0),
                                            (torch.float32, 144, 1),
                                            (torch.bfloat16, 144, 1)])
def test_argmax_backward_kernel_refuses_what_the_forward_refuses(
        cuda_device, dtype, d, offset):
    """D not a multiple of 16, or rows not 16-byte aligned: the backward
    wrapper raises, as the forward does, and launches nothing."""
    n, l_ref, l_lr = 2, 40, 30
    ref = torch.zeros(n * l_ref * d + offset, dtype=dtype, device=cuda_device
                      )[offset:].view(n, l_ref, d)
    lr = torch.zeros((n, l_lr, d), dtype=dtype, device=cuda_device)
    idx = torch.zeros((n, l_lr), dtype=torch.int32, device=cuda_device)
    g = torch.ones((n, l_lr), device=cuda_device)
    before = argmax_matmul_backward.launches
    with pytest.raises(ValueError):
        argmax_matmul_backward(ref, lr, idx, g)
    assert argmax_matmul_backward.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [
    (37, 53, 16), (25, 131, 48), (4, 70, 80), (1, 1, 32),
    # mid-tile in H at every tile height (8, 4, 2) and in W
    (29, 101, 16), (29, 101, 32), (29, 101, 48), (29, 101, 64),
    (29, 101, 80),
    # one row narrower than a tile
    (1, 40, 48), (1, 7, 16),
    # more tiles than resident blocks: the ring wraps
    (300, 700, 48), (203, 517, 16), (151, 450, 80),
    # the model's resblock conv
    (1080, 1920, 48)])
def test_conv3x3_kernel_matches_plain(cuda_device, h, w, c):
    x, wm, bias = make_inputs(h, w, c, cuda_device)
    before = conv3x3_bias.launches
    got = conv3x3_bias(x, wm, bias)
    assert conv3x3_bias.launches == before + 1
    want = conv3x3_bias_plain(x, wm, bias)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert envelope_ratio(got, want) <= 1.0


@pytest.mark.cuda
def test_k3_route_in_the_8k_stream(cuda_device, monkeypatch):
    """RefVSR_MFID_8K at full width, bf16, at a small frame (64x128 LR,
    T = 7): one ``forward_first`` and one ``forward_stream`` window. K3
    launches once for each ``Conv2d`` call that ``routed_kernel`` routes to
    it, and each such call's output lies within K3's tolerance of the library
    convolution of the same module on the same input; both windows' SR
    frames and the carried state lie within the 8K configuration's
    ``sr_rmse`` and ``state_rel`` limits of the run whose convolutions all
    call ``nn.Conv2d.forward``."""
    import json
    from pathlib import Path

    import torch.nn as nn

    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models import blocks
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    cfg = get_config("RefVSR_MFID_8K")
    limits = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                         / "configs" / "RefVSR_MFID_8K.json").read_text()
                        )["limits"]
    t = cfg.frame_num
    g = torch.Generator().manual_seed(18)
    lrs = torch.rand((1, t + 1, 64, 128, 3), generator=g)
    refs = torch.rand((1, t + 1, 64, 128, 3), generator=g)

    def windows(hook=None):
        net = build_refvsr(cfg, device=cuda_device, dtype=torch.bfloat16,
                           seed=0)
        if hook is not None:
            for m in net.modules():
                if isinstance(m, blocks.Conv2d):
                    m.register_forward_hook(hook)
        runner = StreamRunner(net, cfg.reset_branch, device=cuda_device,
                              compute_dtype=torch.bfloat16)
        outs = [runner.process_device(lrs[:, i:i + t], refs[:, i:i + t],
                                      is_first=i == 0)[0].float()
                for i in range(2)]
        st = runner.state
        return outs, [st.feat_prop.float(), st.feat_prop_up.float()]

    ratios = []

    def check_routed(m, args, out):
        x = args[0]
        if blocks.routed_kernel(m, x) == "k3":
            want = nn.Conv2d.forward(m, x.permute(0, 3, 1, 2))
            ratios.append(envelope_ratio(out[0], want[0].permute(1, 2, 0)))

    before = conv3x3_bias.launches
    got, got_state = windows(check_routed)
    assert conv3x3_bias.launches - before == len(ratios) > 0
    assert max(ratios) <= 1.0

    def library(self, x):
        return nn.Conv2d.forward(self, x.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
    monkeypatch.setattr(blocks.Conv2d, "forward", library)
    before = conv3x3_bias.launches
    want, want_state = windows()
    assert conv3x3_bias.launches == before
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float(torch.sqrt(((a - b) ** 2).mean())) <= limits["sr_rmse"]
    for a, b in zip(got_state, want_state):
        rel = torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)
        assert float(rel) <= limits["state_rel"]


def _k6_operands(h, w, c, device, seed):
    """Seeded x (H, W, C) and a Conv2d's weight and bias (torch's default
    init, as ``init_weights`` draws them), f32 on `device`."""
    from refvsr_tpu_torch.models.blocks import Conv2d, init_weights
    conv = Conv2d(c, c, 3)
    init_weights(conv, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((h, w, c), generator=g).to(device)
    return x, conv.weight.detach().to(device), conv.bias.detach().to(device)


def _errors(got, want):
    """max |got - want| over max |want| and the RMS error over the RMS."""
    d = got.double() - want
    return (float(d.abs().max() / want.abs().max()),
            float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [
    (270, 480, 48), (270, 480, 36), (270, 480, 32), (540, 960, 48),
    (135, 240, 48), (9, 13, 48), (9, 13, 36), (9, 13, 32), (29, 101, 32),
    (1, 130, 48), (300, 700, 36)])
def test_conv3x3_f32_kernel_against_f64(cuda_device, h, w, c):
    import torch.nn.functional as F
    x, weight, bias = _k6_operands(h, w, c, cuda_device, seed=h + w + c)
    wp = k6.pack(weight)
    b = bias.reshape(1, 1, c).contiguous()
    before = k6.conv3x3_f32.launches
    got = k6.conv3x3_f32(x, wp, b)
    assert k6.conv3x3_f32.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    nchw = x.permute(2, 0, 1)[None]
    want = F.conv2d(nchw.double(), weight.double(), bias.double(),
                    padding=1)[0].permute(1, 2, 0)
    library = F.conv2d(nchw, weight, bias, padding=1)[0].permute(1, 2, 0)
    # one TF32 pass: x's low part and the weights' low part dropped
    wp_hi = wp.clone()
    wp_hi[1].zero_()
    one_pass = k6.conv3x3_f32(k6._tf32(x), wp_hi, b)
    limit = [2 * e for e in _errors(library, want)]
    err = _errors(got, want)
    control = _errors(one_pass, want)
    assert err[0] <= limit[0] and err[1] <= limit[1], (err, limit)
    assert control[0] > limit[0] and control[1] > limit[1], (control, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [(1, 1, 48), (1, 7, 32), (2, 65, 36),
                                   (64, 64, 48), (3, 200, 36)])
def test_conv3x3_f32_kernel_matches_plain(cuda_device, h, w, c):
    x, weight, bias = _k6_operands(h, w, c, cuda_device, seed=c)
    wp, b = k6.pack(weight), bias.reshape(1, 1, c).contiguous()
    got = k6.conv3x3_f32(x, wp, b)
    want = k6.conv3x3_f32_plain(x, wp, b)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_conv3x3_f32_kernel_counts_and_refuses(cuda_device):
    x, weight, bias = _k6_operands(16, 80, 36, cuda_device, seed=5)
    wp, b = k6.pack(weight), bias.reshape(1, 1, 36).contiguous()
    before = k6.conv3x3_f32.launches
    for args in ((x.to(torch.bfloat16), wp, b), (x[..., :32], wp, b),
                 (x.transpose(0, 1), wp, b), (x, wp[:, 8:], b),
                 (x, wp.to(torch.bfloat16), b), (x, wp, b[..., :35]),
                 (torch.zeros((16, 80, 64), device=cuda_device), wp, b),
                 (x, wp.cpu(), b)):
        with pytest.raises((TypeError, ValueError)):
            k6.conv3x3_f32(*args)
    assert k6.conv3x3_f32.launches == before
    k6.conv3x3_f32(x, wp, b)
    k6.conv3x3_f32(x, wp, b)
    assert k6.conv3x3_f32.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("c", sorted(k6.PLANS))
def test_conv3x3_f32_launcher_holds_the_plan(cuda_device, c):
    """The launcher takes the plan the weights were packed for
    (``conv3x3_f32.PLANS``) and refuses any other than its Plan<C>, so the
    two copies of the tile plan cannot part silently."""
    from refvsr_tpu_torch.ops.kernels import build
    x, weight, bias = _k6_operands(9, 13, c, cuda_device, seed=c)
    wp, b = k6.pack(weight), bias.reshape(1, 1, c).contiguous()
    y = torch.empty_like(x)
    fn = build.function("conv3x3_f32", "conv3x3_f32_launch", k6._ARGS)
    plans = {k6.PLANS[c]} | {p for p in k6.PLANS.values()} | {
        (n, 2 if vec == 4 else 4) for n, vec in k6.PLANS.values()}
    for plan in sorted(plans):
        args = (x.data_ptr(), wp.data_ptr(), b.data_ptr(), y.data_ptr(),
                9, 13, c, *plan)
        if plan == k6.PLANS[c]:
            build.launch(fn, x.device, *args)
        else:
            with pytest.raises(RuntimeError):
                build.launch(fn, x.device, *args)
    torch.cuda.synchronize()
    assert torch.equal(y, k6.conv3x3_f32(x, wp, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "k3"),
                                          (torch.float32, "k6")])
def test_spatial_bands_run_the_kernel_of_one_rank(cuda_device, monkeypatch,
                                                  dtype, kernel):
    """Two ranks' bands of a 270x480x48 image (each rank's row exchange
    served from the whole image, in one process): each band's convolution
    launches the kernel the whole image's does, and the cropped bands are
    the whole image's output bit for bit (the kernels sum each output
    pixel in one order wherever it lies)."""
    from refvsr_tpu_torch.models.blocks import Conv2d, init_weights
    from refvsr_tpu_torch.parallel import mesh, spatial
    conv = Conv2d(48, 48, 3)
    init_weights(conv, torch.Generator().manual_seed(12))
    conv = conv.to(cuda_device, dtype)
    g = torch.Generator().manual_seed(13)
    x = torch.randn((1, 270, 480, 48), generator=g).to(cuda_device, dtype)
    bands = [x[:, :135], x[:, 135:]]

    def all_gather_rows(edge, dim, sizes=None):
        e = edge.shape[1] // 2
        return torch.cat([torch.cat([b[:, :e], b[:, -e:]], 1)
                          for b in bands], 1)
    monkeypatch.setattr(mesh, "all_gather_rows", all_gather_rows)
    fn = conv3x3_bias if kernel == "k3" else k6.conv3x3_f32
    with torch.inference_mode():
        before = fn.launches
        want = conv(x)
        got = []
        for rank in range(2):
            monkeypatch.setattr(spatial, "_CTX",
                                spatial.SpatialCtx(2, rank, 4, {135: 270}))
            got.append(conv(bands[rank]))
        assert fn.launches == before + 3
    assert torch.equal(torch.cat(got, 1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("config,hw", [("RefVSR_MFID", (64, 96)),
                                       ("RefVSR_IR_MFID", (32, 44))])
def test_k6_route_in_the_f32_streams(cuda_device, monkeypatch, config, hw):
    """A first and a streamed window of the f32 models at their widths
    (RefVSR_MFID: 48 channels; RefVSR_IR_MFID: 36, EDVR-M at 64): each
    convolution ``routed_kernel`` names "k6" launches K6 once, with a
    ``refvsr.k6`` span inside its ``refvsr.conv``; the SR frames lie within
    the cells' ``sr_rmse`` limit (1e-5) of the same windows with every
    convolution on cuDNN."""
    import json
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models import blocks
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    cfg = get_config(config)
    limits = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                         / "configs" / f"{config}.json").read_text()
                        )["limits"]
    net = build_refvsr(cfg, device="cpu", seed=7)
    t = cfg.frame_num
    g = torch.Generator().manual_seed(8)
    lrs = torch.rand((1, t + 1, *hw, 3), generator=g)
    refs = torch.rand((1, t + 1, *hw, 3), generator=g)
    routed = []

    def count(m, args, out):
        routed.append(blocks.routed_kernel(m, args[0]) == "k6")

    def stream():
        hooks = [m.register_forward_hook(count) for m in net.modules()
                 if isinstance(m, blocks.Conv2d)]
        runner = StreamRunner(
            net, cfg.reset_branch, device=cuda_device,
            keyframe_stride=cfg.keyframe_stride
            if cfg.network == "RefVSR_IR" else None)
        outs, counts = [], []
        for wi in range(2):
            routed.clear()
            before = k6.conv3x3_f32.launches
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                outs.append(runner.process(lrs[:, wi:wi + t],
                                           refs[:, wi:wi + t], wi == 0)[0])
            k6_spans = [e for e in prof.events() if e.name == "refvsr.k6"]
            assert all(e.cpu_parent.name == "refvsr.conv" for e in k6_spans)
            counts.append((sum(routed), len(k6_spans),
                           k6.conv3x3_f32.launches - before))
        for hk in hooks:
            hk.remove()
        return outs, counts

    got, counts = stream()
    assert all(n == spans == launches > 0 for n, spans, launches in counts)
    monkeypatch.setattr(blocks, "routed_kernel", lambda *a: None)
    before = k6.conv3x3_f32.launches
    want, _ = stream()
    assert k6.conv3x3_f32.launches == before
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        assert float(np.sqrt(np.mean((a - b) ** 2))) <= limits["sr_rmse"]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,lanes,points,dtype", [
    (64, 128, 256, torch.float32), (1000, 72, 4099, torch.bfloat16),
    (3, 4, 1, torch.float32), (2048, 128, 1 << 20, torch.bfloat16)])
def test_gather_kernel_matches_plain(gen, cuda_device, rows, lanes, points,
                                     dtype):
    tab = torch.from_numpy(gen.standard_normal((rows, lanes))
                           .astype(np.float32)).to(cuda_device, dtype)
    idx = torch.from_numpy(gen.integers(-50, rows + 50, (points, 1),
                                        dtype=np.int32)).to(cuda_device)
    idx[0] = -1
    before = gather_rows.launches
    got = gather_rows(tab, idx)
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(tab, idx))
    assert torch.equal(got[0], tab[0])


@pytest.mark.cuda
def test_microbench_entry_points_on_the_card(cuda_device):
    """``microbench_conv.run`` and ``microbench_gather.run`` at small
    sizes and ``microbench_gather.main(["--check"])``: each launches its
    own kernel and no other; K3 within its envelope, K4 bitwise."""
    from refvsr_tpu_torch.bench import microbench_conv, microbench_gather
    from refvsr_tpu_torch.ops.kernels.warp_sample import warp_sample_banded
    fns = (warp_sample, warp_sample_banded, warp_sample_backward,
           argmax_matmul, argmax_matmul_backward, conv3x3_bias, gather_rows,
           deform_conv)

    def launched(run):
        before = [f.launches for f in fns]
        out = run()
        return out, {f.__name__: f.launches - b
                     for f, b in zip(fns, before) if f.launches != b}

    conv, n = launched(lambda: microbench_conv.run((64, 128), 48, iters=3))
    assert set(n) == {"conv3x3_bias"} and n["conv3x3_bias"] > 0
    assert conv["finite"] and conv["ratio"] <= 1.0
    gather, n = launched(lambda: microbench_gather.run(256, 128, 4096))
    assert set(n) == {"gather_rows"} and n["gather_rows"] > 0
    assert gather["equal"]
    rc, n = launched(lambda: microbench_gather.main(["--check"]))
    assert rc == 0 and n == {"gather_rows": 3}


def test_png_round_trip(gen):
    img = gen.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    assert np.array_equal(decode_png(encode_png(img)), img)


@pytest.mark.cuda
@pytest.mark.parametrize("c,up", [(49, False), (48, True)])
def test_warp_kernel_batch2_zero_flow(gen, cuda_device, c, up):
    """The pipelined dispatch's two lanes on the serving path's zero flows:
    the feature warp (49 channels) and the UP warp onto the 2x grid."""
    h, w = 24, 40
    x = torch.from_numpy(gen.standard_normal((2, h, w, c)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    ho, wo = (2 * h, 2 * w) if up else (h, w)
    flow = torch.zeros((2, ho, wo, 2), device=cuda_device,
                       dtype=torch.bfloat16)
    before = warp_sample.launches
    got = warp_sample(x, flow)
    assert warp_sample.launches == before + 1
    want = warp_sample_plain(x, flow)
    assert got.shape == (2, ho, wo, c)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -6 * float(x.float().abs().max())
    # each lane is computed as if it were alone
    assert torch.equal(got[1:], warp_sample(x[1:], flow[1:]))


@pytest.mark.cuda
def test_predictor_card_matches_cpu(cuda_device, tmp_path, gen):
    cfg = get_config("RefVSR_MFID_8K", num_blocks=2, mid_channels=8)
    for name in ("lr", "ref"):
        write_image(tmp_path / f"{name}.png", gen.random((66, 83, 3)))
    lr, ref = read_image(tmp_path / "lr.png"), read_image(tmp_path / "ref.png")
    outs = [Predictor(cfg, device=d, compute_dtype=torch.float32).enhance(
        lr, ref) for d in ("cpu", cuda_device)]
    assert outs[1].shape == (4 * 64, 4 * 80, 3)
    assert np.isfinite(outs[1]).all()
    assert float(np.abs(outs[0] - outs[1]).max()) <= 1e-3


# ------------------------------------------------ the training entry point


@pytest.mark.cuda
def test_argmax_f32_kernel_at_validation_shape(gen, cuda_device):
    """K2 in f32 (3xTF32) at a streamed validation window of
    RefVSR_MFID_8K: 32,400 ref x 129,600 LR patches, D = 144; conf within
    1e-5 of the plain version (TF32 off), every pick within 1e-5 of the
    row's max."""
    n, l_ref, l_lr, d = 1, 32400, 129600, 144
    ref = torch.nn.functional.normalize(torch.randn(
        (n, l_ref, d), device=cuda_device), dim=2)
    lr = torch.nn.functional.normalize(torch.randn(
        (n, l_lr, d), device=cuda_device), dim=2)
    before = argmax_matmul.launches
    conf, idx = argmax_matmul(ref, lr)
    assert argmax_matmul.launches == before + 1
    conf_p, _ = argmax_matmul_plain(ref, lr)
    assert float((conf - conf_p).abs().max()) <= 1e-5
    score = (ref[0][idx[0].long()] * lr[0]).sum(-1)
    assert float((conf_p[0] - score).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,ho,wo", [(256, 256, 48, 256, 256),
                                         (128, 128, 49, 128, 128),
                                         (128, 128, 48, 256, 256)])
def test_warp_backward_kernel_bf16_at_training_shapes(gen, cuda_device, h, w,
                                                      c, ho, wo):
    """K1-bwd in bf16 (the is_amp policy) at the training step's shapes,
    batch 2, the flow in bf16 as the step gives it: dx and dflow within
    2^-7 of the f32 plain backward's largest value on the same values (the
    kernel sums in f32 and rounds once)."""
    n = 2
    x = torch.from_numpy(gen.standard_normal((n, h, w, c)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    flow = torch.from_numpy(gen.uniform(-6, 6, (n, ho, wo, 2)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(gen.standard_normal((n, ho, wo, c)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    before = warp_sample_backward.launches
    dx, dflow = warp_sample_backward(g, flow, x.shape, x)
    assert warp_sample_backward.launches == before + 1
    assert dx.dtype == torch.bfloat16
    dx_p, dflow_p = warp_sample_backward_plain(g.float(), flow.float(),
                                               x.shape, x.float())
    for got, want in ((dx, dx_p), (dflow, dflow_p)):
        assert float((got.float() - want).abs().max()) <= 2.0 ** -7 * float(
            want.abs().max())


@pytest.mark.cuda
def test_argmax_backward_kernel_bf16_at_training_shape(gen, cuda_device):
    """K2-bwd in bf16 at the training step's B = 14 x 1024 x 1024, D = 144:
    d_lr within 1e-6 and d_ref within 2^-7 of their largest values."""
    n, l_ref, l_lr, d = 14, 1024, 1024, 144
    ref = torch.from_numpy(gen.standard_normal((n, l_ref, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    lr = torch.from_numpy(gen.standard_normal((n, l_lr, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    _, idx = argmax_matmul(ref, lr)
    g = torch.from_numpy(gen.standard_normal((n, l_lr)).astype(np.float32)
                         ).to(cuda_device)
    before = argmax_matmul_backward.launches
    d_ref, d_lr = argmax_matmul_backward(ref, lr, idx, g)
    assert argmax_matmul_backward.launches == before + 1
    _, d_lr_p = argmax_matmul_backward_plain(ref, lr, idx, g)
    assert float((d_lr.float() - d_lr_p.float()).abs().max()) <= 1e-6 * \
        float(d_lr_p.float().abs().max())
    d_ref_p, _ = argmax_matmul_backward_plain(ref.float(), lr.float(), idx, g)
    assert float((d_ref.float() - d_ref_p).abs().max()) <= 2.0 ** -7 * float(
        d_ref_p.abs().max())


@pytest.mark.cuda
def test_runner_epoch_card_matches_cpu(cuda_device, tmp_path):
    """One tiny Runner epoch (RefVSR_MFID wiring, 2 blocks, 8 channels,
    T = 3, 2 steps, f32, TF32 off) on a tree written by data/png.py, on the
    card and on the CPU from the same seeded weights. The last window's
    losses within 1e-3 relative and the validation PSNR within 1e-2 dB;
    each parameter within 2 * lr * steps (Adam moves a parameter by about
    lr a step, so two runs that part ways on a near-zero gradient's sign
    differ by at most that)."""
    from refvsr_tpu_torch.configs import set_data_path
    from refvsr_tpu_torch.train.runner import Runner
    rng = np.random.default_rng(4)
    for split in ("train", "valid"):
        for sub, size in (("HR", 256), ("LRx2", 128), ("LRx4", 64)):
            for cam in ("UW", "W", "T"):
                for i in range(4):
                    write_image(tmp_path / "RealMCVSR" / split / sub / cam
                                / "0000" / f"{i:04d}.png",
                                rng.random((size, size, 3)))
    runs = {}
    for d in ("cpu", cuda_device):
        cfg = set_data_path(get_config(
            "RefVSR_MFID", is_train=True, mode="tiny", batch_size=1,
            patch_size=16, frame_num=3, frame_itr_num=2, num_blocks=2,
            mid_channels=8, loss="1*L1", total_itr=2, thread_num=0,
            data_offset=str(tmp_path), log_offset=str(tmp_path / str(d)),
            spynet_ckpt=None, vgg19_ckpt=None), True)
        with pytest.warns(UserWarning):
            runner = Runner(cfg, device=d)
        tr = runner.train(max_epochs=1)
        runner.close()
        with open(os.path.join(cfg.log_dir, "checkpoint", "train", "epoch",
                               "checkpoints.txt")) as f:
            psnr = float(f.readline().split(" ")[1])
        runs[str(d)] = (tr, psnr)
    (cpu, psnr_c), (card, psnr_g) = runs["cpu"], runs[str(cuda_device)]
    assert card.opt.step == cpu.opt.step == 2
    assert next(card.net.parameters()).device.type == "cuda"
    for a, b in zip(cpu.window_errs, card.window_errs):
        for k in a:
            assert abs(float(b[k]) - float(a[k])) <= 1e-3 * abs(float(a[k]))
    assert abs(psnr_g - psnr_c) <= 1e-2
    bound = 2 * cpu.config.lr_init * cpu.opt.step
    for p, q in zip(cpu.params, card.params):
        assert float((q.detach().cpu() - p.detach()).abs().max()) <= bound


# ------------------------------------------- RefVSR-IR and the eval CLI


@pytest.mark.cuda
@pytest.mark.parametrize("dg", [8, 4])
def test_deform_conv_card_matches_cpu(gen, cuda_device, dg):
    """The plain deformable convolution (not a kernel: gathers and one
    matmul) on the card against the CPU, f32 with TF32 off, fractional and
    far out-of-range offsets: within 1e-5 of the largest output."""
    from refvsr_tpu_torch.models.edvr import (modulated_deform_conv,
                                              modulated_deform_conv_plain)
    n, h, w, c, o = 2, 34, 60, 64, 64
    x = gen.standard_normal((n, h, w, c)).astype(np.float32)
    off = (gen.standard_normal((n, h, w, 2 * dg * 9)) * 3).astype(
        np.float32)
    off[:, :2, :, ::3] += 40.0
    mask = gen.random((n, h, w, dg * 9)).astype(np.float32)
    wgt = (gen.standard_normal((o, c, 3, 3)) * 0.05).astype(np.float32)
    bias = gen.standard_normal(o).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, off, mask, wgt, bias)]
    want = modulated_deform_conv(*args, dg)
    got = modulated_deform_conv(*(a.to(cuda_device) for a in args), dg)
    plain = modulated_deform_conv_plain(
        *(a.to(cuda_device) for a in args), dg)
    lim = 1e-5 * float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= lim
    assert float((plain.cpu() - want).abs().max()) <= lim


@pytest.mark.cuda
def test_ir_window_card_matches_cpu(cuda_device):
    """A tiny RefVSR-IR (2 blocks, 8 channels, EDVR at 64, T = 5, offsets
    redrawn to sample between pixels) streams a first and two further
    windows on the card, through the kernels, within the 1e-3 that
    ``chip_smoke.py`` allows the stream's card-vs-CPU check, with
    2T + 2 + 3(T // 2) K1 launches per window (18 here, 32 at the
    config's T = 9) and one K2 launch."""
    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models.edvr import ModulatedDCNPack
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    t = 5
    cfg = get_config("RefVSR_IR_MFID", num_blocks=2, mid_channels=8,
                     frame_num=t, keyframe_stride=2)
    net = build_refvsr(cfg, device="cpu", seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ModulatedDCNPack):
                m.conv_offset.weight.copy_(torch.randn(
                    m.conv_offset.weight.shape, generator=g) * 0.1)
    lrs = torch.rand((1, t + 2, 30, 42, 3), generator=g)
    refs = torch.rand((1, t + 2, 30, 42, 3), generator=g)
    runners = [StreamRunner(net, None, device=d, keyframe_stride=2)
               for d in ("cpu", cuda_device)]
    for wi in range(3):
        a, b = lrs[:, wi:wi + t], refs[:, wi:wi + t]
        want = runners[0].process(a, b, wi == 0)[0]
        k1, k2 = warp_sample.launches, argmax_matmul.launches
        got = runners[1].process(a, b, wi == 0)[0]
        assert (warp_sample.launches - k1, argmax_matmul.launches - k2) == (
            2 * t + 2 + 3 * (t // 2), 1)
        assert got.shape == (1, 120, 168, 3)
        assert float(np.abs(got - want).max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,dg", [
    (n, h, w, 64, 8) for n in (2, 3) for h, w, _ in dcn_cases.LEVELS]
    + [(2, 37, 53, 32, 4), (1, 29, 131, 32, 8), (3, 5, 7, 64, 4)])
def test_deform_conv_kernel_matches_plain(cuda_device, n, h, w, c, dg):
    args = dcn_cases.make_inputs(n, h, w, c, dg, seed=n * h + c,
                                 device=cuda_device, frames=5)
    assert n == 1 or not args[0].is_contiguous()
    got = deform_conv(*args, dg)
    want = modulated_deform_conv_plain(*args, dg)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    lim = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= lim


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,dg,kind", [
    (2, 37, 53, 64, 8, "edges"), (3, 68, 120, 64, 8, "edges"),
    (2, 68, 120, 64, 8, "integer"), (2, 29, 31, 32, 4, "edges"),
    (1, 9, 10, 32, 8, "edges")])
def test_deform_conv_kernel_dead_and_edge_taps(cuda_device, n, h, w, c, dg,
                                               kind):
    args = dcn_cases.make_inputs(n, h, w, c, dg, kind, seed=h,
                                 device=cuda_device)
    got = deform_conv(*args, dg)
    want = modulated_deform_conv_plain(*dcn_cases.dead_for_nan(*args), dg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    lim = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= lim
    if kind == "edges":
        for y, x in dcn_cases.dead_pixels(h, w):
            assert torch.equal(got[0, y, x], args[4])


@pytest.mark.cuda
def test_deform_conv_kernel_counts_and_refuses(cuda_device):
    args = dcn_cases.make_inputs(2, 17, 19, device=cuda_device)
    before = deform_conv.launches
    for i in range(3):
        deform_conv(*args, 8)
        assert deform_conv.launches == before + i + 1
    x, off, mask, wgt, bias = args
    for bad in ((x.to(torch.bfloat16), off, mask, wgt, bias),
                (torch.cat([x, x], -1)[..., :64], off, mask, wgt, bias),
                (x[..., :48].contiguous(), off, mask, wgt[:48, :48],
                 bias[:48]),
                (x, off, mask, wgt, None)):
        with pytest.raises((TypeError, ValueError)):
            deform_conv(*bad, 8)
    assert deform_conv.launches == before + 3


@pytest.mark.cuda
def test_k5_route_in_an_ir_window(cuda_device, monkeypatch):
    """RefVSR_IR_MFID at its widths (30 blocks, 36 channels, EDVR-M at 64
    with 8 groups), offset convs redrawn so that the taps fall between
    pixels, streams a first and a further window of 32x44 frames: each
    window runs its 20 deformable convolutions on K5, a ``refvsr.k5`` span
    inside each ``refvsr.dcn``, and its SR frame lies within the cell's
    ``sr_rmse`` limit (1e-5) of the same window on the row-gather path."""
    from torch.profiler import ProfilerActivity, profile

    from refvsr_tpu_torch.eval.stream import StreamRunner
    from refvsr_tpu_torch.models import edvr
    from refvsr_tpu_torch.models.edvr import ModulatedDCNPack
    from refvsr_tpu_torch.models.refvsr import build_refvsr
    cfg = get_config("RefVSR_IR_MFID")
    assert (cfg.num_blocks, cfg.mid_channels) == (30, 36)
    net = build_refvsr(cfg, device="cpu", seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ModulatedDCNPack):
                m.conv_offset.weight.copy_(torch.randn(
                    m.conv_offset.weight.shape, generator=g) * 0.02)
    t = cfg.frame_num
    lrs = torch.rand((1, t + 1, 32, 44, 3), generator=g)
    refs = torch.rand((1, t + 1, 32, 44, 3), generator=g)

    def stream(route):
        runner = StreamRunner(net, None, device=cuda_device,
                              keyframe_stride=cfg.keyframe_stride)
        outs, counts = [], []
        for wi in range(2):
            before = deform_conv.launches
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                outs.append(runner.process(lrs[:, wi:wi + t],
                                           refs[:, wi:wi + t], wi == 0)[0])
            spans = [e for e in prof.events()
                     if e.name in ("refvsr.dcn", "refvsr.k5")]
            assert all(e.cpu_parent.name == "refvsr.dcn" for e in spans
                       if e.name == "refvsr.k5")
            counts.append((sum(e.name == "refvsr.dcn" for e in spans),
                           sum(e.name == "refvsr.k5" for e in spans),
                           deform_conv.launches - before))
        return outs, counts

    got, counts = stream(True)
    assert counts == [(20, 20, 20)] * 2
    monkeypatch.setattr(edvr, "takes_k5", lambda *a: False)
    want, counts = stream(False)
    assert counts == [(20, 0, 0)] * 2
    for a, b in zip(got, want):
        assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,launches", [(0, (10, 1)), (2, (6, 1))])
def test_bench_stream_leg_on_the_card(cuda_device, lanes, launches):
    """The bench's stream leg (``bench/e2e.run_stream``: RefVSR_MFID_8K at
    full width, bf16, seeded) at a small size on the card: its record
    names the 8K-equivalent metric, counts K1 and K2 launches of a timed
    window (10 and 1) or pipelined dispatch (6 and 1), reports a peak and
    the card, and its numerics gate passes."""
    from refvsr_tpu_torch.bench import e2e
    res = e2e.run_stream(64, 128, lanes=lanes, device="cuda", warmup=1,
                         iters=2)
    rec = res.record
    assert rec["metric"] == "stream_fps_8k_equiv" and rec["unit"] == "fps"
    assert rec["out_shape"] == [1, 256, 512, 3] and rec["lanes"] == lanes
    assert (rec["k1_launches"], rec["k2_launches"]) == launches
    assert rec["value"] > 0 and rec["peak_bytes"] > 0
    assert rec["card"] and rec["card"] != "cpu"
    assert len(rec["window_ms"]) == 2 and res.out.is_cuda
    assert res.out.dtype == torch.bfloat16


def test_jpeg_and_inferno_round_trip():
    """No card needed: a JPEG's frame header reads back its size, the file
    is whole (SOI, JFIF, EOI), and the inferno table is 256 RGB entries in
    [0, 1] whose ends are matplotlib's, indexed by matplotlib's rule."""
    from refvsr_tpu_torch.data.jpeg import encode_jpeg, jpeg_info
    from refvsr_tpu_torch.utils.colormap import INFERNO, inferno
    img = np.full((36, 52, 3), (200, 120, 40), np.uint8)
    buf = encode_jpeg(img)
    assert jpeg_info(buf) == (36, 52, 3)
    assert buf.count(b"\xff\xd9") >= 1 and buf[:4] == b"\xff\xd8\xff\xe0"
    assert INFERNO.shape == (256, 3)
    assert INFERNO.min() >= 0 and INFERNO.max() <= 1
    np.testing.assert_allclose(INFERNO[0], [0.001462, 0.000466, 0.013866])
    np.testing.assert_allclose(INFERNO[-1], [0.988362, 0.998364, 0.644924])
    rgb = inferno(np.array([0.0, 0.5, 1.0, np.nan], np.float32))
    np.testing.assert_array_equal(rgb[[0, 2]], INFERNO[[0, 255]])
    np.testing.assert_array_equal(rgb[1], INFERNO[128])
    assert not rgb[3].any()


# ---------------------------------------------------------------------------
# multi-device: the banded K1 kernel and gloo collectives on one card
# ---------------------------------------------------------------------------

def _band_case(x, flow, world, rank, halo):
    """The banded warp's arguments for `rank`'s band of the whole x and
    flow (zeros past the image), as parallel/spatial.sharded_warp forms
    them."""
    from refvsr_tpu_torch.parallel.mesh import part
    n, h, w, c = x.shape
    ho = flow.shape[1]
    s, e = part(h, world, rank)
    a, b = s - halo, e + halo
    xe = x.new_zeros((n, b - a, w, c))
    lo_src, hi_src = max(a, 0), min(b, h)
    xe[:, lo_src - a:hi_src - a] = x[:, lo_src:hi_src]
    oy0, oy1 = part(ho, world, rank)
    return (xe, flow[:, oy0:oy1].contiguous(), h, ho, oy0, a,
            -1 if rank == 0 else 0, b - a - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["feat", "up"])
@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (4, 0), (4, 2),
                                        (4, 3)])
def test_banded_warp_kernel_matches_plain(cuda_device, dtype, shape, world,
                                          rank):
    """The 8K stream's bands (halo 32): the feature warp (C = 49, 1080
    rows onto 1080) and the UP warp (C = 48, 2160 rows onto 2160), on the
    first, an interior and the last band at N = 2 and 4, with a smooth
    flow of +-6 px, rows whose flow reaches past the halo (+-40 px, where
    the band border-extends), and dead points."""
    from refvsr_tpu_torch.ops.kernels.warp_sample import (
        warp_sample_banded, warp_sample_banded_plain)
    g = torch.Generator(device=cuda_device).manual_seed(7 + rank)
    h, w, c = (1080, 1920, 49) if shape == "feat" else (2160, 3840, 48)
    x = torch.randn((1, h, w, c), generator=g, device=cuda_device).to(dtype)
    flow = (torch.rand((1, h, w, 2), generator=g, device=cuda_device) * 12
            - 6)
    flow[:, ::97, :, 1] += 40.0
    flow[:, 5::89, :, 1] -= 40.0
    flow[:, :8, :16] += 1e4
    flow = flow.to(dtype)
    args = _band_case(x, flow, world, rank, 32)
    before = warp_sample_banded.launches
    got = warp_sample_banded(*args)
    assert warp_sample_banded.launches == before + 1
    want = warp_sample_banded_plain(*args)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert float((got.float() - want.float()).abs().max()) <= tol * float(
        x.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,up", [(49, False), (48, True), (5, False)])
def test_banded_warp_kernel_trivial_band_is_the_unbanded_kernel(
        gen, cuda_device, dtype, c, up):
    from refvsr_tpu_torch.ops.kernels.warp_sample import warp_sample_banded
    h, w = 61, 97
    ho, wo = (2 * h, 2 * w) if up else (h, w)
    x = torch.from_numpy(gen.standard_normal((2, h, w, c)).astype(
        np.float32)).to(cuda_device, dtype)
    flow = gen.uniform(-8, 8, (2, ho, wo, 2)).astype(np.float32)
    flow[:, :3, :5] += 5000.0
    flow[gen.random((2, ho, wo)) < 0.02, 1] = np.nan
    flow = torch.from_numpy(flow).to(cuda_device, dtype)
    got = warp_sample_banded(x, flow, h, ho, 0, 0, -1, h - 1)
    assert torch.equal(got, warp_sample(x, flow))


def _gloo_rank(out_dir):
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    from refvsr_tpu_torch.parallel import mesh, spatial
    backend = mesh.init_from_env("cuda")
    try:
        r, dev = mesh.rank(), mesh.device_for_rank("cuda")
        x = torch.arange(12, dtype=torch.float32, device=dev).reshape(
            1, 6, 2, 1) + 100 * r
        got = {"backend": backend, "device": str(dev)}
        got["gather"] = mesh.all_gather_rows(x, 1).cpu()
        got["mean"] = mesh.all_reduce_mean([x.clone()])[0].cpu()
        b = x.clone()
        mesh.broadcast_([b])
        got["broadcast"] = b.cpu()
        with spatial.spatial_sharding(2, [12]):
            got["halo"] = spatial.halo_exchange_rows(x, 2).cpu()
        torch.save(got, os.path.join(out_dir, f"gloo{r}.pt"))
    finally:
        mesh.destroy()


@pytest.mark.cuda
def test_gloo_collectives_on_cuda_tensors_of_one_card(cuda_device, tmp_path):
    """Two ranks on one card form a gloo group (each rank's device is
    cuda:0) and run every collective the port uses on CUDA tensors."""
    from refvsr_tpu_torch.parallel import mesh
    mesh.spawn(_gloo_rank, (str(tmp_path),), 2, 120)
    r0, r1 = (torch.load(str(tmp_path / f"gloo{r}.pt")) for r in (0, 1))
    x0 = torch.arange(12, dtype=torch.float32).reshape(1, 6, 2, 1)
    x1 = x0 + 100
    for r in (r0, r1):
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert torch.equal(r["gather"], torch.cat([x0, x1], 1))
        assert torch.equal(r["mean"], x0 + 50)
        assert torch.equal(r["broadcast"], x0)
    z = torch.zeros(1, 2, 2, 1)
    assert torch.equal(r0["halo"], torch.cat([z, x0, x1[:, :2]], 1))
    assert torch.equal(r1["halo"], torch.cat([x0[:, -2:], x1, z], 1))
