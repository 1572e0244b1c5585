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
frame launches it once for each convolution ``takes_k3`` admits, each such
output within K3's tolerance of the library convolution on the same
input, and the SR frames and carried state within the 8K configuration's
``sr_rmse`` and ``state_rel`` limits of the library-only run. K4 bitwise,
out-of-range indices clamped.

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
table (no card needed)."""

import os

import numpy as np
import pytest
import torch

from refvsr_tpu_torch.ops.kernels.argmax_matmul import (
    argmax_matmul, argmax_matmul_backward, argmax_matmul_backward_plain,
    argmax_matmul_plain)
from refvsr_tpu_torch.bench.microbench_conv import (envelope_ratio,
                                                    make_inputs)
from refvsr_tpu_torch.bench.ties import tied_rows
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.data.png import (decode_png, encode_png, read_image,
                                       write_image)
from refvsr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_bias,
                                                  conv3x3_bias_plain)
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
    launches once for each ``Conv2d`` call that ``takes_k3`` admits, and
    each such call's output lies within K3's tolerance of the library
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
        if blocks.takes_k3(m, x):
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


@pytest.mark.cuda
@pytest.mark.parametrize("rows,lanes,points,dtype", [
    (64, 128, 256, torch.float32), (1000, 72, 4099, torch.bfloat16),
    (3, 4, 1, torch.float32)])
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
