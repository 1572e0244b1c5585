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
backward passes, f32: K1 dx and dflow within 1e-5 of the largest plain
value (f32 atomics sum in another order), exact zeros at dead points; K2
d_lr within 1e-6 and d_ref within 1e-5 of the largest (atomics), no
gradient for duplicated ref rows that never win.
K3 (bf16) within 2^-7 |plain| + 2^-8 max|plain| elementwise: two bf16
roundings of f32 sums taken in another order. K4 bitwise, out-of-range
indices clamped."""

import numpy as np
import pytest
import torch

from refvsr_tpu_torch.ops.kernels.argmax_matmul import (
    argmax_matmul, argmax_matmul_backward, argmax_matmul_backward_plain,
    argmax_matmul_plain)
from refvsr_tpu_torch.bench.microbench_conv import (envelope_ratio,
                                                    make_inputs)
from refvsr_tpu_torch.bench.ties import tied_rows
from refvsr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_bias,
                                                  conv3x3_bias_plain)
from refvsr_tpu_torch.ops.kernels.gather_rows import (gather_rows,
                                                      gather_rows_plain)
from refvsr_tpu_torch.ops.kernels.warp_sample import (
    warp_coords, warp_sample, warp_sample_backward,
    warp_sample_backward_plain, warp_sample_plain)


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
@pytest.mark.parametrize("h,w,c", [(37, 53, 16), (25, 131, 48), (4, 70, 80),
                                   (1, 1, 32)])
def test_conv3x3_kernel_matches_plain(cuda_device, h, w, c):
    x, wm, bias = make_inputs(h, w, c, cuda_device)
    before = conv3x3_bias.launches
    got = conv3x3_bias(x, wm, bias)
    assert conv3x3_bias.launches == before + 1
    want = conv3x3_bias_plain(x, wm, bias)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert envelope_ratio(got, want) <= 1.0


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
