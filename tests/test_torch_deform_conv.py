"""K5, the modulated deformable convolution kernel, and its route from
``models/edvr.modulated_deform_conv``, on the CPU.

The kernel (``refvsr_tpu_torch/csrc/deform_conv.cu``) runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Held here:

- the route: ``edvr.takes_k5`` sends a call to K5 only for f32 inference
  on the card with operands K5 takes (``deform_conv.accepts``). A CPU
  tensor that reads as a CUDA one (``_OnCard``) stands in for the device
  check; K5's wrapper runs its plain version on it. The predicate against
  each one-off change of a call it takes; a routed call, its output and its
  ``refvsr.k5`` span inside ``refvsr.dcn``; the CPU's own calls unchanged
  (the row-gather path, bit for bit); every deformable convolution of a
  tiny IR window at EDVR's published widths (C 64, 8 groups) with operands
  K5 takes, the neighbour features' frame slices among them;
- the wrapper's refusals, one case for each check;
- the kernel's plan, emulated with the kernel's own index arithmetic:
  the weight staged from OIHW, each tap a swizzled (C outputs, C inputs)
  matrix; tiles of 8 x 8 pixels (ragged at the image's edges) whose
  offset and mask rows are staged (rows 148 and 76 floats apart); eight
  threads a pixel gathering every eighth 4-channel quad into the
  swizzled (64 pixels, C) column slice, one float4 store each; each of 16
  warps' mma.sync fragments (16 pixels x C / 4 outputs) read as its
  lanes' ldmatrix addresses them and multiplied in three TF32 products
  (the kernel's rounding of the split), the bias last. Every slot of the
  weight, the slice and the output written once, every float4 store's
  quarter-warp and every ldmatrix matrix on 32 banks, and the result
  within 1e-5 of
  the largest plain output (f32 sums of split products in another order)
  at ragged shapes with taps far outside, anchors on exactly -1 and
  S - 1, integer and NaN offsets; a pixel whose every tap is dead gives
  the bias exactly."""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from refvsr_tpu_torch.bench.dcn_cases import (dead_for_nan, dead_pixels,
                                              make_inputs)
from refvsr_tpu_torch.eval.stream import StreamRunner
from refvsr_tpu_torch.models import edvr
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.edvr import (ModulatedDCNPack, takes_k5,
                                          modulated_deform_conv,
                                          modulated_deform_conv_plain)
from refvsr_tpu_torch.models.refvsr_ir import RefVSRIRNet
from refvsr_tpu_torch.ops.kernels import deform_conv
from refvsr_tpu_torch.utils import trace

torch.set_num_threads(2)

TH, TW, THREADS, TAPS = 8, 8, 512, 9
TP = TH * TW
SO, SM = 18 * 8 + 4, 9 * 8 + 4


class _OnCard(torch.Tensor):
    """A CPU tensor whose ``is_cuda`` reads True."""

    @property
    def is_cuda(self):
        return True


def _inputs(n=2, h=7, w=9, c=64, dg=8, kind="fractional", seed=0):
    return make_inputs(n, h, w, c, dg, kind, seed)


# ------------------------------------------------------------- the route


@pytest.mark.parametrize("case", [
    "takes", "frame_slice", "cpu", "grad", "bf16", "noncontiguous", "c48",
    "dg16"])
def test_predicate(case):
    c = 48 if case == "c48" else 64
    dg = 16 if case == "dg16" else 8
    x, off, mask, wgt, bias = _inputs(c=c, dg=dg)
    if case == "frame_slice":       # (N, T, H, W, C)[:, i]: batch-strided
        x = torch.stack([x, x + 1, x - 1], 1)[:, 1]
        assert not x.is_contiguous()
    if case == "noncontiguous":     # a channel slice of a wider tensor
        x = torch.cat([x, x], -1)[..., :c]
    if case == "bf16":
        x, off, mask, wgt, bias = (t.to(torch.bfloat16)
                                   for t in (x, off, mask, wgt, bias))
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    with torch.set_grad_enabled(case == "grad"):
        got = takes_k5(x, off, mask, wgt, bias, dg)
    assert got == (case in ("takes", "frame_slice"))


def test_the_cpu_keeps_the_row_gather_path():
    """On the CPU the call returns what the row-gather path returns, bit
    for bit, within 1e-5 of the plain version, and opens no K5 span."""
    for dg in (8, 4):
        args = _inputs(dg=dg, kind="fractional", seed=dg)
        with torch.no_grad():
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                got = modulated_deform_conv(*args, dg)
            rows = edvr._deform_conv_rows(*args, dg)
            plain = modulated_deform_conv_plain(*args, dg)
        assert torch.equal(got, rows)
        lim = 1e-5 * float(plain.abs().max())
        assert float((got - plain).abs().max()) <= lim
        names = [e.name for e in prof.events()]
        assert names.count("refvsr.dcn") == 1
        assert "refvsr.k5" not in names


def test_a_routed_call_runs_k5_inside_the_dcn_span():
    x, off, mask, wgt, bias = _inputs()
    before = deform_conv.deform_conv.launches
    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = modulated_deform_conv(x.as_subclass(_OnCard), off, mask,
                                        wgt, bias, 8)
        want = modulated_deform_conv_plain(x, off, mask, wgt, bias, 8)
    # the wrapper ran its plain version: no launch
    assert deform_conv.deform_conv.launches == before
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    k5 = [e for e in prof.events() if e.name == "refvsr.k5"]
    assert len(k5) == 1 and k5[0].cpu_parent.name == "refvsr.dcn"


def test_k5_is_among_the_trace_names():
    assert "``refvsr.k5``" in trace.__doc__
    assert trace.span("refvsr.k5") is trace._OFF


def _tiny_ir_net():
    """A tiny RefVSR-IR (2 blocks, 8 channels) whose EDVR keeps its
    published widths (64 channels, 8 deform groups), offset convs redrawn
    so that the taps fall between pixels."""
    net = RefVSRIRNet(scale=4, num_blocks=2, mid_channels=8,
                      matching_ksize=2, keyframe_stride=2)
    gen = torch.Generator().manual_seed(3)
    init_weights(net, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ModulatedDCNPack):
                m.conv_offset.weight.copy_(torch.randn(
                    m.conv_offset.weight.shape, generator=gen) * 0.1)
    return net.eval()


def test_every_dcn_of_an_ir_window_has_operands_k5_takes(monkeypatch):
    calls = []
    orig = edvr.modulated_deform_conv

    def spy(*args):
        calls.append(args)
        return orig(*args)
    monkeypatch.setattr(edvr, "modulated_deform_conv", spy)
    t = 5
    runner = StreamRunner(_tiny_ir_net(), None, device="cpu",
                          keyframe_stride=2)
    g = torch.Generator().manual_seed(4)
    lrs = torch.rand((1, t, 16, 20, 3), generator=g)
    refs = torch.rand((1, t, 16, 20, 3), generator=g)
    runner.process(lrs, refs, True)
    assert len(calls) == 20
    assert all(deform_conv.accepts(*a) for a in calls)
    assert {a[0].shape[0] for a in calls} == {3}      # keyframes 0, 2, 4
    assert {a[0].shape[-1] for a in calls} == {64}
    # the three pyramid levels' neighbour features are frame slices
    assert sum(not a[0].is_contiguous() for a in calls) == 15
    with torch.inference_mode():
        assert all(takes_k5(a[0].as_subclass(_OnCard), *a[1:])
                   for a in calls)


# ------------------------------------------------------ the wrapper


@pytest.mark.parametrize("case", [
    "x3d", "c48", "groups", "nobias", "offset_shape", "mask_shape",
    "weight_o", "f64", "misaligned", "mask_strided", "x_strided_w"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    c = 48 if case == "c48" else 64
    dg = 5 if case == "groups" else 8
    x, off, mask, wgt, bias = _inputs(c=c, dg=dg if dg != 5 else 8)
    if case == "x3d":
        x = x[0]
    if case == "nobias":
        bias = None
    if case == "offset_shape":
        off = off[..., :-2]
    if case == "mask_shape":
        mask = mask[:, :, :-1]
    if case == "weight_o":
        wgt = wgt[:32]
    if case == "f64":
        mask = mask.double()
    if case == "misaligned":
        x = torch.empty(x.numel() + 1)[1:].view(x.shape).copy_(x)
    if case == "mask_strided":
        mask = torch.cat([mask, mask], -1)[..., :mask.shape[-1]]
    if case == "x_strided_w":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert not deform_conv.accepts(x, off, mask, wgt, bias, dg)
    with pytest.raises((ValueError, TypeError)):
        deform_conv.deform_conv(x, off, mask, wgt, bias, dg)


def test_wrapper_on_the_cpu_is_the_plain_version():
    args = _inputs(kind="integer")
    before = deform_conv.deform_conv.launches
    got = deform_conv.deform_conv(*args, 8)
    assert deform_conv.deform_conv.launches == before
    assert torch.equal(got, modulated_deform_conv_plain(*args, 8))


# ------------------------------------------------- the kernel's plan


def _swz(r, c, width):
    """Element (row r, column c) of a swizzled (rows, width) matrix: chunk
    c // 4 of row r at chunk (c // 4) ^ (r % 8) (in its block of 8)."""
    ch = c >> 2
    return r * width + (((ch ^ r) & 7) | (ch & ~7)) * 4 + (c & 3)


def _distinct_banks(addr):
    """Each row of `addr` (32 word addresses of one shared-memory
    wavefront) on 32 banks."""
    addr = addr.reshape(-1, 32)
    return all(len(set((a % 32).tolist())) == 32 for a in addr)


def _stage_weight(wgt, c):
    """The kernel's staging loop: float4 e of the OIHW weight holds output
    o = e // (9 C / 4), (i, k) = divmod(4 (e % (9 C / 4)) + u, 9); stored
    at tap k's swizzled (C outputs, C inputs) matrix."""
    flat = wgt.reshape(-1)
    ws = torch.full((9 * c * c,), float("nan"))
    writes = torch.zeros(9 * c * c, dtype=torch.long)
    e = torch.arange(9 * c * c // 4)
    o, r4 = e // (9 * c // 4), e % (9 * c // 4)
    for u in range(4):
        r = 4 * r4 + u
        i, k = r // 9, r % 9
        dst = k * c * c + _swz(o, i, c)
        ws[dst] = flat[4 * e + u]
        writes.index_add_(0, dst, torch.ones_like(dst))
    assert bool((writes == 1).all())
    return ws


def _tf32(v):
    """Round f32 to TF32 as the kernel does: add half the weight of the 13
    dropped mantissa bits to the bits, clear them."""
    b = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x1000) & 0xFFFFE000
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _ldmatrix(base, rows, cols, width):
    """ldmatrix (b16, 8 x 8 matrices) of f32 data: each matrix an 8 x 4
    block; lane l addresses row l % 8 of matrix l // 8 (rows[l], 16 bytes
    from column cols[l]); it gets row l // 4, column l % 4 of each. The
    rows of one matrix must cover the 32 banks. Returns (matrices, 32)
    word addresses."""
    addr = []
    for m in range(len(rows) // 8):
        row_addr = [base + _swz(rows[8 * m + i], cols[8 * m + i], width)
                    for i in range(8)]
        words = torch.tensor([a + w for a in row_addr for w in range(4)])
        assert len(set((words % 32).tolist())) == 32
        addr.append(torch.tensor([row_addr[l // 4] + l % 4
                                  for l in range(32)]))
    return torch.stack(addr)


def _contract(col, ws, k, c, acc):
    """The 16 warps' mma.sync fragments, ldmatrix'd from the slice and the
    weight as the kernel's lanes address them, then acc (64, C) += A B in
    three TF32 products; the fragments must hold the plain layout's
    values."""
    lane = torch.arange(32)
    g4, t4 = lane >> 2, lane & 3
    nt = c // 32
    for warp in range(16):
        m0, ob = 16 * (warp & 3), (c // 4) * (warp >> 2)
        ar = (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)).tolist()
        br = (ob + (lane & 7) + 8 * (lane >> 4)).tolist()
        a = torch.empty(16, c)
        b = torch.empty(c, 8 * nt)
        for c0 in range(0, c, 8):
            fa = col[_ldmatrix(0, ar, (c0 + 4 * (lane >> 4)).tolist(), c)]
            for i, (dm, dc) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
                a[g4 + dm, c0 + t4 + dc] = fa[i]
            n = 2 * nt
            fb = ws[_ldmatrix(k * c * c, br[:8 * n],
                              (c0 + 4 * ((lane >> 3) & 1)).tolist()[:8 * n],
                              c)]
            for j in range(nt):
                b[c0 + t4, 8 * j + g4] = fb[2 * j]
                b[c0 + t4 + 4, 8 * j + g4] = fb[2 * j + 1]
        ah, al = _split(a)
        bh, bl = _split(b)
        acc[m0:m0 + 16, ob:ob + 8 * nt] += al @ bh + ah @ bl + ah @ bh


def _emulate(x, off, mask, wgt, bias, dg):
    """K5's arithmetic step by step, vectorised over a block's threads."""
    n, h, w, c = x.shape
    cg, hw, pixels = c // dg, h * w, n * h * w
    ws = _stage_weight(wgt, c)
    xs = x.reshape(n, hw * c)
    offs, masks = off.reshape(pixels, -1), mask.reshape(pixels, -1)
    t = torch.arange(THREADS)
    px, sub = t >> 3, t & 7
    out = torch.full((pixels, c), float("nan"))
    written = torch.zeros((pixels, c), dtype=torch.long)
    zero = torch.zeros(())
    tiles_x, tiles_y = math.ceil(w / TW), math.ceil(h / TH)
    for tile in range(n * tiles_y * tiles_x):
        nn_, r = divmod(tile, tiles_y * tiles_x)
        y0, x0 = TH * (r // tiles_x), TW * (r % tiles_x)
        tpx = torch.arange(TP)
        ty, tx = y0 + tpx // TW, x0 + tpx % TW
        inside = (ty < h) & (tx < w)
        tp = ((nn_ * h + ty) * w + tx)[inside]        # the tile's pixels
        so = torch.full((TP, SO), float("nan"))      # the staged rows
        sm = torch.full((TP, SM), float("nan"))
        so[inside, :18 * dg] = offs[tp]
        sm[inside, :9 * dg] = masks[tp]
        acc = torch.zeros((TP, c))
        yy, xx = y0 + px // TW, x0 + px % TW
        live = (yy < h) & (xx < w)
        for k in range(TAPS):
            ky, kx = k // 3, k % 3
            col = torch.full((TP * c,), float("nan"))
            slots = torch.zeros(TP * c, dtype=torch.long)
            for j in range(c // 32):
                q = sub + 8 * j
                grp = (4 * q) // cg
                dy = torch.where(live, so[px, grp * 18 + 2 * k], zero)
                dx = torch.where(live, so[px, grp * 18 + 2 * k + 1], zero)
                m = torch.where(live, sm[px, grp * 9 + k], zero)
                sy = (yy + ky - 1).float() + dy
                sx = (xx + kx - 1).float() + dx
                fy, fx = torch.floor(sy), torch.floor(sx)
                ok = live & (fy >= -1) & (fy <= h - 1) & (fx >= -1) \
                    & (fx <= w - 1)
                y0 = torch.where(ok, fy, zero).long()
                x0 = torch.where(ok, fx, zero).long()
                ly = torch.where(ok, sy - fy, zero)
                lx = torch.where(ok, sx - fx, zero)
                hy = torch.where(ok, 1 - ly, zero)
                hx = torch.where(ok, 1 - lx, zero)
                r0, r1 = ok & (y0 >= 0), ok & (y0 + 1 < h)
                c0, c1 = x0 >= 0, x0 + 1 < w
                ya, yb = y0.clamp(min=0), (y0 + 1).clamp(max=h - 1)
                xa, xb = x0.clamp(min=0), (x0 + 1).clamp(max=w - 1)

                def corner(yc, xc, cond):
                    idx = ((yc * w + xc) * c + 4 * q)[:, None] \
                        + torch.arange(4)
                    v = xs[nn_, idx]
                    return torch.where(cond[:, None], v, zero)
                v = [corner(ya, xa, r0 & c0), corner(ya, xb, r0 & c1),
                     corner(yb, xa, r1 & c0), corner(yb, xb, r1 & c1)]
                wt = [torch.where(ok, hy * hx * m, zero),
                      torch.where(ok, hy * lx * m, zero),
                      torch.where(ok, ly * hx * m, zero),
                      torch.where(ok, ly * lx * m, zero)]
                s = v[0] * wt[0][:, None]
                for u in (1, 2, 3):
                    s = v[u] * wt[u][:, None] + s
                # one float4 a lane; a quarter-warp's on 32 banks
                addr = _swz(px, 4 * q, c)[:, None] + torch.arange(4)
                assert _distinct_banks(addr.reshape(-1, 8, 4))
                col[addr] = s
                slots.index_add_(0, addr.reshape(-1),
                                 torch.ones(addr.numel(), dtype=torch.long))
            assert bool((slots == 1).all())
            _contract(col, ws, k, c, acc)
        out[tp] = acc[inside] + bias
        written[tp] += 1
    assert bool((written == 1).all())
    return out.reshape(n, h, w, c)


@pytest.mark.parametrize("n,h,w,c,dg,kind", [
    (2, 7, 9, 64, 8, "edges"), (2, 7, 9, 64, 8, "integer"),
    (1, 13, 23, 32, 4, "edges"), (3, 5, 11, 32, 8, "fractional"),
    (2, 9, 10, 32, 8, "edges"), (1, 11, 12, 64, 4, "fractional")])
def test_kernel_plan_matches_plain(n, h, w, c, dg, kind):
    args = _inputs(n, h, w, c, dg, kind, seed=h * w)
    want = modulated_deform_conv_plain(*dead_for_nan(*args), dg)
    got = _emulate(*args, dg)
    assert torch.isfinite(want).all()
    lim = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= lim
    if kind == "edges":     # every tap NaN; every tap far outside
        for y, x in dead_pixels(h, w):
            assert torch.equal(got[0, y, x], args[4])
            assert torch.equal(want[0, y, x], args[4])
