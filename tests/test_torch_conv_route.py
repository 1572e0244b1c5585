"""The route of ``models/blocks.Conv2d.forward`` to K3 and K6, on the CPU.

``routed_kernel`` sends a call to a hand-written kernel only for inference
on the card: no gradient asked for, a 3x3 stride-1 kernel with bias, C in
== C out, one image, contiguous and 16-byte aligned; then by the image's
dtype and C, to K3 (``ops/kernels/conv3x3.py``: bf16, C in 16..80 by 16)
or K6 (``ops/kernels/conv3x3_f32.py``: f32, C 32, 36 or 48). Under a
spatial context it asks the same of the rows a band's convolution reads.
The CPU has no card, so a CPU tensor that reads as a CUDA one
(``_OnCard``) stands in for the device check; the kernels' wrappers run
their plain versions on it. Held here: the predicate against each one-off
change of a call it takes; K3's packed weights (wm, the HWIO kernel
flattened tap-major, and the bias as (1, 1, C)) through the plain version
against the library convolution of the same module, within K3's tolerance
(``bench/microbench_conv.envelope_ratio``: 2^-7 |want| + 2^-8 max|want|);
K6's packed weights (both TF32 parts, zero-padded to N channels at C = 36)
through its plain version against ``F.conv2d`` within 1e-6 of the largest
output (the parts' sum holds each weight to about 2^-22), and through an
emulation of the kernel's own plan (its loads of x, the channel order of
its k-steps, the descriptor layout of B) within 1e-5; the pack kept while
the kernel and the parameters are, made again after ``load_state_dict``,
in-place updates and a change of kernel; the state dict's keys unchanged;
routed calls, their outputs and their ``refvsr.k3`` or ``refvsr.k6`` span
inside ``refvsr.conv``; two spatial ranks' bands on the kernels' route,
cropped, against the whole image's; and what K6's wrapper refuses. The
card tests of the routes in the streams are in
``tests/test_torch_cuda.py``."""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from refvsr_tpu_torch.bench.microbench_conv import envelope_ratio
from refvsr_tpu_torch.models.blocks import (Conv2d, init_weights,
                                            routed_kernel)
from refvsr_tpu_torch.models.refvsr import RefVSRNet
from refvsr_tpu_torch.ops.kernels import conv3x3, conv3x3_f32
from refvsr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_bias,
                                                  conv3x3_bias_plain)
from refvsr_tpu_torch.ops.kernels.conv3x3_f32 import conv3x3_f32_plain
from refvsr_tpu_torch.parallel import mesh, spatial


class _OnCard(torch.Tensor):
    """A CPU tensor whose ``is_cuda`` reads True."""

    @property
    def is_cuda(self):
        return True


def _conv(cin=48, cout=48, k=3, stride=1, seed=0, dtype=torch.bfloat16):
    conv = Conv2d(cin, cout, k, stride)
    init_weights(conv, torch.Generator().manual_seed(seed))
    return conv.to(dtype)


def _x(n=1, h=9, w=13, c=48, seed=1, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, h, w, c), generator=g).to(dtype)


def _rel(got, want):
    """max |got - want| over max |want|."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


def _library(conv, x):
    """The library convolution of the same module on the NHWC x."""
    return nn.Conv2d.forward(conv, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("case", [
    "takes", "f32", "f32_c64", "f32_weights_bf16", "grad", "n2", "96to48",
    "7x7", "stride2", "c40", "channel_slice", "spatial", "cpu"])
def test_predicate(monkeypatch, case):
    conv = {"96to48": lambda: _conv(96, 48), "7x7": lambda: _conv(k=7),
            "stride2": lambda: _conv(stride=2),
            "c40": lambda: _conv(40, 40),
            "f32_c64": lambda: _conv(64, 64)}.get(case, _conv)()
    x = _x(n=2 if case == "n2" else 1,
           c=96 if case in ("96to48", "channel_slice") else
           40 if case == "c40" else 64 if case == "f32_c64" else 48)
    if case == "channel_slice":
        x = x[..., :48]
    if case in ("f32", "f32_c64"):
        x, conv = x.float(), conv.float()
    if case == "f32_weights_bf16":
        x = x.float()
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    with torch.set_grad_enabled(case == "grad"):
        if case != "spatial":
            got = routed_kernel(conv, x)
        else:
            monkeypatch.setattr(mesh, "world_size", lambda: 2)
            monkeypatch.setattr(mesh, "rank", lambda: 0)
            with spatial.spatial_sharding(2, [18]):
                assert spatial.active() is not None
                got = routed_kernel(conv, x)
    # a spatial context leaves the route to the rows a band's convolution
    # reads (``parallel/spatial.conv2d``), as to a whole image
    assert got == {"takes": "k3", "f32": "k6", "spatial": "k3"}.get(case)


@pytest.mark.parametrize("c", [16, 48, 80])
def test_packed_weights_through_the_plain_version(c):
    conv, x = _conv(c, c, seed=c), _x(h=11, w=17, c=c, seed=c + 1)
    wm, b = conv.packed("k3")
    assert tuple(wm.shape) == (9 * c, c) and tuple(b.shape) == (1, 1, c)
    assert wm.dtype == b.dtype == torch.bfloat16
    assert wm.is_contiguous() and b.is_contiguous()
    assert not wm.requires_grad and not b.requires_grad
    with torch.no_grad():
        got = conv3x3_bias_plain(x[0], wm, b)
        want = _library(conv, x)[0]
    assert envelope_ratio(got, want) <= 1.0


def test_pack_kept_until_the_parameters_change():
    conv = _conv()
    first = conv.packed("k3")
    again = conv.packed("k3")
    assert again[0] is first[0] and again[1] is first[1]
    # load_state_dict copies in place: the pack follows the new weights
    other = _conv(seed=5)
    conv.load_state_dict(other.state_dict())
    loaded = conv.packed("k3")
    assert loaded[0] is not first[0] and loaded[1] is not first[1]
    assert torch.equal(loaded[0], other.packed("k3")[0])
    assert torch.equal(loaded[1], other.packed("k3")[1])
    assert conv.packed("k3")[0] is loaded[0]
    # an in-place update of either parameter (an optimizer step)
    with torch.no_grad():
        conv.weight.mul_(2)
    scaled = conv.packed("k3")
    assert scaled[0] is not loaded[0]
    assert torch.equal(scaled[0], 2 * loaded[0])
    with torch.no_grad():
        conv.bias.add_(1)
    shifted = conv.packed("k3")
    assert shifted[1] is not scaled[1]
    assert torch.equal(shifted[1], scaled[1] + 1)
    assert torch.equal(shifted[0], scaled[0])
    # parameters made under inference mode keep no version counter
    with torch.inference_mode():
        made = _conv()
    assert made.packed("k3")[0] is made.packed("k3")[0]


def test_state_dict_keys_unchanged():
    net = RefVSRNet(scale=4, num_blocks=2, mid_channels=16,
                    matching_ksize=2)
    keys = list(net.state_dict())
    convs = [m for m in net.modules() if isinstance(m, Conv2d)
             and m.kernel_size == (3, 3) and m.in_channels == m.out_channels]
    assert len(convs) > 20
    for m in convs:
        m.packed("k3")
    assert list(net.state_dict()) == keys
    assert all(list(m.state_dict()) == ["weight", "bias"] for m in convs)
    assert not any(True for _ in net.buffers())


def test_routed_call_and_its_span():
    conv, x = _conv(seed=3), _x(seed=4).as_subclass(_OnCard)
    before = conv3x3_bias.launches
    with torch.inference_mode():
        assert routed_kernel(conv, x) == "k3"
        want = _library(conv, x)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = conv(x)
    # the CPU runs the plain version: no launch
    assert conv3x3_bias.launches == before
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert envelope_ratio(got[0], want[0]) <= 1.0
    assert conv._packed[0][0] == "k3"
    k3 = [e for e in prof.events() if e.name == "refvsr.k3"]
    assert len(k3) == 1 and k3[0].cpu_parent.name == "refvsr.conv"


def test_cpu_and_f32_calls_keep_the_library_path():
    # on the CPU both dtypes keep the library convolution
    conv, x = _conv(), _x()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        got = conv(x)
        conv.float()(x.float())
    assert conv._packed is None
    assert not any(e.name in ("refvsr.k3", "refvsr.k6")
                   for e in prof.events())
    assert torch.equal(got, _library(conv.to(torch.bfloat16), x))
    # on the card an f32 call routes to K6 (its wrapper runs the plain
    # version here), with its span inside the convolution's
    conv, x = _conv(seed=6, dtype=torch.float32), _x(seed=7,
                                                     dtype=torch.float32)
    before = conv3x3_f32.conv3x3_f32.launches
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        got = conv(x.as_subclass(_OnCard))
    assert conv3x3_f32.conv3x3_f32.launches == before
    assert conv._packed[0][0] == "k6"
    k6 = [e for e in prof.events() if e.name == "refvsr.k6"]
    assert len(k6) == 1 and k6[0].cpu_parent.name == "refvsr.conv"
    assert not any(e.name == "refvsr.k3" for e in prof.events())
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, _library(conv, x)) <= 1e-6


@pytest.mark.parametrize("dtype,kernel,c", [
    (torch.bfloat16, "k3", 48), (torch.float32, "k6", 36)])
def test_spatial_bands_take_the_kernel_route(monkeypatch, dtype, kernel, c):
    # two ranks' bands of a 16-row image, each rank's row exchange served
    # from the whole image: each band's convolution runs the kernel the
    # whole image's runs, on the band and its neighbours' rows, and the
    # cropped bands make up the whole image's output
    conv = _conv(c, c, seed=9, dtype=dtype)
    x = _x(h=16, w=13, c=c, seed=10, dtype=dtype)
    bands = [x[:, :8], x[:, 8:]]

    def all_gather_rows(edge, dim, sizes=None):
        e = edge.shape[1] // 2
        return torch.cat([torch.cat([b[:, :e], b[:, -e:]], 1)
                          for b in bands], 1)
    monkeypatch.setattr(mesh, "all_gather_rows", all_gather_rows)
    with torch.inference_mode():
        want = conv(x.as_subclass(_OnCard))
        library = _library(conv, x)
        got = []
        for rank in range(2):
            monkeypatch.setattr(spatial, "_CTX",
                                spatial.SpatialCtx(2, rank, 4, {8: 16}))
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                got.append(conv(bands[rank].as_subclass(_OnCard)))
            assert spatial._CTX.exchanges == 1
            spans = [e for e in prof.events()
                     if e.name in ("refvsr.k3", "refvsr.k6")]
            assert [e.name for e in spans] == [f"refvsr.{kernel}"]
            assert spans[0].cpu_parent.name == "refvsr.conv"
    got = torch.cat(got, 1)
    assert got.shape == x.shape and got.dtype == dtype
    for ref in (want, library):
        if kernel == "k3":
            assert envelope_ratio(got[0], ref[0]) <= 1.0
        else:
            assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("dtype,kernel,routed", [
    (torch.bfloat16, "k3", (16, 32, 48, 64, 80)),
    (torch.float32, "k6", (32, 36, 48))])
@pytest.mark.parametrize("c", [8, 16, 24, 32, 36, 40, 48, 64, 80, 96])
def test_channel_counts_are_the_kernels(c, dtype, kernel, routed):
    # one owner of what each kernel takes: the predicate asks the kernel's
    # module
    x = _x(c=c, dtype=dtype).as_subclass(_OnCard)
    conv = _conv(c, c, dtype=dtype)
    takes = c in routed
    module = conv3x3 if kernel == "k3" else conv3x3_f32
    assert module.accepts(x[0]) == takes
    with torch.inference_mode():
        assert routed_kernel(conv, x) == (kernel if takes else None)


@pytest.mark.parametrize("c", [32, 36, 48])
def test_k6_packed_weights_through_the_plain_version(c):
    conv = _conv(c, c, seed=c, dtype=torch.float32)
    x = _x(h=11, w=17, c=c, seed=c + 1, dtype=torch.float32)
    wp, b = conv.packed("k6")
    n = -(-c // 8) * 8
    assert conv3x3_f32.PLANS[c][0] == n
    assert tuple(wp.shape) == (2, 9 * n * n) and tuple(b.shape) == (1, 1, c)
    assert wp.dtype == b.dtype == torch.float32
    assert wp.is_contiguous() and b.is_contiguous()
    assert not wp.requires_grad and not b.requires_grad
    # both parts are TF32 values, the low part far below the high one
    bits = wp.view(torch.int32) & 0x1FFF
    assert not bool(bits.any())
    assert float(wp[1].abs().max()) <= 2.0 ** -11 * float(wp[0].abs().max())
    # the padding (C = 36: 4 zero input and output channels) holds zeros
    assert int((wp[0] != 0).sum()) == 9 * c * c
    w = conv3x3_f32.unpack(wp, c)
    assert _rel(w, conv.weight) <= 2.0 ** -21
    with torch.no_grad():
        got = conv3x3_f32_plain(x[0], wp, b)
        want = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                        padding=1)[0].permute(1, 2, 0)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6


def _k6_emulated(x, wp, bias):
    """K6's plan on one image, in f64: for each 64-pixel strip and output
    row, the three input rows as the ring holds them (66 pixels, CP
    channels, zeros outside the image and past C), each k-step's A read as
    the kernel's threads read it (``load_a``/``split_a``: thread t % 4's
    VEC channels from 4 VEC q + VEC (t % 4), logical columns t % 4 and
    t % 4 + 4) and its B read from the packed weights as the descriptor
    lays them out (chunk 2 s + k // 4, column n, element k % 4), the large
    and small parts summed."""
    h, w, c = x.shape
    n, vec = conv3x3_f32.PLANS[c]
    cp = {32: 40, 36: 40, 48: 48}[c]
    ks, ls = n // 8, vec // 2
    strips = -(-w // 64)
    xp = torch.zeros((h + 2, strips * 64 + 2, cp), dtype=torch.float64)
    xp[1:h + 1, 1:w + 1, :c] = x.double()
    parts = wp.double().reshape(2, 9 * ks * 2, n, 4)
    y = torch.zeros((h, strips * 64, n), dtype=torch.float64)
    for s in range(9 * ks):
        tap, u = s // ks, s // ls
        dy, dx = divmod(tap, 3)
        q, hs = u % (ks // ls), s % ls
        t4 = torch.arange(4)
        chan = 4 * vec * q + vec * t4 + 2 * hs       # logical column t4
        cols = torch.cat([chan, chan + 1])             # columns 0..7
        a = xp[dy:dy + h, dx:dx + strips * 64][..., cols]   # (h, px, 8)
        b = torch.cat([parts[:, 2 * s], parts[:, 2 * s + 1]], -1)  # (2, n, 8)
        y += a @ (b[0] + b[1]).T
    return (y[:, :w, :c] + bias.double().reshape(c)).float()


@pytest.mark.parametrize("c,h,w", [(32, 7, 70), (36, 9, 13), (48, 5, 131)])
def test_k6_plan_emulated(c, h, w):
    conv = _conv(c, c, seed=2 * c, dtype=torch.float32)
    x = _x(h=h, w=w, c=c, seed=3 * c, dtype=torch.float32)[0]
    wp, b = conv.packed("k6")
    with torch.no_grad():
        want = conv3x3_f32_plain(x, wp, b)
    assert _rel(_k6_emulated(x, wp, b), want) <= 1e-5


def test_k6_pack_kept_until_the_parameters_change():
    conv = _conv(36, 36, dtype=torch.float32)
    first = conv.packed("k6")
    again = conv.packed("k6")
    assert again[0] is first[0] and again[1] is first[1]
    other = _conv(36, 36, seed=5, dtype=torch.float32)
    conv.load_state_dict(other.state_dict())
    loaded = conv.packed("k6")
    assert loaded[0] is not first[0] and loaded[1] is not first[1]
    assert torch.equal(loaded[0], other.packed("k6")[0])
    assert torch.equal(loaded[1], other.packed("k6")[1])
    assert conv.packed("k6")[0] is loaded[0]
    with torch.no_grad():
        conv.weight.mul_(2)
    scaled = conv.packed("k6")
    assert scaled[0] is not loaded[0]
    assert torch.equal(scaled[0], 2 * loaded[0])
    with torch.no_grad():
        conv.bias.add_(1)
    shifted = conv.packed("k6")
    assert shifted[1] is not scaled[1]
    assert torch.equal(shifted[1], scaled[1] + 1)
    assert torch.equal(shifted[0], scaled[0])
    # one slot: a call to the other kernel packs for it, and a call back
    # packs again
    k3 = conv.packed("k3")
    assert conv._packed[0][0] == "k3" and tuple(k3[0].shape) == (9 * 36, 36)
    back = conv.packed("k6")
    assert back[0] is not shifted[0] and torch.equal(back[0], shifted[0])
    with torch.inference_mode():
        made = _conv(48, 48, dtype=torch.float32)
    assert made.packed("k6")[0] is made.packed("k6")[0]


@pytest.mark.parametrize("case", [
    "bf16", "c40", "c64", "2d", "strided", "unaligned", "wp_shape",
    "wp_bf16", "bias_size", "devices"])
def test_k6_refusals(case):
    c = 64 if case == "c64" else 40 if case == "c40" else 36
    conv = _conv(36, 36, dtype=torch.float32)
    wp, b = conv.packed("k6")
    x = _x(c=c, dtype=torch.float32)[0]
    if case == "bf16":
        x = x.to(torch.bfloat16)
    elif case == "2d":
        x = x[0]
    elif case == "strided":
        x = x.transpose(0, 1)
    elif case == "unaligned":
        x = torch.empty(x.numel() + 1)[1:].view(x.shape).copy_(x)
    elif case == "wp_shape":
        wp = wp[:, :-8].contiguous()
    elif case == "wp_bf16":
        wp = wp.to(torch.bfloat16)
    elif case == "bias_size":
        b = b[..., :35].contiguous()
    elif case == "devices":
        x = torch.empty(x.shape, device="meta")
    if case in ("bf16", "c40", "c64", "2d", "strided", "unaligned"):
        assert not conv3x3_f32.accepts(x)
    before = conv3x3_f32.conv3x3_f32.launches
    with pytest.raises((TypeError, ValueError)):
        conv3x3_f32.conv3x3_f32(x, wp, b)
    assert conv3x3_f32.conv3x3_f32.launches == before
    with pytest.raises((TypeError, ValueError)):
        conv3x3_f32.pack(torch.zeros((c, c, 3, 3)) if case in ("c40", "c64")
                         else torch.zeros((36, 36, 3, 3), dtype=torch.bfloat16)
                         if case == "bf16" else torch.zeros((36, 36, 5, 5)))
