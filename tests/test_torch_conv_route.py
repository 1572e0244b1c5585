"""The route of ``models/blocks.Conv2d.forward`` to K3, on the CPU.

``takes_k3`` sends a call to K3 (``ops/kernels/conv3x3.py``) only for bf16
inference on the card: no gradient asked for, no spatial context, a 3x3
stride-1 kernel with bias, C in == C out in 16..80 by 16, one image,
contiguous and 16-byte aligned. The CPU has no card, so a CPU tensor that
reads as a CUDA one (``_OnCard``) stands in for the device check; K3's
wrapper runs its plain version on it. Held here: the predicate against each
one-off change of a call it takes; the packed weights (wm, the HWIO kernel
flattened tap-major, and the bias as (1, 1, C)) through the plain version
against the library convolution of the same module, within K3's tolerance
(``bench/microbench_conv.envelope_ratio``: 2^-7 |want| + 2^-8 max|want|);
the pack kept while the parameters are, made again after ``load_state_dict``
and in-place updates; the state dict's keys unchanged; and a routed call,
its output and its ``refvsr.k3`` span inside ``refvsr.conv``. The card
test of the route in the 8K stream is in ``tests/test_torch_cuda.py``."""

import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from refvsr_tpu_torch.bench.microbench_conv import envelope_ratio
from refvsr_tpu_torch.models.blocks import Conv2d, init_weights, takes_k3
from refvsr_tpu_torch.models.refvsr import RefVSRNet
from refvsr_tpu_torch.ops.kernels import conv3x3
from refvsr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_bias,
                                                  conv3x3_bias_plain)
from refvsr_tpu_torch.parallel import mesh, spatial


class _OnCard(torch.Tensor):
    """A CPU tensor whose ``is_cuda`` reads True."""

    @property
    def is_cuda(self):
        return True


def _conv(cin=48, cout=48, k=3, stride=1, seed=0):
    conv = Conv2d(cin, cout, k, stride)
    init_weights(conv, torch.Generator().manual_seed(seed))
    return conv.to(torch.bfloat16)


def _x(n=1, h=9, w=13, c=48, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, h, w, c), generator=g).to(torch.bfloat16)


def _library(conv, x):
    """The library convolution of the same module on the NHWC x."""
    return nn.Conv2d.forward(conv, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("case", [
    "takes", "f32", "grad", "n2", "96to48", "7x7", "stride2", "c40",
    "channel_slice", "spatial", "cpu"])
def test_predicate(monkeypatch, case):
    conv = {"96to48": lambda: _conv(96, 48), "7x7": lambda: _conv(k=7),
            "stride2": lambda: _conv(stride=2),
            "c40": lambda: _conv(40, 40)}.get(case, _conv)()
    x = _x(n=2 if case == "n2" else 1,
           c=96 if case in ("96to48", "channel_slice") else
           40 if case == "c40" else 48)
    if case == "channel_slice":
        x = x[..., :48]
    if case == "f32":
        x, conv = x.float(), conv.float()
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    with torch.set_grad_enabled(case == "grad"):
        if case != "spatial":
            got = takes_k3(conv, x)
        else:
            monkeypatch.setattr(mesh, "world_size", lambda: 2)
            monkeypatch.setattr(mesh, "rank", lambda: 0)
            with spatial.spatial_sharding(2, [18]):
                assert spatial.active() is not None
                got = takes_k3(conv, x)
    assert got == (case == "takes")


@pytest.mark.parametrize("c", [16, 48, 80])
def test_packed_weights_through_the_plain_version(c):
    conv, x = _conv(c, c, seed=c), _x(h=11, w=17, c=c, seed=c + 1)
    wm, b = conv.k3_weights()
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
    first = conv.k3_weights()
    again = conv.k3_weights()
    assert again[0] is first[0] and again[1] is first[1]
    # load_state_dict copies in place: the pack follows the new weights
    other = _conv(seed=5)
    conv.load_state_dict(other.state_dict())
    loaded = conv.k3_weights()
    assert loaded[0] is not first[0] and loaded[1] is not first[1]
    assert torch.equal(loaded[0], other.k3_weights()[0])
    assert torch.equal(loaded[1], other.k3_weights()[1])
    assert conv.k3_weights()[0] is loaded[0]
    # an in-place update of either parameter (an optimizer step)
    with torch.no_grad():
        conv.weight.mul_(2)
    scaled = conv.k3_weights()
    assert scaled[0] is not loaded[0]
    assert torch.equal(scaled[0], 2 * loaded[0])
    with torch.no_grad():
        conv.bias.add_(1)
    shifted = conv.k3_weights()
    assert shifted[1] is not scaled[1]
    assert torch.equal(shifted[1], scaled[1] + 1)
    assert torch.equal(shifted[0], scaled[0])
    # parameters made under inference mode keep no version counter
    with torch.inference_mode():
        made = _conv()
    assert made.k3_weights()[0] is made.k3_weights()[0]


def test_state_dict_keys_unchanged():
    net = RefVSRNet(scale=4, num_blocks=2, mid_channels=16,
                    matching_ksize=2)
    keys = list(net.state_dict())
    convs = [m for m in net.modules() if isinstance(m, Conv2d)
             and m.kernel_size == (3, 3) and m.in_channels == m.out_channels]
    assert len(convs) > 20
    for m in convs:
        m.k3_weights()
    assert list(net.state_dict()) == keys
    assert all(list(m.state_dict()) == ["weight", "bias"] for m in convs)
    assert not any(True for _ in net.buffers())


def test_routed_call_and_its_span():
    conv, x = _conv(seed=3), _x(seed=4).as_subclass(_OnCard)
    before = conv3x3_bias.launches
    with torch.inference_mode():
        assert takes_k3(conv, x)
        want = _library(conv, x)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = conv(x)
    # the CPU runs the plain version: no launch
    assert conv3x3_bias.launches == before
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert envelope_ratio(got[0], want[0]) <= 1.0
    assert conv._k3_key is not None
    k3 = [e for e in prof.events() if e.name == "refvsr.k3"]
    assert len(k3) == 1 and k3[0].cpu_parent.name == "refvsr.conv"


def test_cpu_and_f32_calls_keep_the_library_path():
    conv, x = _conv(), _x()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        got = conv(x)
        conv.float()(x.float())
    assert conv._k3_key is None
    assert not any(e.name == "refvsr.k3" for e in prof.events())
    assert torch.equal(got, _library(conv.to(torch.bfloat16), x))


@pytest.mark.parametrize("c", [8, 16, 24, 32, 40, 48, 64, 80, 96])
def test_channel_counts_are_the_kernels(c):
    # one owner of what K3 takes: the predicate asks the kernel's module
    x = _x(c=c).as_subclass(_OnCard)
    conv = _conv(c, c)
    takes = c in (16, 32, 48, 64, 80)
    assert conv3x3.accepts(x[0]) == takes
    with torch.inference_mode():
        assert takes_k3(conv, x) == takes
