"""The yardstick's arithmetic: each roofline's bytes and operations at the
cells' shapes, the declared peaks, and the FLOPs of a frame against what
the plain reference actually computes."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.generators import stream
from benchmark.reference import refvsr as R
from conftest import ROOT


def config(name, **kw):
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      f"{name}.json").read_text())
    cfg.update(kw)
    return cfg


def test_published_peaks():
    assert work.HBM_BYTES_PER_S == 3.35e12
    assert work.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 495e12}


@pytest.mark.parametrize("x, flow, dtype, flow_dtype, nbytes", [
    # the 8K stream's two warps of a step: bf16 features (+ conf) at LR,
    # bf16 UP features onto the 2x grid, each with its f32 flow; inputs
    # read once, outputs written once
    ((1, 1080, 1920, 49), (1, 1080, 1920, 2), "bfloat16", "float32",
     2 * 1080 * 1920 * 49 * 2 + 1080 * 1920 * 2 * 4),
    ((1, 1080, 1920, 48), (1, 2160, 3840, 2), "bfloat16", "float32",
     (1080 * 1920 * 48 + 2160 * 3840 * 48) * 2 + 2160 * 3840 * 2 * 4),
    ((1, 1080, 1920, 48), (1, 2160, 3840, 2), "bfloat16", "bfloat16",
     (1080 * 1920 * 48 + 2160 * 3840 * (2 + 48)) * 2),
    ((1, 270, 480, 49), (1, 270, 480, 2), "float32", "float32",
     (2 * 270 * 480 * 49 + 270 * 480 * 2) * 4),
])
def test_k1_bytes_at_the_cells_shapes(x, flow, dtype, flow_dtype, nbytes):
    b, ops = work.k1_work(x, flow, dtype, flow_dtype)
    assert b == nbytes
    if flow_dtype != dtype:
        # the f32 flow of a bf16 warp is counted at its own size
        assert b > work.k1_work(x, flow, dtype, dtype)[0]
    # bytes bind the warp at every shape of the path
    assert b / work.HBM_BYTES_PER_S > ops / work.PEAK_FLOPS[dtype]


@pytest.mark.parametrize("dtype, bound_ms", [("bfloat16", 1.2228),
                                             ("float32", 2.4431)])
def test_k2_operations_at_the_cells_shapes(dtype, bound_ms):
    # one frame's matching in both cells: 32,400 ref against 129,600 LR
    # patches of D = 144
    nbytes, ops = work.k2_work((1, 32400, 144), (1, 129600, 144), dtype)
    assert ops == 2 * 129600 * 32400 * 144
    isz = 2 if dtype == "bfloat16" else 4
    assert nbytes == (32400 + 129600) * 144 * isz + 129600 * 8
    assert work.bound_s(nbytes, ops, dtype) * 1e3 == pytest.approx(
        bound_ms, abs=1e-4)


@pytest.mark.parametrize("time_s", [1e-6, 1e-3, 1.0])
def test_a_share_passes_100_only_if_the_time_beats_the_peaks(time_s):
    nbytes, ops = work.k2_work((1, 32400, 144), (1, 129600, 144),
                               "bfloat16")
    bound = work.bound_s(nbytes, ops, "bfloat16")
    share = 100 * bound / time_s
    # above 100% exactly when the operations ran faster than the peak rate
    assert (share > 100) == (ops / time_s > work.PEAK_FLOPS["bfloat16"])


class Counting:
    """Counts what the reference computes: convolution FLOPs by torch's
    counter, and the matching product's by its torch.bmm calls."""

    def __init__(self, monkeypatch):
        self.bmm = 0.0
        real = torch.bmm

        def bmm(a, b):
            self.bmm += 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * \
                b.shape[2]
            return real(a, b)
        monkeypatch.setattr(torch, "bmm", bmm)

    def conv(self, fn):
        with FlopCounterMode(display=False) as fc:
            fn()
        return sum(v for k, v in fc.get_flop_counts()["Global"].items()
                   if "convolution" in str(k))


@pytest.mark.parametrize("name", ["RefVSR_MFID_8K", "RefVSR_MFID"])
def test_frame_flops_count_what_the_reference_computes(name, monkeypatch):
    cfg = config(name, num_blocks=2)
    hw = (32, 48)
    sd = stream.make_weights(cfg, 0, "cpu")
    s = R.Stream(R.Net(sd, cfg["num_blocks"], cfg["mid_channels"],
                       cfg["scale"], cfg["flag_HD_in"],
                       cfg["matching_ksize"]))
    g = torch.Generator().manual_seed(0)
    clip = torch.rand((1, 8, 3, *hw), generator=g)
    p = work.parts(cfg, hw, hw)
    count = Counting(monkeypatch)

    # a first window: the reference flows only the 7 pairs this frame reads
    # (the stream that follows reads the other 5), and aligns the centre
    # frame twice (once in each branch)
    conv = count.conv(lambda: s.window(clip[:, :7], clip[:, :7], True))
    need = work.frame_flops(cfg, hw, hw, "first")
    assert conv == (need - 7 * p["match_k2"] - 5 * p["spynet"]
                    + p["aligned"])
    assert count.bmm == 7 * p["match_k2"]

    # a streamed window: the reference recomputes the tail's flows,
    # matchings and alignments that a stream carries over
    count.bmm = 0.0
    conv = count.conv(lambda: s.window(clip[:, 1:], clip[:, 1:], False))
    need = work.frame_flops(cfg, hw, hw, "stream")
    assert conv == (need - p["match_k2"] + 2 * p["spynet"]
                    + 3 * p["match_conv"] + 4 * p["aligned"])
    assert count.bmm == 4 * p["match_k2"]


def test_frame_flops_at_the_cells_sizes():
    k8 = config("RefVSR_MFID_8K")
    f32 = config("RefVSR_MFID")
    hd, ld = (1080, 1920), (270, 480)
    assert work.frame_flops(k8, hd, hd, "stream") == pytest.approx(
        7.45e13, rel=1e-3)
    assert work.frame_flops(f32, ld, ld, "stream") == pytest.approx(
        5.81e12, rel=1e-3)
    assert work.frame_flops(f32, ld, ld, "first") == pytest.approx(
        1.71e13, rel=1e-2)
