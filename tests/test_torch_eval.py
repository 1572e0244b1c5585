"""The port's evaluation pieces on the CPU: the metrics against
``refvsr_tpu/eval/metrics.py``, the inferno table against matplotlib's, the
JPEG encoder against PIL, the image writer, and the on-device downscale of
the HD-in protocol against the host resize.

Tolerances:
- metrics 1e-9: the same float64 arithmetic;
- inferno: equal;
- JPEG: PIL decodes the port's file; against PIL's own quality-75 JPEG of
  the same frame, both decoded by PIL, the mean absolute difference is
  under 1 level of 255 and the PSNR against the original no more than
  0.1 dB below PIL's:
  the headers and tables are PIL's byte for byte, but the port's DCT is
  float64 where libjpeg's default is its integer transform, so a
  coefficient can round one quantisation step away;
- the downscale 1e-5: f32 bicubic against float64, both clipped."""

import io
import os

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from refvsr_tpu.eval import metrics as jmetrics
from refvsr_tpu_torch.data.jpeg import encode_jpeg, jpeg_info, write_jpeg
from refvsr_tpu_torch.data.np_ops import np_resize
from refvsr_tpu_torch.data.png import read_image
from refvsr_tpu_torch.eval import metrics
from refvsr_tpu_torch.eval.runner import ImageWriter, device_downscale
from refvsr_tpu_torch.utils.colormap import INFERNO, inferno


@pytest.mark.parametrize("shape", [(31, 45, 3), (6, 9, 3), (64, 40, 3)])
def test_metrics_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    h, w = shape[:2]
    mask = np.zeros((h, w, 3))
    mask[h // 5:h - h // 5, w // 4:w - w // 4] = 1.0
    for name, args in (("psnr", (a, b)), ("ssim", (a, b)),
                       ("psnr_masked", (a, b, mask)),
                       ("ssim_masked", (a, b, mask)),
                       ("ssim_masked", (a, b, mask[..., 0]))):
        got = getattr(metrics, name)(*args)
        want = getattr(jmetrics, name)(*args)
        assert abs(got - want) <= 1e-9, (name, got, want)


def test_inferno_matches_matplotlib():
    cm = matplotlib.colormaps["inferno"]
    np.testing.assert_array_equal(INFERNO, np.asarray(cm.colors))
    rng = np.random.default_rng(0)
    x = rng.random((37, 53)).astype(np.float32)
    x[0, :8] = [0.0, 1.0, 0.5, 255 / 256, 1 / 256, -0.3, 1.7, np.nan]
    for arr in (x, x.astype(np.float64), np.clip(x, 0, 1)):
        np.testing.assert_array_equal(inferno(arr), cm(arr)[..., :3])


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 13.0),
                    128 + 90 * np.cos(yy / 9.0 + xx / 31.0),
                    (xx * yy) % 256], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(
        np.uint8)


def _segments(buf):
    """{marker: [payload, ...]} of a JPEG's header segments."""
    out, i = {}, 2
    while buf[i + 1] != 0xDA:
        n = int.from_bytes(buf[i + 2:i + 4], "big")
        out.setdefault(buf[i + 1], []).append(buf[i + 4:i + 2 + n])
        i += 2 + n
    return out


@pytest.mark.parametrize("hw", [(123, 217), (16, 16), (1, 1), (40, 9)])
def test_jpeg_decodes_close_to_pils(hw):
    img = _scene(*hw, seed=hw[0])
    ours = encode_jpeg(img)
    assert jpeg_info(ours) == (*hw, 3)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    pil = buf.getvalue()
    # the same JFIF header, tables and frame header as PIL's defaults
    seg_o, seg_p = _segments(ours), _segments(pil)
    for marker in (0xE0, 0xDB, 0xC0, 0xC4):
        assert seg_o[marker] == seg_p[marker], hex(marker)
    dec_o = np.asarray(Image.open(io.BytesIO(ours)).convert("RGB"), float)
    dec_p = np.asarray(Image.open(io.BytesIO(pil)).convert("RGB"), float)
    assert dec_o.shape == dec_p.shape == (*hw, 3)
    assert np.abs(dec_o - dec_p).mean() < 1.0

    def db(a):
        return 10 * np.log10(255.0 ** 2 / max(np.mean((a - img) ** 2),
                                               1e-12))
    assert db(dec_o) > db(dec_p) - 0.1


def test_jpeg_long_zero_runs_and_extremes():
    """Flat blocks (all-zero AC, EOB only), runs past 16 zeros (ZRL), and
    large DC steps between blocks."""
    img = np.zeros((48, 64, 3), np.uint8)
    img[:, 32:] = 255
    img[8:16, 8:16] = [255, 0, 0]
    img[24, 40] = [0, 0, 255]
    img[40:, :8] = [0, 255, 0]
    ours = encode_jpeg(img)
    dec = np.asarray(Image.open(io.BytesIO(ours)).convert("RGB"), float)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    dec_p = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"),
                       float)
    assert np.abs(dec - dec_p).mean() < 1.0


def test_jpeg_refusals():
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        jpeg_info(b"\xff\xd8\xff\xe0")


def test_image_writer_writes_png_and_jpeg(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.random((20, 30, 3)).astype(np.float32)
    w = ImageWriter(workers=2, max_pending=2)
    for i in range(5):
        w.save(tmp_path / "png" / f"{i}.png", img)
        w.save(tmp_path / "jpg" / f"{i}.jpg", img)
    w.close()
    q = (np.clip(img, 0, 1) * 255).round() / 255
    np.testing.assert_array_equal(read_image(tmp_path / "png" / "4.png"), q)
    with open(tmp_path / "jpg" / "4.jpg", "rb") as f:
        assert jpeg_info(f.read()) == (20, 30, 3)
    assert sorted(os.listdir(tmp_path / "jpg")) == [f"{i}.jpg"
                                                    for i in range(5)]


def test_image_writer_flush_raises_first_error(tmp_path):
    w = ImageWriter(workers=1)
    w.save(tmp_path / "bad.png", np.zeros((2, 2, 2, 2)))
    w.save(tmp_path / "ok.png", np.zeros((2, 2, 3)))
    with pytest.raises(Exception):
        w.flush()
    w.close()
    assert (tmp_path / "ok.png").exists()


def test_write_jpeg_quantizes_like_the_dumps(tmp_path):
    img = np.linspace(-0.2, 1.2, 16 * 24 * 3).reshape(16, 24, 3)
    write_jpeg(tmp_path / "a" / "x.jpg", img)
    q = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
    with open(tmp_path / "a" / "x.jpg", "rb") as f:
        assert f.read() == encode_jpeg(q)


@pytest.mark.parametrize("scale", [4, 2])
def test_device_downscale_matches_host_resize(scale):
    rng = np.random.default_rng(scale)
    sr = rng.random((1, 48, 64, 3)).astype(np.float32)
    got = device_downscale(torch.from_numpy(sr), scale)[0].numpy()
    want = np.clip(np_resize(sr[0], scale_factor=1 / scale, mode="bicubic"),
                   0, 1)
    assert got.shape == want.shape == (48 // scale, 64 // scale, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
