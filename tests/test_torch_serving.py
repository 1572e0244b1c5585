"""The port's serving slice: the PNG codec against PIL and the Predictor
against the JAX package's, on the CPU.

The codec (``refvsr_tpu_torch/data/png.py``) must decode what PIL writes
exactly, at colour types 0, 2, 3, 4 and 6 and odd widths, and every
scanline filter: PIL writes filters 0, 1, 2 and 4, so files with hand-built
scanlines force each of the five, Paeth's ties included. Its files must
read back through PIL exactly, and a 16-bit, interlaced or non-PNG file,
or a broken CRC, must be refused with a ValueError.

``Predictor.predict`` on the CPU in f32 against the JAX ``Predictor`` in
f32, a tiny RefVSR_MFID_8K (2 blocks, 8 channels) with the JAX parameters
carried over by ``params_from_jax``, on a PNG pair taller than the 720-row
crop limit and of a width that is not a multiple of 8, so both crops run:
the float outputs within atol 2e-4 (f32 convolutions through about 60
layers summed in another order), the written PNGs within one level (a
value at a .5 boundary may round either way)."""

import io
import struct
import zlib

import jax.numpy as jnp
import jax.tree_util
import numpy as np
import pytest
import torch
from PIL import Image

from refvsr_tpu.configs import get_config as jax_get_config
from refvsr_tpu.serving import predictor as jax_predictor
from refvsr_tpu_torch.configs import get_config
from refvsr_tpu_torch.data.png import (decode_png, encode_png, read_image,
                                       write_image)
from refvsr_tpu_torch.models.refvsr import RefVSRNet
from refvsr_tpu_torch.serving.predictor import Predictor
from refvsr_tpu_torch.utils.convert import params_from_jax

ATOL = 2e-4
# taller than the 720-row crop limit, width not a multiple of 8
PAIR_HW = (723, 45)


def _pil_png(arr, mode=None, **kw):
    buf = io.BytesIO()
    img = arr if isinstance(arr, Image.Image) else Image.fromarray(arr, mode)
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


def _filters(buf):
    """The set of scanline filter types in an 8-bit PNG."""
    pos, idat, hdr = 8, b"", None
    while pos < len(buf):
        n, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif ctype == b"IDAT":
            idat += data
        pos += 12 + n
    w, h, _, ctype = hdr[:4]
    stride = 1 + w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    return {raw[r * stride] for r in range(h)}


def _image(rng, shape):
    """A gradient with noise: smooth enough that PIL's filter choice
    varies from row to row."""
    h, w = shape[:2]
    ramp = np.add.outer(np.arange(h) * 3, np.arange(w) * 2)
    ramp = ramp.reshape(h, w, *([1] * (len(shape) - 2)))
    return ((ramp + rng.integers(0, 24, shape)) % 256).astype(np.uint8)


def _chunk(ctype, data):
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data)))


def _png(w, h, depth, ctype, idat, interlace=0, plte=None):
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, interlace))
            + (_chunk(b"PLTE", plte) if plte is not None else b"")
            + _chunk(b"IDAT", zlib.compress(idat)) + _chunk(b"IEND", b""))


def _filter_rows(img, types):
    """Scanlines of (H, W, C) uint8 filtered row by row with the given PNG
    filter types, by the spec's definitions (section 9), one byte at a
    time."""
    h, w, c = img.shape
    x = img.astype(np.int64).reshape(h, w * c)
    rows = []
    for r in range(h):
        out = [types[r % len(types)]]
        for i in range(w * c):
            a = x[r, i - c] if i >= c else 0
            b = x[r - 1, i] if r else 0
            cc = x[r - 1, i - c] if r and i >= c else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            pred = [0, a, b, (a + b) // 2,
                    a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                    ][out[0]]
            out.append((x[r, i] - pred) % 256)
        rows.append(bytes(out))
    return b"".join(rows)


@pytest.mark.parametrize("mode,shape", [("L", (37, 53)), ("RGB", (37, 53, 3)),
                                        ("RGBA", (29, 41, 4)),
                                        ("LA", (23, 31, 2)),
                                        ("RGB", (1, 1, 3)), ("RGB", (5, 1, 3)),
                                        ("RGB", (64, 257, 3))])
def test_decoder_matches_pil(mode, shape):
    rng = np.random.default_rng(len(mode) * 100 + shape[1])
    buf = _pil_png(_image(rng, shape), mode)
    got = decode_png(buf)
    want = np.asarray(Image.open(io.BytesIO(buf)))
    np.testing.assert_array_equal(got, want.reshape(got.shape))


def test_pil_files_cover_its_filters():
    """The PIL files above use more than one filter: Sub, Up and Paeth
    appear among them (PIL never writes Average; the hand-built files do)."""
    rng = np.random.default_rng(1)
    seen = set()
    for shape, mode in (((37, 53), "L"), ((37, 53, 3), "RGB")):
        seen |= _filters(_pil_png(_image(rng, shape), mode))
    assert {1, 2, 4} <= seen


def test_decoder_palette_matches_pil():
    rng = np.random.default_rng(2)
    img = Image.fromarray(_image(rng, (33, 47, 3))).quantize(256)
    assert len(img.getpalette()) // 3 > 16    # an 8-bit palette file
    buf = _pil_png(img)
    np.testing.assert_array_equal(decode_png(buf), np.asarray(
        Image.open(io.BytesIO(buf)).convert("RGB")))


@pytest.mark.parametrize("channels,ctype", [(1, 0), (2, 4), (3, 2), (4, 6)])
@pytest.mark.parametrize("types", [(0,), (1,), (2,), (3,), (4,),
                                   (4, 3, 2, 1, 0)])
def test_decoder_every_filter_matches_pil(channels, ctype, types):
    """Hand-built scanlines force each filter type; ties in Paeth come from
    flat runs, and the byte arithmetic wraps mod 256."""
    rng = np.random.default_rng(3)
    img = _image(rng, (9, 13, channels))
    img[2:5, :6] = 7                     # flat block: Paeth ties
    img[6, ::2] = 255
    img[6, 1::2] = 0                     # alternating extremes: wraps
    buf = _png(13, 9, 8, ctype, _filter_rows(img, types))
    want = np.asarray(Image.open(io.BytesIO(buf)))
    got = decode_png(buf)
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode,shape", [("L", (11, 7)), ("RGB", (11, 7, 3)),
                                        ("RGBA", (11, 7, 4)),
                                        ("LA", (11, 7, 2))])
def test_read_image_matches_pil_convert_rgb(tmp_path, mode, shape):
    rng = np.random.default_rng(4)
    path = tmp_path / "x.png"
    Image.fromarray(_image(rng, shape), mode).save(path)
    want = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    got = read_image(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1, 3), (17, 33, 3), (40, 255, 3)])
def test_encoder_round_trips_through_pil(shape):
    img = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    buf = encode_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(buf))),
                                  img)
    np.testing.assert_array_equal(decode_png(buf), img)


def test_write_image_quantizes_as_the_jax_predictor(tmp_path):
    arr = np.random.default_rng(6).uniform(-0.2, 1.2, (9, 14, 3)).astype(
        np.float32)
    arr[0, :4, 0] = [0.5 / 255, 1.5 / 255, 254.5 / 255, 1.0]
    write_image(tmp_path / "sub" / "q.png", arr)
    want = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "sub" / "q.png")), want)


@pytest.mark.parametrize("case", ["16-bit", "interlaced", "jpeg", "text",
                                  "crc", "truncated"])
def test_decoder_refuses(case):
    img = np.random.default_rng(7).integers(0, 256, (8, 8, 3), np.uint8)
    if case == "16-bit":
        buf = _pil_png(Image.fromarray(
            np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000))
        match = "bit depth 16"
    elif case == "interlaced":
        buf = _png(8, 8, 8, 2, _filter_rows(img, (0,)), interlace=1)
        match = "interlaced"
    elif case == "jpeg":
        out = io.BytesIO()
        Image.fromarray(img).save(out, "JPEG")
        buf = out.getvalue()
        match = "not a PNG"
    elif case == "text":
        buf = b"hello, world"
        match = "not a PNG"
    elif case == "crc":
        buf = bytearray(encode_png(img))
        buf[40] ^= 1                     # a byte of the IDAT data
        buf = bytes(buf)
        match = "CRC"
    else:
        buf = encode_png(img)[:-20]
        match = "cut short|IEND"
    with pytest.raises(ValueError, match=match):
        decode_png(buf)


# ---------------------------------------------------------------- Predictor


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    rng = np.random.default_rng(8)
    for name in ("lr", "ref"):
        Image.fromarray(_image(rng, (*PAIR_HW, 3))).save(d / f"{name}.png")
    return d


@pytest.fixture(scope="module")
def predicted(pair):
    """The JAX and port predictors (f32) on the pair: (JAX float output,
    port float output, JAX PNG, port PNG)."""
    jp = jax_predictor.Predictor(
        jax_get_config("RefVSR_MFID_8K", num_blocks=2, mid_channels=8),
        compute_dtype=jnp.float32)
    jax_png = jp.predict(str(pair / "lr.png"), str(pair / "ref.png"),
                         str(pair / "jax.png"))

    def seq(name):
        img = jax_predictor.refine_to_multiple(jax_predictor._crop_max(
            jax_predictor._read_image(pair / f"{name}.png")), 8)
        return np.broadcast_to(img[None, None], (1, 3) + img.shape).copy()
    out_j = np.asarray(jp._jit(jp.params, seq("lr"), seq("ref"))[0],
                       np.float32)

    cfg = get_config("RefVSR_MFID_8K", num_blocks=2, mid_channels=8)
    net = RefVSRNet(scale=cfg.scale, num_blocks=2, mid_channels=8,
                    matching_ksize=cfg.matching_ksize, flag_HD_in=True,
                    zero_flow=True)
    # the JAX zero-flow net never calls SPyNet, so flax made no FlowNet
    # parameters; the port's net keeps its (unused) SPyNet
    res = net.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp.params)), strict=False)
    assert not res.unexpected_keys and res.missing_keys
    assert all(k.startswith("FlowNet.") for k in res.missing_keys)
    pp = Predictor(cfg, net=net, device="cpu", compute_dtype=torch.float32)
    port_png = pp.predict(pair / "lr.png", pair / "ref.png",
                          pair / "out" / "port.png")
    out_t = pp.enhance(read_image(pair / "lr.png"),
                       read_image(pair / "ref.png"))
    return out_j, out_t, jax_png, port_png


def test_predictor_float_output_matches_jax(predicted):
    out_j, out_t, _, _ = predicted
    h, w = 720, PAIR_HW[1] - PAIR_HW[1] % 8
    assert out_t.shape == out_j.shape == (4 * h, 4 * w, 3)
    # most of the frame lies inside the clamp, so the values are compared
    assert ((out_t > 0) & (out_t < 1)).mean() > 0.5
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_predictor_png_matches_jax_within_one_level(predicted):
    _, out_t, jax_png, port_png = predicted
    got = np.asarray(Image.open(port_png)).astype(int)
    want = np.asarray(Image.open(jax_png)).astype(int)
    assert got.shape == want.shape
    assert int(np.abs(got - want).max()) <= 1
    # the port's PNG is its own float output, quantized
    np.testing.assert_array_equal(
        got, (np.clip(out_t, 0, 1) * 255).round().astype(int))


def test_predictor_load_checkpoint_reports_keys(tmp_path):
    cfg = get_config("RefVSR_MFID_8K", num_blocks=1, mid_channels=8)
    p = Predictor(cfg, device="cpu", compute_dtype=torch.float32)
    sd = {k: v.clone() + 1 for k, v in p.net.state_dict().items()}
    gone = "conv_last.bias"
    del sd[gone]
    sd["module.extra.weight"] = torch.zeros(2)
    sd["sub_mean.weight"] = torch.zeros(3)      # the reference's, ignored
    torch.save(sd, tmp_path / "w.pytorch")
    missing, unexpected = p.load_checkpoint(str(tmp_path / "w.pytorch"))
    assert missing == [gone]
    assert unexpected == ["extra.weight"]
    got = p.net.state_dict()
    assert torch.equal(got["conv_hr.weight"], sd["conv_hr.weight"])
    with pytest.raises(ValueError, match="msgpack"):
        p.load_checkpoint(str(tmp_path / "w.msgpack"))


def test_predictor_refuses_a_net_without_zero_flow():
    cfg = get_config("RefVSR_MFID_8K", num_blocks=1, mid_channels=8)
    net = RefVSRNet(scale=4, num_blocks=1, mid_channels=8,
                    matching_ksize=cfg.matching_ksize, flag_HD_in=True)
    with pytest.raises(ValueError):
        Predictor(cfg, net=net, device="cpu")


def test_predictor_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        Predictor()
