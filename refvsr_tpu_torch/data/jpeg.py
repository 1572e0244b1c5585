"""Baseline JPEG encoder on numpy and the standard library, with PIL's
defaults: quality 75, 4:2:0 chroma subsampling, the Annex K quantisation
tables scaled as libjpeg scales them, the standard Huffman tables, a JFIF
1.1 header. The JAX package writes every qualitative dump as PNG and JPEG
through PIL (``refvsr_tpu/eval/runner.py:_save_img``); the card's machine
has no PIL.

The steps are libjpeg's: RGB -> YCbCr in its 16-bit fixed point, edge
replication to whole 16x16 MCUs, 2x2 chroma averages with its alternating
rounding bias, a level shift, an 8x8 DCT (here in float64, where libjpeg's
default is its integer 'islow' transform, so a coefficient can land one
quantisation step away), quantisation rounded half away from zero, and
Huffman coding. The coding is vectorised: every block's symbols (DC size,
zero runs, ZRL, EOB) become one array of (code, length) tokens, which is
packed into bytes a chunk at a time; then 0xFF bytes are stuffed.

``jpeg_info`` reads a file's frame header back (size and components), so
that a dump can be checked without a decoder."""

from __future__ import annotations

import os
import struct

import numpy as np

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

# natural-order index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# the standard Huffman tables (Annex K.3): code counts by length, symbols
DC_BITS = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
           [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
DC_VALS = (bytes(range(12)), bytes(range(12)))
AC_BITS = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125],
           [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119])
AC_VALS = tuple(bytes.fromhex("".join(h)) for h in (
    ("01020300041105122131410613516107227114328191a1082342b1c11552d1f0",
     "2433627282090a161718191a25262728292a3435363738393a43444546474849",
     "4a535455565758595a636465666768696a737475767778797a83848586878889",
     "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5",
     "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8",
     "f9fa"),
    ("000102031104052131061241510761711322328108144291a1b1c109233352f0",
     "156272d10a162434e125f11718191a262728292a35363738393a434445464748",
     "494a535455565758595a636465666768696a737475767778797a828384858687",
     "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3",
     "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8",
     "f9fa")))

# tokens packed into bits at a time (bounds the packer's memory)
_CHUNK = 1 << 19


def quant_tables(quality: int = 75):
    """(luma, chroma) tables in natural order, scaled as libjpeg's
    ``jpeg_quality_scaling`` with baseline clamping to [1, 255]."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_LUMA_Q, _CHROMA_Q))


def _huff_codes(bits, vals):
    """Canonical codes: (code[256], length[256]) by symbol."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n, count in enumerate(bits, start=1):
        for _ in range(count):
            code[vals[k]], length[vals[k]] = c, n
            c += 1
            k += 1
        c <<= 1
    return code, length


def _rgb_to_ycbcr(img):
    """libjpeg's jccolor.c in its 16-bit fixed point: three uint8-range
    int64 planes."""
    def fix(x):
        return int(x * 65536 + 0.5)
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off
          + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off
          + half - 1) >> 16
    return y, cb, cr


def _downsample(p):
    """2x2 averages with libjpeg's h2v2 bias: 1 at even output columns, 2
    at odd ones."""
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.tile([1, 2], s.shape[1] // 2)[None, :]
    return (s + bias) >> 2


_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def _blocks(plane, q):
    """Quantised zigzag coefficients (rows of blocks, cols, 64) of a
    plane whose sides are multiples of 8."""
    h, w = plane.shape
    b = (plane - 128.0).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    f = np.einsum("ux,ijxy,vy->ijuv", _DCT, b, _DCT, optimize=True)
    f = f.reshape(h // 8, w // 8, 64)[..., ZIGZAG] / q[ZIGZAG]
    return (np.sign(f) * np.floor(np.abs(f) + 0.5)).astype(np.int64)


def _size(v):
    """Bit length of |v| (0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _tokens(coefs, tabs, dc_codes, ac_codes):
    """(value, length) of every code + extra-bits token of the scan, in
    stream order. coefs (B, 64) zigzag blocks in scan order, tabs (B,)
    their table (0 luma, 1 chroma); DC differences are taken per table
    row already (see encode_jpeg)."""
    nb = coefs.shape[0]
    keys, vals, lens = [], [], []

    def add(key, code, clen, extra, nbits):
        keys.append(key)
        vals.append((code << nbits) | (extra & ((1 << nbits) - 1)))
        lens.append(clen + nbits)

    # DC: size category and its bits (negative values as v - 1)
    dc = coefs[:, 0]
    s = _size(dc)
    code, clen = dc_codes
    add(np.arange(nb) * 325, code[tabs, s], clen[tabs, s],
        np.where(dc < 0, dc - 1, dc), s)

    # AC: each nonzero coefficient after a run of zeros; runs of 16 or
    # more first emit ZRL (0xF0) tokens
    ac = coefs[:, 1:]
    bi, pi = np.nonzero(ac)
    pos = pi + 1
    prev = np.zeros_like(pos)
    same = np.zeros(len(bi), bool)
    same[1:] = bi[1:] == bi[:-1]
    prev[same] = pos[:-1][same[1:]]
    run = pos - prev - 1
    v = ac[bi, pi]
    sz = _size(v)
    code, clen = ac_codes
    t = tabs[bi]
    for j in range(3):
        z = run >= 16 * (j + 1)
        add(bi[z] * 325 + pos[z] * 5 + j, code[t[z], 0xF0],
            clen[t[z], 0xF0], np.zeros(int(z.sum()), np.int64),
            np.zeros(int(z.sum()), np.int64))
    sym = ((run % 16) << 4) | sz
    add(bi * 325 + pos * 5 + 4, code[t, sym], clen[t, sym],
        np.where(v < 0, v - 1, v), sz)

    # EOB unless the block's last coefficient is nonzero
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, bi, pos)
    e = last < 63
    add(np.flatnonzero(e) * 325 + 64 * 5, code[tabs[e], 0],
        clen[tabs[e], 0], np.zeros(int(e.sum()), np.int64),
        np.zeros(int(e.sum()), np.int64))

    order = np.argsort(np.concatenate(keys), kind="stable")
    return np.concatenate(vals)[order], np.concatenate(lens)[order]


def _pack(values, lengths):
    """The tokens' bits, MSB first, as bytes padded with 1 bits, 0xFF
    stuffed."""
    out = []
    carry = np.zeros(0, np.uint8)
    for s in range(0, len(values), _CHUNK):
        v, n = values[s:s + _CHUNK], lengths[s:s + _CHUNK]
        total = int(n.sum())
        tok = np.repeat(np.arange(len(n), dtype=np.int32), n)
        start = np.cumsum(n) - n
        off = np.arange(total, dtype=np.int64) - start[tok]
        bits = ((v[tok] >> (n[tok] - 1 - off)) & 1).astype(np.uint8)
        bits = np.concatenate([carry, bits])
        whole = len(bits) // 8 * 8
        out.append(np.packbits(bits[:whole]))
        carry = bits[whole:]
    if len(carry):
        out.append(np.packbits(np.concatenate(
            [carry, np.ones(8 - len(carry), np.uint8)])))
    data = np.concatenate(out) if out else np.zeros(0, np.uint8)
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def _segment(marker, payload):
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """A baseline JFIF JPEG of an (H, W, 3) uint8 RGB image, 4:2:0."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"need an (H, W, 3) uint8 image, not "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    ph, pw = -h % 16, -w % 16
    img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    y, cb, cr = _rgb_to_ycbcr(img)
    qy, qc = quant_tables(quality)
    by = _blocks(y, qy)                               # (2R, 2C, 64)
    bcb, bcr = (_blocks(_downsample(p), qc) for p in (cb, cr))
    rows, cols = bcb.shape[:2]
    ymcu = by.reshape(rows, 2, cols, 2, 64).transpose(0, 2, 1, 3, 4)
    mcu = np.concatenate([ymcu.reshape(rows, cols, 4, 64), bcb[:, :, None],
                          bcr[:, :, None]], 2).reshape(-1, 6, 64)
    # DC differences per component, in scan order
    dc = mcu[:, :, 0].copy()
    ydc = dc[:, :4].reshape(-1)
    mcu[:, :4, 0] = np.diff(ydc, prepend=0).reshape(-1, 4)
    for k in (4, 5):
        mcu[:, k, 0] = np.diff(dc[:, k], prepend=0)
    tabs = np.tile([0, 0, 0, 0, 1, 1], mcu.shape[0])
    dc_codes = tuple(np.stack(a) for a in zip(
        *(_huff_codes(b, v) for b, v in zip(DC_BITS, DC_VALS))))
    ac_codes = tuple(np.stack(a) for a in zip(
        *(_huff_codes(b, v) for b, v in zip(AC_BITS, AC_VALS))))
    values, lengths = _tokens(mcu.reshape(-1, 64), tabs, dc_codes, ac_codes)

    head = [b"\xff\xd8",
            _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, q in enumerate((qy, qc)):
        head.append(_segment(0xDB, bytes([i]) + bytes(
            q[ZIGZAG].astype(np.uint8))))
    head.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                         + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for i in (0, 1):
        for cls, bits, vals in ((0, DC_BITS[i], DC_VALS[i]),
                                (1, AC_BITS[i], AC_VALS[i])):
            head.append(_segment(0xC4, bytes([cls << 4 | i]) + bytes(bits)
                                 + bytes(vals)))
    head.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                      0])))
    return b"".join(head) + _pack(values, lengths) + b"\xff\xd9"


def write_jpeg(path, arr: np.ndarray, quality: int = 75) -> None:
    """An (H, W, 3) float image in [0, 1] as a JPEG, quantized as the
    JAX package quantizes its dumps: ``(clip(x, 0, 1) * 255).round()``."""
    q = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_jpeg(q, quality))


def jpeg_info(buf: bytes):
    """(height, width, components) from a JPEG's SOF0 header; raises on a
    file that does not start with SOI and end with EOI."""
    if buf[:2] != b"\xff\xd8" or buf[-2:] != b"\xff\xd9":
        raise ValueError("not a complete JPEG (SOI/EOI)")
    i = 2
    while i + 4 <= len(buf):
        if buf[i] != 0xFF:
            raise ValueError(f"bad marker at {i}")
        marker = buf[i + 1]
        (length,) = struct.unpack(">H", buf[i + 2:i + 4])
        if marker == 0xC0:
            _, h, w, nc = struct.unpack(">BHHB", buf[i + 4:i + 10])
            return h, w, nc
        i += 2 + length
    raise ValueError("no SOF0 frame header")
