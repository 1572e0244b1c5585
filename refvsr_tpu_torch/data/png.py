"""PNG reader and writer on the standard library's ``zlib`` and ``struct``
and numpy, for machines without PIL, cv2 or imageio.

The reader takes 8-bit non-interlaced files of colour types 0 (grey),
2 (RGB), 3 (palette, ``PLTE``), 4 (grey + alpha) and 6 (RGBA), with the
five scanline filters of the PNG specification (section 9) and the IDAT
chunks concatenated; every chunk's CRC is checked. Anything else (another
bit depth, an interlaced file, a file that is not a PNG) raises a
``ValueError`` that names what it found. ``read_image`` gives what the
JAX package's reader gives through PIL's ``convert("RGB")``: grey
replicated, alpha dropped, palettes looked up, as float32 in [0, 1].

The writer writes 8-bit RGB with filter 0 (none) on every row."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(buf: bytes):
    """(type, data) of each chunk, CRCs checked, through IEND."""
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(buf):
            raise ValueError("PNG ends before its IEND chunk")
        length, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if crc_at + 4 > len(buf):
            raise ValueError(f"PNG chunk {ctype!r} is cut short")
        crc, = struct.unpack(">I", buf[crc_at:crc_at + 4])
        if zlib.crc32(ctype + data) != crc:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, data
        if ctype == b"IEND":
            return
        pos = crc_at + 4


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters: raw (H, 1 + W*bpp) uint8, the filter
    type first on each row -> (H, W, bpp) uint8.

    Rows of types 0-2 (none, Sub, Up) go one whole row at a time. Average
    and Paeth read the reconstructed left neighbour, so where a row has
    either, the image is rebuilt one anti-diagonal of pixels at a time:
    pixel (r, j) needs only (r, j-1), (r-1, j) and (r-1, j-1), which the
    earlier diagonals hold."""
    h = raw.shape[0]
    ftype = raw[:, 0]
    if int(ftype.max(initial=0)) > 4:
        raise ValueError(f"PNG filter type {int(ftype.max())} is not 0-4")
    x = raw[:, 1:].reshape(h, -1, bpp)
    w = x.shape[1]
    if not np.isin(ftype, (3, 4)).any():
        out = np.empty_like(x)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            f = ftype[r]
            if f == 0:
                out[r] = x[r]
            elif f == 1:
                # recon = raw + left recon: a running sum mod 256
                out[r] = np.cumsum(x[r], 0, dtype=np.uint64).astype(np.uint8)
            else:
                out[r] = x[r] + prev
            prev = out[r]
        return out
    # skewed layout: pixel (r, j) sits at [r + j + 2, r + 1], so each
    # anti-diagonal is one contiguous row and its three neighbours are
    # slices of the two before; cells outside the image stay zero, which
    # is the PNG's value for a missing neighbour
    rr, jj = np.arange(h)[:, None], np.arange(w)[None, :]
    ks, rs = rr + jj + 2, np.broadcast_to(rr + 1, (h, w))
    xs = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    xs[ks, rs] = x
    rec = np.zeros_like(xs)
    f = np.zeros((h + 1, 1), np.int16)
    f[1:, 0] = ftype
    for k in range(2, h + w + 1):
        lo, hi = max(1, k - w), min(h, k - 1)
        a = rec[k - 1, lo:hi + 1]          # left
        b = rec[k - 1, lo - 1:hi]          # above
        c = rec[k - 2, lo - 1:hi]          # above left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        # ties go to a, then b, then c (PNG spec 9.4)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        ft = f[lo:hi + 1]
        pred = np.where(ft == 1, a, np.where(
            ft == 2, b, np.where(ft == 3, (a + b) >> 1,
                                 np.where(ft == 4, paeth, 0))))
        rec[k, lo:hi + 1] = (xs[k, lo:hi + 1] + pred) & 255
    return rec[ks, rs].astype(np.uint8)


def decode_png(buf: bytes) -> np.ndarray:
    """An 8-bit non-interlaced PNG as (H, W, C) uint8 in its own channels:
    C = 1 (grey), 2 (grey + alpha), 3 (RGB or palette, looked up) or 4
    (RGBA)."""
    if buf[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError(f"not a PNG file: it starts with "
                         f"{bytes(buf[:8])!r}")
    header, palette, idat = None, None, []
    for ctype, data in _chunks(buf):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported (8 only)")
    if interlace != 0:
        raise ValueError(f"interlaced PNG (method {interlace}) is not "
                         f"supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression method {comp} / filter method "
                         f"{filt} is not 0")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG image data holds {raw.size} bytes, not the "
                         f"{h * (1 + w * bpp)} of {w}x{h} colour type "
                         f"{ctype}")
    img = _unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        img = palette[img[..., 0]]
    return img


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 as an 8-bit RGB PNG, filter 0 on every row."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, not "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, -1)

    def chunk(ctype, data):
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data)))
    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_image(path) -> np.ndarray:
    """A PNG file as (H, W, 3) float32 in [0, 1], as PIL's
    ``convert("RGB")`` gives it: grey replicated, alpha dropped, palettes
    looked up."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[2] in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3].astype(np.float32) / 255.0


def write_image(path, arr: np.ndarray) -> None:
    """An (H, W, 3) float image in [0, 1] as an 8-bit RGB PNG, quantized as
    the JAX predictor does: ``(clip(x, 0, 1) * 255).round()``."""
    q = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(q))
