"""PNG read/write with the reference's exact gamma-2.2 float conversion.

Reference read path (src/image_formats.cpp:174-204): decode to RGBA8,
keep RGB only (3 channels), linearize each byte as ``(v/255)^2.2`` —
gamma 2.2, deliberately NOT exact sRGB. Write path (144-172): clamp to
[0,1], encode ``s^(1/2.2)``, quantize ``uint8(255.9 * s)``, always emit
RGBA with alpha=255 when the image isn't 4-channel.

Codec backend: Pillow when available (fast C decoder for arbitrary PNGs);
a self-contained zlib fallback otherwise (8-bit gray/RGB/RGBA/palette,
all five scanline filters on decode; filter-0 on encode). The float
conversions happen in vectorized numpy either way, so parity with the
reference is backend-independent.

Deviation from the reference (deliberate): for a 5-channel RGBAZ image the
reference's writer indexes ``pixel*4 + c`` for c in [0,5), writing Z into
the next pixel's R — a buffer overflow (SURVEY.md C13 quirk). We write the
first 4 channels only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .image import DataLayout, ImageBuffer

try:
    from PIL import Image as _PILImage

    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False

BACKEND = "Pillow" if _HAVE_PIL else "built-in zlib codec"

# Byte value -> linear float LUT: (v/255)^2.2 in float32, one rounding.
_DECODE_LUT = (np.arange(256, dtype=np.float32) / np.float32(255.0)) ** np.float32(2.2)


def _decode_rgba8_fallback(buf: bytes) -> np.ndarray:
    """Minimal PNG decoder: 8-bit gray/RGB/palette/gray+A/RGBA, no interlace."""
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos = 8
    idat = bytearray()
    w = h = None
    bit_depth = color_type = None
    palette = None
    trns = None
    while pos < len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        ctype = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            w, h, bit_depth, color_type, _comp, _filt, interlace = struct.unpack(">IIBBBBB", data)
            if bit_depth != 8:
                raise ValueError(f"PNG fallback decoder supports bit depth 8 only (got {bit_depth})")
            if interlace != 0:
                raise ValueError("PNG fallback decoder does not support interlacing")
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(data, dtype=np.uint8)
        elif ctype == b"IDAT":
            idat += data
        elif ctype == b"IEND":
            break

    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = np.frombuffer(zlib.decompress(bytes(idat)), dtype=np.uint8)
    stride = w * nch
    raw = raw.reshape(h, stride + 1)
    filters = raw[:, 0]
    scan = raw[:, 1:].astype(np.int32)

    recon = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.int32)
    for y in range(h):
        f = filters[y]
        line = scan[y].copy()
        if f == 0:
            pass
        elif f == 2:  # up
            line = (line + prev) & 0xFF
        elif f == 1:  # sub
            for i in range(nch, stride):
                line[i] = (line[i] + line[i - nch]) & 0xFF
        elif f == 3:  # average
            for i in range(stride):
                a = line[i - nch] if i >= nch else 0
                line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif f == 4:  # paeth
            for i in range(stride):
                a = line[i - nch] if i >= nch else 0
                b = prev[i]
                c = prev[i - nch] if i >= nch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {f}")
        recon[y] = line.astype(np.uint8)
        prev = line

    px = recon.reshape(h, w, nch)
    rgba = np.empty((h, w, 4), dtype=np.uint8)
    if color_type == 0:
        rgba[..., :3] = px
        rgba[..., 3] = 255
    elif color_type == 2:
        rgba[..., :3] = px
        rgba[..., 3] = 255
    elif color_type == 3:
        idx = px[..., 0]
        rgba[..., :3] = palette[idx]
        if trns is not None:
            alpha = np.full(256, 255, dtype=np.uint8)
            alpha[: trns.size] = trns
            rgba[..., 3] = alpha[idx]
        else:
            rgba[..., 3] = 255
    elif color_type == 4:
        rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = px[..., 0]
        rgba[..., 3] = px[..., 1]
    elif color_type == 6:
        rgba[:] = px
    return rgba


def decode_rgba8(path: str) -> np.ndarray:
    """Decode any PNG to (H, W, 4) uint8, like lodepng::decode."""
    if _HAVE_PIL:
        with _PILImage.open(path) as im:
            return np.asarray(im.convert("RGBA"), dtype=np.uint8)
    with open(path, "rb") as f:
        return _decode_rgba8_fallback(f.read())


def read_png(path: str) -> ImageBuffer:
    """PNG -> linear float32 RGB (reference src/image_formats.cpp:174-204)."""
    rgba = decode_rgba8(path)
    data = _DECODE_LUT[rgba[..., :3]]
    return ImageBuffer(data=np.ascontiguousarray(data), layout=DataLayout.RGB)


def encode_rgba8(img: np.ndarray) -> np.ndarray:
    """Float (H, W, C) -> gamma-encoded (H, W, 4) uint8 RGBA.

    Exact reference math (src/image_formats.cpp:150-163): clamp [0,1],
    ^(1/2.2), uint8(255.9 * s) truncation; alpha forced to 255 unless the
    image has exactly 4 channels.
    """
    h, w, c = img.shape
    cw = min(c, 4)
    s = np.clip(img[..., :cw].astype(np.float32), 0.0, 1.0)
    s = s ** np.float32(1.0 / 2.2)
    q = (np.float32(255.9) * s).astype(np.uint8)
    rgba = np.empty((h, w, 4), dtype=np.uint8)
    rgba[..., :cw] = q
    if c != 4:
        rgba[..., 3] = 255
    return rgba


def write_png(path: str, img: np.ndarray) -> None:
    rgba = encode_rgba8(img)
    if _HAVE_PIL:
        _PILImage.fromarray(rgba, mode="RGBA").save(path, format="PNG")
        return
    # Fallback encoder: filter 0, zlib level 6.
    h, w = rgba.shape[:2]
    raw = np.concatenate(
        [np.zeros((h, 1), dtype=np.uint8), rgba.reshape(h, w * 4)], axis=1
    ).tobytes()
    idat = zlib.compress(raw, 6)

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + ctype
            + data
            + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", idat))
        f.write(chunk(b"IEND", b""))


def save_png(path: str, img: ImageBuffer) -> None:
    write_png(path, img.data)
