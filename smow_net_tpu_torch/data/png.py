"""PNG reader and writer with no image library (the GPU machine has no cv2,
PIL or matplotlib).

`read_png` returns what the JAX package's reader, matplotlib's `imread`,
returns for the same file: float32 in [0, 1], `np.divide(x, 255,
dtype=float32)` of the 8-bit samples, a 16-bit gray image over 65535, the
other 16-bit images by their high bytes over 255 (as Pillow coarsens them
for matplotlib); gray as (H, W), RGB as (H, W, 3), gray + alpha, RGBA and
palette images as (H, W, 4). Chunks are parsed here, the data inflated by
`zlib` (which releases the GIL) and unfiltered by the host engine's
`png_unfilter`. Interlaced images and bit depths below 8 raise ValueError.

`write_png` stores uint8 gray, RGB or RGBA pixels, filter 0, deflated by
zlib: the pixels of PIL's `Image.fromarray(x).save(path)`, not its bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..runtime import native

__all__ = ["read_png", "decode_png", "write_png", "encode_png"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}       # colour type -> samples per pixel


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"PNG chunk {kind!r} is cut short")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(body, zlib.crc32(kind)) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """The float32 image of PNG file contents `data` (see the module doc)."""
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG file has no IHDR or no IDAT chunk")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    if ctype not in _CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"unsupported PNG: colour type {ctype} at bit depth {depth} "
                         "(supported: 8 bits; 16 bits except for palettes)")
    channels, size = _CHANNELS[ctype], depth // 8
    row_bytes = width * channels * size
    try:
        # the output's size is known: one buffer, so zlib releases the GIL once
        raw = zlib.decompress(b"".join(idat), bufsize=height * (row_bytes + 1))
    except zlib.error as e:
        raise ValueError(f"PNG data does not inflate: {e}") from e
    rows = native.png_unfilter(raw, height, row_bytes, channels * size)
    if depth == 16:
        samples = rows.view(">u2").reshape(height, width, channels)
        if ctype == 0:
            return np.divide(samples[..., 0], 2 ** 16 - 1, dtype=np.float32)
        pixels = (samples >> 8).astype(np.uint8)
    else:
        pixels = rows.reshape(height, width, channels)
    if ctype == 0:
        pixels = pixels[..., 0]
    elif ctype == 4:                                 # gray + alpha -> RGBA
        pixels = pixels[..., [0, 0, 0, 1]]
    elif ctype == 3:                                 # palette -> RGBA
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        rgba = np.zeros((256, 4), np.uint8)
        rgba[:, 3] = 255
        rgba[:len(palette), :3] = palette
        if trns is not None:
            rgba[:len(trns), 3] = trns[:256]
        pixels = rgba[pixels[..., 0]]
    return np.divide(pixels, 2 ** 8 - 1, dtype=np.float32)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(pixels: np.ndarray) -> bytes:
    """PNG file contents of uint8 pixels: (H, W) gray, (H, W, 3) RGB or
    (H, W, 4) RGBA; deflated at zlib's level 6, as PIL does."""
    pixels = np.asarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    ctype = {1: 0, 3: 2, 4: 6}.get(pixels.shape[-1]) if pixels.ndim == 3 else None
    if pixels.dtype != np.uint8 or ctype is None:
        raise ValueError(f"write_png takes uint8 (H, W), (H, W, 3) or (H, W, 4) pixels, "
                         f"got {pixels.dtype} {pixels.shape}")
    height, width = pixels.shape[:2]
    rows = np.ascontiguousarray(pixels).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)   # filter 0
    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels))
