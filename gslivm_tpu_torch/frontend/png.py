"""PNG decoding for the camera intake, without OpenCV.

The target is `cv2.imdecode(..., IMREAD_COLOR)` (libpng), bit for bit, on
8-bit gray, RGB and RGBA images without interlacing: zlib from the
standard library inflates the IDAT stream, and the five row filters
(None, Sub, Up, Average, Paeth; Sub, Average and Paeth run along a row) are
undone in C++ (`csrc/jpeg_entropy.cpp:png_unfilter` through
`native.codec()`). IMREAD_COLOR repeats a gray channel and drops alpha
without compositing; so does `decode`. Other bit depths, palettes, gray
with alpha and Adam7 interlacing raise a ValueError that names the mode,
as does a chunk whose CRC does not match.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels
_MODES = {3: "palette", 4: "gray with alpha"}


def decode_raw(data: bytes) -> np.ndarray:
    """A PNG -> [H, W, C] uint8 in the file's channel order (C = 1 gray,
    3 RGB, 4 RGBA)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG stream (bad signature)")
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind.decode('latin-1')} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{_MODES.get(ctype, f'colour type {ctype}')} PNG is not supported "
                         "(8-bit gray, RGB or RGBA only)")
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG is not supported (8-bit only)")
    if interlace:
        raise ValueError("Adam7-interlaced PNG is not supported")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (width * c + 1):
        raise ValueError("PNG image data is shorter than its size")
    raw = np.ascontiguousarray(raw[:height * (width * c + 1)])
    out = np.empty((height, width, c), np.uint8)
    err = native.codec().png_unfilter(raw.ctypes.data, height, width * c, c, out.ctypes.data)
    if err:
        raise ValueError("PNG row with a filter type other than 0..4")
    return out


def decode(data: bytes) -> np.ndarray:
    """A PNG -> [H, W, 3] uint8 RGB, equal to
    cv2.imdecode(data, IMREAD_COLOR)[..., ::-1]."""
    img = decode_raw(data)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
