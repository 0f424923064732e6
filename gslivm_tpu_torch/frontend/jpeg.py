"""Baseline JPEG decoding and encoding for the camera intake, without
OpenCV.

The target is OpenCV's `cv2.imdecode(..., IMREAD_COLOR)` (libjpeg-turbo),
bit for bit: the "islow" integer IDCT (jidctint.c), libjpeg's "fancy"
triangular chroma upsampling for h2v1, h1v2 and h2v2 (jdsample.c; the
merged upsampler is off while fancy upsampling is on), box replication for
other integer factors, and the fixed-point YCbCr->RGB tables (jdcolor.c).
The work splits in two:

  - entropy decoding, sequential by nature, runs on the host in C++
    (`csrc/jpeg_entropy.cpp` through `native.codec()`): the bit reader,
    the Huffman tables, the DC prediction and the restart markers; it
    writes each component's int16 coefficients as [blocks, 64];
  - reconstruction (dequantisation, IDCT, upsampling, colour conversion)
    runs as integer tensor ops on the caller's device (`reconstruct`).

Scope: baseline sequential Huffman (SOF0/SOF1), 8-bit samples, 1 or 3
components (YCbCr), one scan, any integer sampling factors, DRI/RSTn
restart intervals, any image size. Progressive, lossless, hierarchical,
arithmetic-coded and 12-bit streams, RGB- or CMYK-coded streams, more than
one scan and an Exif orientation other than 1 (which IMREAD_COLOR would
apply) raise a ValueError that names the mode.

`encode` writes a baseline 4:2:0 JFIF with the standard Annex K tables at
IJG quality scaling: test support for the bag writer, not byte-matched to
libjpeg.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from . import native

# zigzag index -> natural (row-major) index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_FRAME_MODES = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical (differential sequential)",
    0xC6: "hierarchical (differential progressive)", 0xC7: "hierarchical (differential lossless)",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless"}


class Component(NamedTuple):
    ident: int
    h: int
    v: int
    tq: int


class Coefficients(NamedTuple):
    """A parsed and entropy-decoded stream: what `reconstruct` needs."""
    width: int
    height: int
    components: tuple      # Component per plane
    qtables: dict          # tq -> [64] int32, natural order
    blocks: list           # per component: [block rows, block cols, 64] int16, natural order


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _exif_orientation(seg: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 in an APP1 Exif segment, 1 if absent."""
    if not seg.startswith(b"Exif\0\0") or len(seg) < 14:
        return 1
    tiff = seg[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    (ifd,) = struct.unpack_from(order + "I", tiff, 4)
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack_from(order + "H", tiff, ifd)
    for i in range(n):
        off = ifd + 2 + 12 * i
        if off + 12 > len(tiff):
            break
        tag, typ = struct.unpack_from(order + "HH", tiff, off)
        if tag == 0x0112 and typ == 3:
            return struct.unpack_from(order + "H", tiff, off + 8)[0]
    return 1


def entropy_decode(data: bytes) -> Coefficients:
    """Parse the markers of a baseline JPEG and Huffman-decode its scan in
    C++. Raises ValueError for what the module does not decode."""
    buf = np.frombuffer(data, np.uint8)
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    counts = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    qtables: dict = {}
    frame = None
    restart = 0
    jfif = adobe = False
    adobe_transform = None
    blocks = None
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # garbage between markers, as libjpeg skips it
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1  # fill bytes
        if pos >= len(data):
            raise ValueError("JPEG stream ends before its EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > len(data):
            raise ValueError("truncated JPEG marker segment")
        (length,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + length]
        if len(seg) != length - 2:
            raise ValueError("truncated JPEG marker segment")
        pos += length
        if marker in _FRAME_MODES or marker == 0xCC:
            raise ValueError(f"{_FRAME_MODES.get(marker, 'arithmetic-coded')} JPEG is not "
                             "supported (baseline sequential Huffman only)")
        if marker == 0xE0 and seg.startswith(b"JFIF\0"):
            jfif = True
        elif marker == 0xE1:
            orientation = _exif_orientation(seg)
            if orientation != 1:
                raise ValueError(f"JPEG with Exif orientation {orientation} is not supported "
                                 "(imdecode would rotate it)")
        elif marker == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe, adobe_transform = True, seg[11]
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                raw = np.frombuffer(seg, ">u2" if pq else "u1", 64, i + 1).astype(np.int32)
                table = np.zeros(64, np.int32)
                table[_ZIGZAG] = raw
                qtables[tq] = table
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                if tc > 1 or th > 3:
                    raise ValueError(f"bad Huffman table class {tc} / id {th}")
                c = np.frombuffer(seg, np.uint8, 16, i + 1)
                n = int(c.sum())
                if n > 256:
                    raise ValueError(f"Huffman table of {n} symbols")
                counts[4 * tc + th] = c
                vals[4 * tc + th] = 0
                vals[4 * tc + th, :n] = np.frombuffer(seg, np.uint8, n, i + 17)
                i += 17 + n
        elif marker in (0xC0, 0xC1):  # baseline / extended sequential, Huffman
            precision, height, width, nf = struct.unpack_from(">BHHB", seg, 0)
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG is not supported (8-bit only)")
            comps = tuple(Component(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15,
                                    seg[8 + 3 * k]) for k in range(nf))
            if nf not in (1, 3):
                raise ValueError(f"a JPEG of {nf} components is not supported (1 or 3)")
            if width == 0 or height == 0:
                raise ValueError("JPEG with a zero or DNL-defined size is not supported")
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            if any(hmax % c.h or vmax % c.v or not 1 <= c.h <= 4 or not 1 <= c.v <= 4
                   for c in comps):
                raise ValueError(f"JPEG sampling factors {[(c.h, c.v) for c in comps]} "
                                 "are not integer ratios")
            frame = (width, height, comps, hmax, vmax)
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack_from(">H", seg, 0)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            if blocks is not None:
                raise ValueError("a JPEG of more than one scan is not supported")
            width, height, comps, hmax, vmax = frame
            if len(comps) == 3:
                ids = tuple(c.ident for c in comps)
                if (adobe and adobe_transform == 0) or (
                        not jfif and not adobe and ids == (82, 71, 66)):
                    raise ValueError("an RGB-coded JPEG is not supported (YCbCr only)")
            ns = seg[0]
            by_id = {c.ident: k for k, c in enumerate(comps)}
            order = [by_id.get(seg[1 + 2 * k]) for k in range(ns)]
            if ns != len(comps) or sorted(o for o in order if o is not None) != \
                    list(range(len(comps))):
                raise ValueError("a JPEG of more than one scan is not supported")
            tables = [(seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15) for k in range(ns)]
            if ns == 1:  # non-interleaved: one block an MCU over the component's own grid
                c = comps[0]
                bw = _ceil(_ceil(width * c.h, hmax), 8)
                bh = _ceil(_ceil(height * c.v, vmax), 8)
                grid = [(bh, bw)]
                mcus = (bw, bh)
                rows = [(1, 1)]
            else:
                mx, my = _ceil(width, 8 * hmax), _ceil(height, 8 * vmax)
                grid = [(my * c.v, mx * c.h) for c in comps]
                mcus = (mx, my)
                rows = [(c.h, c.v) for c in comps]
            offsets = np.cumsum([0] + [a * b for a, b in grid])
            comp = np.zeros((ns, 6), np.int32)
            for k, o in enumerate(order):
                td, ta = tables[k]
                if td > 3 or ta > 3 or not counts[td].any() or not counts[4 + ta].any():
                    raise ValueError("JPEG scan refers to an undefined Huffman table")
                comp[k] = (*rows[o], td, ta, grid[o][1], offsets[o])
            if seg[1 + 2 * ns] != 0 or seg[2 + 2 * ns] != 63 or seg[3 + 2 * ns] != 0:
                raise ValueError("a JPEG scan with spectral selection or successive "
                                 "approximation is not supported (progressive)")
            out = np.zeros((int(offsets[-1]), 64), np.int16)
            scan = np.ascontiguousarray(buf[pos:])
            end = native.codec().jpeg_decode_scan(
                scan.ctypes.data, len(scan), ns, comp.ctypes.data, mcus[0], mcus[1], restart,
                counts.ctypes.data, vals.ctypes.data, out.ctypes.data)
            if end < 0:
                raise ValueError(f"corrupt JPEG entropy-coded data (code {end})")
            pos += int(end)
            blocks = [out[offsets[k]:offsets[k + 1]].reshape(*grid[k], 64)
                      for k in range(len(comps))]
    if blocks is None:
        raise ValueError("JPEG stream without a scan")
    width, height, comps, _, _ = frame
    missing = {c.tq for c in comps} - set(qtables)
    if missing:
        raise ValueError(f"JPEG refers to undefined quantisation tables {sorted(missing)}")
    return Coefficients(width, height, comps, qtables, blocks)


# ---------------------------------------------------------------------------
# Reconstruction: integer tensor ops on any device
# ---------------------------------------------------------------------------


def _idct_1d(s):
    """One 1-D pass of jidctint.c's islow IDCT (CONST_BITS 13) on eight
    int64 tensors, before its descale."""
    z1 = (s[2] + s[6]) * 4433
    tmp2 = z1 + s[6] * -15137
    tmp3 = z1 + s[2] * 6270
    tmp0 = (s[0] + s[4]) * 8192
    tmp1 = (s[0] - s[4]) * 8192
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow(coef: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] dequantised coefficients (natural order) -> [..., 8, 8]
    samples 0..255 (int64): columns first with PASS1_BITS 2, then rows,
    each DESCALE a rounding arithmetic shift; the result clamps to 0..255
    as libjpeg-turbo's SIMD islow IDCT saturates."""
    x = coef.to(torch.int64)
    ws = torch.stack([(v + (1 << 10)) >> 11 for v in _idct_1d(x.unbind(-2))], dim=-2)
    out = torch.stack([(v + (1 << 17)) >> 18 for v in _idct_1d(ws.unbind(-1))], dim=-1)
    return (out + 128).clamp_(0, 255)


def _neighbours(p: torch.Tensor, dim: int):
    """p's previous and next rows (dim 0) or columns (dim 1), the edge repeated."""
    n = p.shape[dim]
    prev = torch.cat([p.narrow(dim, 0, 1), p.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([p.narrow(dim, 1, n - 1), p.narrow(dim, n - 1, 1)], dim)
    return prev, nxt


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    shape = list(a.shape)
    shape[dim] *= 2
    return torch.stack([a, b], dim + 1).reshape(shape)


def upsample(p: torch.Tensor, fh: int, fv: int) -> torch.Tensor:
    """Upsample a [h, w] component plane (int64, cropped to its own
    downsampled size) by (fh, fv) as libjpeg-turbo does with fancy
    upsampling on: the triangle filters of jdsample.c for (2, 1) and (2, 2)
    on planes wider than 2, and for (1, 2); replication otherwise. Edge
    rows and columns are repeated, as jdmainct.c's context rows are."""
    if (fh, fv) == (1, 1):
        return p
    w = p.shape[1]
    if (fh, fv) == (2, 1) and w > 2:
        left, right = _neighbours(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1)
    if (fh, fv) == (1, 2):
        up, down = _neighbours(p, 0)
        return _interleave((3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2, 0)
    if (fh, fv) == (2, 2) and w > 2:
        up, down = _neighbours(p, 0)
        cols = _interleave(3 * p + up, 3 * p + down, 0)
        left, right = _neighbours(cols, 1)
        return _interleave((3 * cols + left + 8) >> 4, (3 * cols + right + 7) >> 4, 1)
    return p.repeat_interleave(fv, 0).repeat_interleave(fh, 1)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


_K = np.arange(256, dtype=np.int64) - 128
# jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)
_YCC_TABLES = np.stack([
    (_fix(1.40200) * _K + 32768) >> 16,   # Cr -> R
    (_fix(1.77200) * _K + 32768) >> 16,   # Cb -> B
    -_fix(0.71414) * _K,                  # Cr -> G, scaled
    -_fix(0.34414) * _K + 32768,          # Cb -> G, scaled, with ONE_HALF
])


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c's ycc_rgb_convert on int64 planes -> [H, W, 3] uint8 RGB."""
    t = torch.as_tensor(_YCC_TABLES, device=y.device)
    r = y + t[0][cr]
    g = y + ((t[3][cb] + t[2][cr]) >> 16)
    b = y + t[1][cb]
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


def reconstruct(coefs: Coefficients, device) -> torch.Tensor:
    """Dequantise, IDCT, upsample and colour-convert on `device`: [H, W, 3]
    uint8 RGB (a grayscale stream gives three equal channels, as
    IMREAD_COLOR does)."""
    device = resolve_device(device)
    hmax = max(c.h for c in coefs.components)
    vmax = max(c.v for c in coefs.components)
    planes = []
    for comp, blocks in zip(coefs.components, coefs.blocks):
        q = torch.as_tensor(coefs.qtables[comp.tq], device=device)
        x = torch.as_tensor(blocks, device=device).to(torch.int32) * q
        by, bx = blocks.shape[:2]
        px = idct_islow(x.reshape(by, bx, 8, 8)).permute(0, 2, 1, 3).reshape(by * 8, bx * 8)
        ch = _ceil(coefs.height * comp.v, vmax)
        cw = _ceil(coefs.width * comp.h, hmax)
        up = upsample(px[:ch, :cw], hmax // comp.h, vmax // comp.v)
        planes.append(up[:coefs.height, :coefs.width])
    if len(planes) == 1:
        return planes[0].to(torch.uint8)[..., None].expand(-1, -1, 3).contiguous()
    return ycc_to_rgb(*planes)


def decode(data: bytes, device="cuda") -> np.ndarray:
    """A baseline JPEG -> [H, W, 3] uint8 RGB on the host, equal to
    cv2.imdecode(data, IMREAD_COLOR)[..., ::-1]; the reconstruction runs on
    `device`."""
    return reconstruct(entropy_decode(data), device).cpu().numpy()


# ---------------------------------------------------------------------------
# Encoder (test support for the bag writer)
# ---------------------------------------------------------------------------

# T.81 Annex K.1, natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full((8, 8), 99)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]
_Q_CHROMA = _Q_CHROMA.reshape(64)


def _ac_symbols(head: list[int]) -> list[int]:
    """An Annex K.3 AC table's symbols: its irregular head, then every other
    (run, size) symbol in ascending order."""
    every = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
    return head + sorted(set(every) - set(head))


# T.81 Annex K.3: (counts of code lengths 1..16, symbols)
_HUFF = {
    "dc_luma": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    "dc_chroma": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    "ac_luma": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_symbols([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13,
        0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42,
        0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82])),
    "ac_chroma": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_symbols([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51,
        0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1,
        0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24,
        0x34, 0xE1, 0x25, 0xF1])),
}


def quality_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """IJG quality scaling (jcparam.c) of the Annex K tables, natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.int32)
                 for t in (_Q_LUMA, _Q_CHROMA))


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    d[0] /= np.sqrt(2.0)
    return d  # orthonormal DCT-II: the JPEG FDCT of T.81 A.3.3


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def encode(rgb: np.ndarray, quality: int = 80) -> bytes:
    """[H, W, 3] uint8 RGB -> a baseline 4:2:0 JFIF JPEG (float FDCT,
    rounding quantisation, Huffman coding in C++)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    f = rgb.astype(np.float64)
    ycc = np.stack([
        0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
        -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128.0,
        0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128.0], 0)
    mx, my = _ceil(w, 16), _ceil(h, 16)
    ycc = np.pad(ycc, ((0, 0), (0, my * 16 - h), (0, mx * 16 - w)), mode="edge")
    chroma = ycc[1:].reshape(2, my * 8, 2, mx * 8, 2).mean(axis=(2, 4))
    ql, qc = quality_tables(quality)
    d = _dct_matrix()

    def fdct(plane, q):
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        blk = (plane - 128.0).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        c = d @ blk @ d.T
        return np.round(c / q.reshape(8, 8)).astype(np.int16).reshape(bh * bw, 64)

    coefs = np.concatenate([fdct(ycc[0], ql), fdct(chroma[0], qc), fdct(chroma[1], qc)])
    ny, nc = my * 2 * mx * 2, my * mx
    comp = np.array([(2, 2, 0, 0, mx * 2, 0), (1, 1, 1, 1, mx, ny),
                     (1, 1, 1, 1, mx, ny + nc)], np.int32)
    counts = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    for slot, name in ((0, "dc_luma"), (1, "dc_chroma"), (4, "ac_luma"), (5, "ac_chroma")):
        counts[slot] = _HUFF[name][0]
        vals[slot, :len(_HUFF[name][1])] = _HUFF[name][1]
    cap = coefs.size * 4 + 1024
    out = np.zeros(cap, np.uint8)
    n = native.codec().jpeg_encode_scan(coefs.ctypes.data, 3, comp.ctypes.data, mx, my,
                                        counts.ctypes.data, vals.ctypes.data,
                                        out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"JPEG entropy coding failed (code {n})")
    dqt = b"".join(bytes([i]) + t[_ZIGZAG].astype(np.uint8).tobytes()
                   for i, t in enumerate((ql, qc)))
    dht = b"".join(bytes([cls << 4 | th]) + bytes(_HUFF[name][0]) + bytes(_HUFF[name][1])
                   for cls, th, name in ((0, 0, "dc_luma"), (0, 1, "dc_chroma"),
                                         (1, 0, "ac_luma"), (1, 1, "ac_chroma")))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8" + _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + _segment(0xDB, dqt) + _segment(0xC0, sof) + _segment(0xC4, dht)
            + _segment(0xDA, sos) + out[:n].tobytes() + b"\xff\xd9")
