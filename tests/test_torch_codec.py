"""The port's camera-intake decoders against OpenCV, through the JAX
package's `decode_compressed_image` (cv2.imdecode with IMREAD_COLOR, then
BGR->RGB) on the same sensor_msgs/CompressedImage bytes: bit-equal.

JPEG: cv2.imencode's baseline streams at quality 50/80/95/100 in 4:4:4,
4:2:2, 4:2:0 and 4:4:0 (and 4:1:1, box-upsampled), grayscale, restart
intervals and ragged sizes up to 128x96; the modes the decoder refuses
(progressive, arithmetic-coded, 12-bit, Exif orientation, two scans) raise
a ValueError that names them. PNG: 8-bit gray, RGB and RGBA with each of
the five row filters, and 16-bit refused. The port's encoder: OpenCV and
the port decode its bytes identically, and its PSNR against the source is
within 0.5 dB of cv2.imencode's at the same quality. Reconstruction runs
on the CPU here; tests/test_torch_cuda.py holds the card's against it."""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

import test_rosbag as jw  # the JAX package's bag writers
from gslivm_tpu.frontend import rosbag as jrb
from gslivm_tpu_torch.frontend import jpeg, native, png
from gslivm_tpu_torch.frontend import rosbag as trb

torch.set_num_threads(1)

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _image(h, w, seed=0, channels=3):
    """Smooth colour waves plus noise: every AC band and the chroma carry
    energy, and the IDCT's clamps are hit."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([128 + 130 * np.sin(xx / 6.0 + c) * np.cos(yy / 5.0 - c)
                    for c in range(channels)], -1)
    return np.clip(img + rng.normal(0, 18, img.shape), 0, 255).astype(np.uint8)


def _message(data: bytes, fmt: bytes = b"bgr8; jpeg compressed bgr8", t: float = 2.5) -> bytes:
    return (jw._stamp_header(t) + struct.pack("<I", len(fmt)) + fmt
            + struct.pack("<I", len(data)) + data)


def _same_as_jax(data: bytes):
    """Both decoders on one CompressedImage; returns the port's image."""
    raw = _message(data)
    a = jrb.decode_compressed_image(raw, 2.5)
    b = trb.decode_compressed_image(raw, 2.5, device="cpu")
    assert a.t == b.t
    assert b.image.dtype == np.uint8 and b.image.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(b.image, a.image)
    return b.image


def _encode(img, quality=80, sampling="420", **extra):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              SAMPLING[sampling]]
    for k, v in extra.items():
        params += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("quality", [50, 80, 95, 100])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
def test_jpeg_bit_equal_to_opencv(quality, sampling):
    for h, w in ((96, 128), (53, 77)):
        _same_as_jax(_encode(_image(h, w, seed=quality), quality, sampling))


@pytest.mark.parametrize("h,w", [(1, 1), (3, 17), (40, 2), (9, 33), (96, 121)])
@pytest.mark.parametrize("sampling", ["420", "422", "411"])
def test_jpeg_ragged_sizes_and_box_upsampling(h, w, sampling):
    """Sizes that are no multiple of the MCU, planes of 1 or 2 columns (the
    box upsampler), and 4:1:1's integer replication."""
    _same_as_jax(_encode(_image(h, w, seed=h * w), 90, sampling))


@pytest.mark.parametrize("interval", [1, 3, 7])
def test_jpeg_restart_intervals(interval):
    data = _encode(_image(96, 128, seed=interval), 80, "420", rst_interval=interval)
    rst = sum(data.count(bytes([0xFF, 0xD0 + k])) for k in range(8))
    assert rst == -(-48 // interval) - 1  # 8 x 6 MCUs of 16 x 16
    _same_as_jax(data)


def test_jpeg_grayscale_gives_three_equal_channels():
    gray = _image(53, 77, seed=4, channels=1)[..., 0]
    ok, buf = cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_QUALITY, 85])
    out = _same_as_jax(buf.tobytes())
    assert out.shape == (53, 77, 3)
    assert (out == out[..., :1]).all()
    coefs = jpeg.entropy_decode(buf.tobytes())
    assert len(coefs.components) == 1


def _with_app1_orientation(data: bytes, orientation: int) -> bytes:
    ifd = struct.pack("<H", 1) + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) \
        + struct.pack("<I", 0)
    tiff = b"II*\x00" + struct.pack("<I", 8) + ifd
    seg = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + data[2:]


def _patched_sof(data: bytes, marker: int | None = None, precision: int | None = None) -> bytes:
    b = bytearray(data)
    i = b.index(b"\xff\xc0")
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    return bytes(b)


def _two_scans(data: bytes) -> bytes:
    i = data.index(b"\xff\xda")
    j = data.rindex(b"\xff\xd9")
    return data[:j] + data[i:j] + data[j:]


@pytest.mark.parametrize("mode,make", [
    ("progressive", lambda d, img: _encode(img, 80, "420", progressive=1)),
    ("arithmetic-coded", lambda d, img: _patched_sof(d, marker=0xC9)),
    ("lossless", lambda d, img: _patched_sof(d, marker=0xC3)),
    ("12-bit", lambda d, img: _patched_sof(d, precision=12)),
    ("orientation 6", lambda d, img: _with_app1_orientation(d, 6)),
    ("more than one scan", lambda d, img: _two_scans(d)),
])
def test_unsupported_jpeg_modes_raise(mode, make):
    img = _image(32, 48, seed=5)
    data = _encode(img, 80, "420")
    bad = make(data, img)
    with pytest.raises(ValueError, match=mode):
        trb.decode_compressed_image(_message(bad), 1.0, device="cpu")


def test_exif_orientation_1_decodes():
    data = _with_app1_orientation(_encode(_image(32, 48, seed=6)), 1)
    _same_as_jax(data)


def _png_row_filters(data: bytes, h: int, w: int, c: int) -> set:
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[y * (w * c + 1)] for y in range(h)}


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filt", ["NONE", "SUB", "UP", "AVG", "PAETH"])
def test_png_bit_equal_to_opencv(channels, filt):
    img = _image(37, 53, seed=channels, channels=channels)
    img[10:20, 5:30] = 200  # flat runs next to noise
    ok, buf = cv2.imencode(".png", img if channels > 1 else img[..., 0],
                           [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{filt}")])
    assert ok
    data = buf.tobytes()
    code = ["NONE", "SUB", "UP", "AVG", "PAETH"].index(filt)
    assert _png_row_filters(data, 37, 53, channels) == {code}
    out = _same_as_jax(data)
    raw = png.decode_raw(data)
    assert raw.shape == (37, 53, channels)
    want = img[..., [2, 1, 0, 3][:channels]] if channels > 1 else img  # cv2 wrote BGR(A)
    np.testing.assert_array_equal(raw, want)
    assert out.shape == (37, 53, 3)


def test_png_16_bit_and_bad_crc_raise():
    ok, buf = cv2.imencode(".png", (_image(8, 9, seed=7).astype(np.uint16) * 257))
    with pytest.raises(ValueError, match="16-bit"):
        png.decode(buf.tobytes())
    ok, buf = cv2.imencode(".png", _image(8, 9, seed=7))
    bad = bytearray(buf.tobytes())
    bad[-20] ^= 0xFF  # inside the last IDAT
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(bad))
    with pytest.raises(ValueError, match="unsupported compressed image format"):
        trb.decode_compressed_image(_message(b"GIF89a" + bytes(20)), 1.0, device="cpu")


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


@pytest.mark.parametrize("quality", [50, 80, 95])
def test_port_encoder_decodes_alike_and_matches_opencv_psnr(quality):
    img = _image(96, 128, seed=quality)
    raw = trb.encode_compressed_image(4.25, img, quality)
    a = jrb.decode_compressed_image(raw, 4.25)
    b = trb.decode_compressed_image(raw, 4.25, device="cpu")
    np.testing.assert_array_equal(a.image, b.image)
    ok, buf = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    ref = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]
    assert abs(_psnr(img, b.image) - _psnr(img, ref)) <= 0.5


def test_codec_library_is_built_by_hash_into_the_build_dir():
    path = native.library_path(native.CODEC_SRC, "libgslivm_codec")
    native.codec()
    assert path.exists() and path.parent == native.BUILD
    assert path.name.startswith("libgslivm_codec-") and path != native.library_path()
