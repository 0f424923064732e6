"""The port's resize and undistortion (`frontend/imgproc.py`) against
OpenCV, bit-equal, with the distortion of configs/datasets/r3live.yaml and
ntu.yaml; then the JAX and the port's LivoFrontend on one small dolly
stream at image_resize_ratio 0.5 with r3live's distortion: the images that
reach the measurement sync are equal, and frames and poses agree to 1e-9
as in tests/test_torch_livo.py."""

import pathlib

import cv2
import numpy as np
import pytest
import torch
import yaml

from gslivm_tpu.config import Config as JConfig
from gslivm_tpu.config import GpParams as JGp
from gslivm_tpu.config import IcpOptions as JIcp
from gslivm_tpu.config import OdometryOptions as JOdom
from gslivm_tpu.frontend.livo import LivoFrontend as JFrontend
from gslivm_tpu_torch.config import Config, GpParams, IcpOptions, OdometryOptions
from gslivm_tpu_torch.frontend import imgproc, synthetic
from gslivm_tpu_torch.frontend.livo import LivoFrontend

torch.set_num_threads(1)

DATASETS = pathlib.Path(__file__).resolve().parents[1] / "configs" / "datasets"


def _camera(name: str, ratio: float):
    """A dataset's K scaled by `ratio` (as LivoFrontend scales it), its five
    distortion coefficients and its scaled size."""
    ds = yaml.safe_load((DATASETS / f"{name}.yaml").read_text())["dataset"]
    K = np.array([[ds["fx"] * ratio, 0, ds["cx"] * ratio],
                  [0, ds["fy"] * ratio, ds["cy"] * ratio], [0, 0, 1.0]])
    dist = [ds[k] for k in ("dist_k1", "dist_k2", "dist_p1", "dist_p2", "dist_k3")]
    return K, dist, (int(ds["image_width"] * ratio), int(ds["image_height"] * ratio))


@pytest.mark.parametrize("src,dst", [
    ((128, 96), (64, 48)),     # exactly half: OpenCV's 2x2 area path
    ((1280, 1024), (640, 512)),
    ((77, 53), (38, 26)),      # half of an odd size: the bilinear path
    ((128, 96), (77, 53)),     # non-integer ratios
    ((128, 96), (44, 33)),
    ((96, 64), (200, 150)),    # upscaling: rows past the edge keep their weights
    ((7, 5), (9, 2)),
])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_bit_equal_to_opencv(src, dst, channels):
    rng = np.random.default_rng(src[0] * dst[0] + channels)
    img = rng.integers(0, 256, (src[1], src[0], channels), dtype=np.uint8)
    want = cv2.resize(img, dst).reshape(dst[1], dst[0], channels)
    got = imgproc.resize_linear(torch.from_numpy(img), dst)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["r3live", "ntu", "fastlivo"])
@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_undistort_map_and_remap_bit_equal_to_opencv(name, ratio):
    K, dist, size = _camera(name, ratio)
    m1, m2 = cv2.initUndistortRectifyMap(K, np.asarray(dist), None, K, size, cv2.CV_16SC2)
    xy, fxy = imgproc.undistort_rectify_map(K, dist, size)
    assert xy.dtype == np.int16 and fxy.dtype == np.uint16
    np.testing.assert_array_equal(xy, m1)
    np.testing.assert_array_equal(fxy, m2)
    rng = np.random.default_rng(int(ratio * 10))
    img = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    got = imgproc.remap_linear(torch.from_numpy(img), torch.from_numpy(xy),
                               torch.from_numpy(fxy.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), cv2.remap(img, m1, m2, cv2.INTER_LINEAR))


def test_remap_reads_zero_outside_the_image():
    """Taps left of, right of, above and below the image, and maps that
    leave it entirely: BORDER_CONSTANT 0, tap by tap."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    m1 = rng.integers(-3, 54, (30, 35, 2)).astype(np.int16)
    m1[0, :5] = (-40, 7)
    m2 = rng.integers(0, 1024, (30, 35)).astype(np.uint16)
    got = imgproc.remap_linear(torch.from_numpy(img), torch.from_numpy(m1),
                               torch.from_numpy(m2.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), cv2.remap(img, m1, m2, cv2.INTER_LINEAR))


W, H, POINTS, SWEEPS = 192, 128, 1200, 8
ODOM = dict(init_num_frames=2, voxel_size=0.05, sample_voxel_size=0.6,
            init_voxel_size=0.05, init_sample_voxel_size=0.6)
ICP = dict(min_number_neighbors=8, max_num_residuals=300, size_voxel_map=0.5, num_iters_icp=6)


def _feed(fe, stream):
    """Every sweep into the front end; the images the sync received and the
    position after each sweep."""
    seen, push = [], fe.sync.push_image
    fe.sync.push_image = lambda s: (seen.append(s.image.copy()), push(s))[1]
    for s in stream.init_imu:
        fe.push_imu(*s)
    positions = []
    for sw in stream.sweeps:
        fe.push_lidar(sw.lidar)
        for s in sw.imu:
            fe.push_imu(*s)
        fe.push_image(sw.image_time, sw.image)
        positions.append(fe.pose[1])
    return seen, np.asarray(positions)


def test_livo_frontend_resize_and_undistort_match_jax():
    stream = synthetic.dolly_stream(SWEEPS, W, H, POINTS)
    _, dist, _ = _camera("r3live", 1.0)
    kw = dict(fx=stream.fx, fy=stream.fy, cx=stream.cx, cy=stream.cy, width=W, height=H,
              image_resize_ratio=0.5, distortion=dist)
    jfe = JFrontend(config=JConfig(gp=JGp(grid=0.5), odometry=JOdom(**ODOM), icp=JIcp(**ICP)),
                    **kw)
    tfe = LivoFrontend(config=Config(gp=GpParams(grid=0.5), odometry=OdometryOptions(**ODOM),
                                     icp=IcpOptions(**ICP)), device="cpu", **kw)
    (jimg, jpos), (timg, tpos) = _feed(jfe, stream), _feed(tfe, stream)
    assert len(timg) == len(jimg) == SWEEPS
    for a, b in zip(jimg, timg):
        assert b.shape == (H // 2, W // 2, 3) and b.dtype == np.uint8
        np.testing.assert_array_equal(b, a)
    assert tfe.stage_seconds["intake"] > 0
    np.testing.assert_allclose(tfe.K, jfe.K, rtol=0, atol=0)
    assert np.abs(tpos - jpos).max() <= 1e-9
    jf, tf = jfe.pop_frames(), tfe.pop_frames()
    assert len(jf) == len(tf) >= SWEEPS - 2
    for a, b in zip(jf, tf):
        assert np.abs(a.points_world - b.points_world).max() <= 1e-9
        np.testing.assert_array_equal(a.image, b.image)
        for f in ("R_cw", "t_cw", "K"):
            assert np.abs(np.asarray(getattr(a.camera, f)) - getattr(b.camera, f).numpy()).max() \
                <= 1e-9, f
        assert (b.camera.width, b.camera.height) == (W // 2, H // 2)


def test_distorted_render_is_undone_by_the_undistortion_map():
    """synthetic.render_image's distorted camera and the undistortion map
    are inverses: the normalised coordinates round-trip through OpenCV's
    forward model to 1e-12, and remapping the distorted render gives the
    pinhole render, closer than the distorted render itself is."""
    from gslivm_tpu_torch.models.cameras import make_camera

    _, dist, _ = _camera("r3live", 0.1)
    x0, y0 = np.meshgrid(np.linspace(-0.7, 0.7, 15), np.linspace(-0.6, 0.6, 13))
    k1, k2, p1, p2, k3 = dist
    r2 = x0 * x0 + y0 * y0
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x0 * kr + 2 * p1 * x0 * y0 + p2 * (r2 + 2 * x0 * x0)
    yd = y0 * kr + p1 * (r2 + 2 * y0 * y0) + 2 * p2 * x0 * y0
    x, y = synthetic.undistort_normalized(xd, yd, dist)
    assert max(np.abs(x - x0).max(), np.abs(y - y0).max()) <= 1e-12

    w, h = 128, 96
    cam = make_camera(np.eye(3), synthetic.dolly_position(0.3), w, h, fovx=1.2,
                      fovy=1.2 * h / w, device="cpu")
    pinhole = synthetic.render_image(cam, synthetic.default_scene())
    distorted = synthetic.render_image(cam, synthetic.default_scene(), distortion=dist)
    Kc = np.array([[float(cam.fx), 0, (w - 1) / 2], [0, float(cam.fy), (h - 1) / 2], [0, 0, 1]])
    xy, fxy = imgproc.undistort_rectify_map(Kc, dist, (w, h))
    back = imgproc.remap_linear(torch.from_numpy(distorted), torch.from_numpy(xy),
                                torch.from_numpy(fxy.astype(np.int32))).numpy()
    inner = (slice(8, -8), slice(8, -8))  # away from the border the map leaves
    err = np.abs(back[inner].astype(int) - pinhole[inner]).mean()
    assert err < 0.5 * np.abs(distorted[inner].astype(int) - pinhole[inner]).mean(), err
