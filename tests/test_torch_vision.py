"""The port's image primitives (`gslivm_tpu_torch/frontend/vision.py`)
against the OpenCV calls they stand in for: the gray conversion bit for
bit, the pyramid and Scharr derivatives bit for bit, pyramidal LK within
0.1 px median on the JAX test's random-dot shift (0.5 px max there, where
every window has texture) and on two consecutive 640x512 room renders, and
the F and PnP RANSAC inlier masks equal to the true inliers and to
OpenCV's on correspondences with 20% gross outliers (F: OpenCV's, which
keeps its best minimal model unrefined, may drop a true inlier near the
threshold; the port's refits and keeps it)."""

import cv2
import numpy as np
import pytest
import torch

from gslivm_tpu_torch.frontend import synthetic, vision
from gslivm_tpu_torch.models.cameras import make_camera

torch.set_num_threads(1)

WIN = dict(winSize=(21, 21), maxLevel=3)  # the arguments of vio.py:268


def test_rgb_to_gray_is_opencv_for_every_colour():
    v = np.arange(256, dtype=np.uint8)
    r, g, b = np.meshgrid(v, v, v, indexing="ij")
    img = np.stack([r, g, b], -1).reshape(4096, 4096, 3)
    got = vision.rgb_to_gray(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("shape", [(64, 96), (65, 97), (120, 161)])
def test_pyramid_and_scharr_are_opencv(shape, rng):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    x = torch.from_numpy(img).to(torch.int32)
    np.testing.assert_array_equal(vision._pyr_down(x).numpy(), cv2.pyrDown(img))
    d = vision._scharr(x).numpy()
    for axis, (dx, dy) in enumerate(((1, 0), (0, 1))):
        ref = cv2.Scharr(img, cv2.CV_32F, dx, dy, borderType=cv2.BORDER_REFLECT_101)
        np.testing.assert_array_equal(d[..., axis], ref)


def _compare_lk(prev, nxt, pts):
    got, st = vision.lk_track(torch.from_numpy(prev), torch.from_numpy(nxt),
                              torch.from_numpy(pts))
    ref, st_ref, _ = cv2.calcOpticalFlowPyrLK(prev, nxt, pts, None, **WIN)
    st, st_ref = st.numpy(), st_ref.ravel().astype(bool)
    both = st & st_ref  # both kept it (untextured windows are lost by both)
    err = np.linalg.norm(got.numpy()[both] - ref.reshape(-1, 2)[both], axis=1)
    return (st == st_ref).mean(), err, both


def test_lk_follows_the_random_dot_shift(rng):
    """tests/test_frontend_vio.py:62-84's image: a blurred random-dot
    field rolled by (5, 3) px."""
    base = (rng.uniform(0, 255, (120, 160)) > 200).astype(np.uint8) * 255
    base = cv2.GaussianBlur(base, (5, 5), 1.0)
    shifted = np.roll(base, (3, 5), axis=(0, 1))
    pts = np.stack([rng.uniform(30, 130, 30), rng.uniform(30, 90, 30)], 1).astype(np.float32)
    agree, err, both = _compare_lk(base, shifted, pts)
    assert agree >= 0.95 and both.sum() >= 25
    assert np.median(err) <= 0.1 and err.max() <= 0.5


def test_lk_on_consecutive_room_renders(rng):
    """Two 640x512 renders of the synthetic room 1.5 cm apart (one sweep
    of the dolly), 300 points spread over the image."""
    planes = synthetic.default_scene()
    imgs = [vision.rgb_to_gray(torch.from_numpy(synthetic.render_image(
        make_camera(np.eye(3), [x, -0.2, 0.4], 640, 512, fovx=1.0, fovy=0.8, device="cpu"),
        planes))).numpy() for x in (-0.8, -0.785)]
    pts = np.stack([rng.uniform(0, 640, 300), rng.uniform(0, 512, 300)], 1).astype(np.float32)
    agree, err, both = _compare_lk(imgs[0], imgs[1], pts)
    assert agree >= 0.95 and both.sum() >= 100
    assert np.median(err) <= 0.1


def _two_view(rng, n=100, outliers=20, noise=0.3):
    """n points in a volume seen by two cameras; `outliers` of the second
    view's pixels moved by 30-80 px."""
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], 1)
    K = np.array([[400.0, 0, 320], [0, 400, 256], [0, 0, 1]])
    R, _ = cv2.Rodrigues(np.array([0.02, -0.05, 0.01]))
    t = np.array([0.3, 0.05, 0.1])

    def proj(P, R, t):
        pc = P @ R.T + t
        return pc[:, :2] / pc[:, 2:] * 400 + [320, 256]

    x1 = proj(X, np.eye(3), np.zeros(3)) + rng.normal(0, noise, (n, 2))
    x2 = proj(X, R, t) + rng.normal(0, noise, (n, 2))
    bad = rng.choice(n, outliers, replace=False)
    x2[bad] += rng.uniform(30, 80, (outliers, 2)) * rng.choice([-1, 1], (outliers, 2))
    truth = np.ones(n, bool)
    truth[bad] = False
    return X, K, R, t, x1, x2, truth


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fundamental_ransac_finds_the_inliers(seed):
    rng = np.random.default_rng(seed)
    _, _, _, _, x1, x2, truth = _two_view(rng)
    mask = vision.fundamental_ransac(torch.from_numpy(x1), torch.from_numpy(x2), 3.0, 0.99,
                                     generator=torch.Generator().manual_seed(seed))
    _, ref = cv2.findFundamentalMat(x1.astype(np.float32), x2.astype(np.float32),
                                    cv2.FM_RANSAC, 3.0, 0.99)
    np.testing.assert_array_equal(mask.numpy(), truth)
    # OpenCV keeps its best 7-point hypothesis unrefined, so it can drop a
    # true inlier near the threshold (seed 0: one of 80); it never takes an
    # outlier
    ref = ref.ravel() > 0
    assert not (ref & ~truth).any() and (ref == truth).mean() >= 0.98


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_finds_the_inliers_and_the_pose(seed):
    rng = np.random.default_rng(seed)
    X, K, R, t, _, x2, truth = _two_view(rng, noise=0.5)
    ok, R_est, t_est, mask = vision.pnp_ransac(
        torch.from_numpy(X), torch.from_numpy(x2), torch.from_numpy(K),
        reprojection_error=8.0, iterations=100, generator=torch.Generator().manual_seed(seed))
    ok_ref, _, _, inl = cv2.solvePnPRansac(X, x2, K, None, reprojectionError=8.0,
                                           iterationsCount=100)
    ref = np.zeros(len(X), bool)
    ref[inl.ravel()] = True
    assert ok and ok_ref
    np.testing.assert_array_equal(mask.numpy(), truth)
    np.testing.assert_array_equal(ref, truth)
    # a minimal sample's pose: within the pixel noise's reach
    assert np.abs(R_est.numpy() - R).max() < 0.02 and np.abs(t_est.numpy() - t).max() < 0.1


def test_pnp_ransac_on_a_plane_and_with_too_few_points(rng):
    """Grunert's P3P needs no depth spread: coplanar points give the pose;
    fewer than 4 points give no pose."""
    X, K, R, t, _, _, _ = _two_view(rng, outliers=0)
    X[:, 2] = 6.0
    pc = X @ R.T + t
    x = pc[:, :2] / pc[:, 2:] * 400 + [320, 256]
    ok, R_est, _, mask = vision.pnp_ransac(torch.from_numpy(X), torch.from_numpy(x),
                                           torch.from_numpy(K),
                                           generator=torch.Generator().manual_seed(0))
    assert ok and bool(mask.all()) and np.abs(R_est.numpy() - R).max() < 1e-3
    ok, _, _, mask = vision.pnp_ransac(torch.from_numpy(X[:3]), torch.from_numpy(x[:3]),
                                       torch.from_numpy(K))
    assert not ok and not bool(mask.any())
    assert vision.fundamental_ransac(torch.from_numpy(x[:7]), torch.from_numpy(x[:7])) is None


def test_ransac_is_deterministic_under_a_seeded_generator(rng):
    X, K, _, _, x1, x2, _ = _two_view(rng)
    runs = [vision.fundamental_ransac(torch.from_numpy(x1), torch.from_numpy(x2),
                                      generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
