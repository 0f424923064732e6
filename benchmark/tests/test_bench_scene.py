"""The generator: the same seed gives the same inputs, another seed other
samples of the same sizes; the closed paths meet themselves at the seam
in position, velocity and acceleration, so a stream replays cycle after
cycle; a sweep is thinned as the front end thins it."""

from __future__ import annotations


import numpy as np
import torch

from benchmark import scene

PATH = scene.Path((-0.8, -0.2, 0.0), (1.6, 0.0, 0.4), -8.0, 16.0, 0.6)
BIG_SEED = 2**31 + 123456789012


LIDAR = {"sweep_points": 2000, "point_filter_num": 4, "voxel_size": 0.1}


def test_frames_are_a_function_of_the_seed():
    a = scene.map_frames(PATH, 3, 32, 24, 21.4, 25.7, LIDAR, BIG_SEED, "cpu")
    b = scene.map_frames(PATH, 3, 32, 24, 21.4, 25.7, LIDAR, BIG_SEED, "cpu")
    c = scene.map_frames(PATH, 3, 32, 24, 21.4, 25.7, LIDAR, BIG_SEED + 1, "cpu")
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x.image, y.image) and np.array_equal(x.points, y.points)
        assert np.array_equal(x.image, z.image)  # the path does not depend on the seed
        assert not np.array_equal(x.points[:10], z.points[:10])


def test_the_path_is_periodic_to_the_second_derivative():
    T, h = PATH.period_s, 1e-3
    t = torch.tensor([0.0, T, 2 * T], dtype=torch.float64)
    c = PATH.center(t)
    v = (PATH.center(t + h) - PATH.center(t - h)) / (2 * h)
    a = (PATH.center(t + h) - 2 * c + PATH.center(t - h)) / (h * h)
    for x, tol in ((c, 1e-12), (v, 1e-9), (a, 1e-4)):
        assert torch.allclose(x[0], x[1], atol=tol) and torch.allclose(x[0], x[2], atol=tol)
    R = PATH.rotation(t)
    assert torch.allclose(R[0], R[1], atol=1e-12)
    assert float(a.abs().max()) > 1.0  # the dolly accelerates at the seam: the test has teeth


def test_a_sweep_is_thinned_as_the_front_end_thins_it():
    gen = scene.generator(BIG_SEED, "cpu")
    R = torch.eye(3, dtype=torch.float64)
    c = torch.tensor([0.0, -0.2, 0.0], dtype=torch.float64)
    pts = scene.sample_points(R, c, 0.7, 0.5, 4000, gen)
    kept = scene.thin(pts, R, c, 4, 0.1)
    every4 = pts[::4].numpy()
    # a subsequence of every 4th point, in order, one a voxel of the sensor's frame
    idx = [int(np.flatnonzero((every4 == k).all(1))[0]) for k in kept]
    assert idx == sorted(idx) and len(set(idx)) == len(idx)
    keys = {tuple(k) for k in np.floor((kept - c.numpy()) @ R.numpy() / 0.1).astype(int)}
    assert len(keys) == len(kept)
    every_key = {tuple(k) for k in np.floor((every4 - c.numpy()) / 0.1).astype(int)}
    assert keys == every_key
    assert np.array_equal(scene.thin(pts, R, c, 1, 0.0), pts.numpy())
