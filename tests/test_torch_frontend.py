"""Port parity of the host front end's numpy modules: so3, the ESKF, the
voxel map, the sensor filters and packetizer, and the odometry, each held
against its JAX-package twin on the same seeded inputs to 1e-12 (the port's
copies run the same float64 numpy; most results are bit-equal)."""

import numpy as np
import pytest
import torch

from gslivm_tpu.config import CommonOptions as JCommon
from gslivm_tpu.config import IcpOptions as JIcp
from gslivm_tpu.config import OdometryOptions as JOdom
from gslivm_tpu.frontend import eskf as jeskf
from gslivm_tpu.frontend import native as jnative
from gslivm_tpu.frontend import odometry as jodom
from gslivm_tpu.frontend import sensors as jsensors
from gslivm_tpu.frontend import so3 as jso3
from gslivm_tpu.frontend import voxelmap as jvox
from gslivm_tpu_torch.config import CommonOptions as TCommon
from gslivm_tpu_torch.config import IcpOptions as TIcp
from gslivm_tpu_torch.config import OdometryOptions as TOdom
from gslivm_tpu_torch.frontend import eskf as teskf
from gslivm_tpu_torch.frontend import native as tnative
from gslivm_tpu_torch.frontend import odometry as todom
from gslivm_tpu_torch.frontend import sensors as tsensors
from gslivm_tpu_torch.frontend import so3 as tso3
from gslivm_tpu_torch.frontend import synthetic
from gslivm_tpu_torch.frontend import voxelmap as tvox

torch.set_num_threads(1)

TOL = 1e-12


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= TOL * max(1.0, np.abs(a).max(initial=0.0))


_VECS = [np.array([0.3, -0.2, 0.5]), np.array([1e-9, 2e-9, -1e-9]),
         np.array([0.0, 0.0, 3.1415926]), np.array([-1.2, 0.4, 0.9])]


@pytest.mark.parametrize("name", ["skew", "so3_to_quat", "so3_to_rot", "inv_jright_so3",
                                  "derivative_s2"])
def test_so3_maps_of_a_vector(name):
    for v in _VECS:
        _close(getattr(tso3, name)(v), getattr(jso3, name)(v))


@pytest.mark.parametrize("name", ["quat_to_rot", "quat_normalize", "quat_conj", "quat_to_so3"])
def test_so3_maps_of_a_quaternion(name, rng):
    for _ in range(4):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        _close(getattr(tso3, name)(q), getattr(jso3, name)(q))


def test_so3_products_logs_and_slerp(rng):
    for _ in range(4):
        a, b = rng.normal(size=4), rng.normal(size=4)
        a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
        _close(tso3.quat_mul(a, b), jso3.quat_mul(a, b))
        _close(tso3.quat_slerp(a, b, 0.3), jso3.quat_slerp(a, b, 0.3))
        R = jso3.quat_to_rot(a)
        _close(tso3.rot_to_so3(R), jso3.rot_to_so3(R))
        u, w = rng.normal(size=3), rng.normal(size=3)
        u, w = u / np.linalg.norm(u), w / np.linalg.norm(w)
        _close(tso3.rot_between_unit_vectors(u, w), jso3.rot_between_unit_vectors(u, w))


def _eskf_state(e):
    return [e.p, e.q, e.v, e.ba, e.bg, e.g, e.covariance, e.noise, e.acc_0, e.gyr_0,
            e.mean_acc, e.mean_gyr, e.acc_cov, e.gyr_cov]


def test_eskf_init_predict_and_observe_pose(rng):
    """Static init from 60 samples (0.3 s), 40 predicts under a rotating,
    accelerating IMU, then observe_pose."""
    filters = [jeskf.Eskf(), teskf.Eskf()]
    g = np.array([0.0, 0.0, 9.81])
    for k in range(60):
        s = (0.005 * k, rng.normal(0, 1e-3, 3), g + rng.normal(0, 1e-2, 3))
        done = [f.try_init([s]) for f in filters]
        assert done[0] == done[1]
    assert all(f.initial_flag for f in filters)
    for _ in range(40):
        acc, gyr = g + rng.normal(0, 0.3, 3), rng.normal(0, 0.2, 3)
        for f in filters:
            f.predict(0.005, acc, gyr)
    q = jso3.so3_to_quat(np.array([0.01, -0.02, 0.03]))
    for f in filters:
        f.observe_pose(np.array([0.1, 0.2, -0.1]), q, 1e-3, 1e-4)
    for a, b in zip(*(_eskf_state(f) for f in filters)):
        _close(b, a)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_voxel_map_insert_knn_and_prune(native, rng):
    if native:
        if not (jnative.available() and tnative.available()):
            pytest.skip("no C++ compiler for the native voxel map")
        maps = [jnative.NativeVoxelMap(0.5, 10, 0.05), tnative.NativeVoxelMap(0.5, 10, 0.05)]
    else:
        maps = [jvox.VoxelMap(0.5, 10, 0.05), tvox.VoxelMap(0.5, 10, 0.05)]
    pts = rng.uniform(-3, 3, (3000, 3))
    for m in maps:
        m.add_points(pts)
    assert len(maps[0]) == len(maps[1]) > 0
    for q in rng.uniform(-2.5, 2.5, (10, 3)):
        _close(maps[1].search_neighbors(q, 1, 12), maps[0].search_neighbors(q, 1, 12))
    for m in maps:
        m.remove_far_voxels(np.zeros(3), 2.0)
    assert len(maps[0]) == len(maps[1])
    np.testing.assert_array_equal(tvox.grid_sample(pts, 0.3), jvox.grid_sample(pts, 0.3))


def test_port_native_library_is_built_outside_native():
    """The port names its library by a hash of source and flags under its
    own build directory, never next to the source."""
    if not tnative.available():
        pytest.skip("no C++ compiler for the native voxel map")
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.BUILD
    assert path.parent != tnative.SRC.parent


@pytest.mark.parametrize("lidar_type", ["livox", "velodyne", "ouster", "robosense", "pandar"])
def test_filter_sweep(lidar_type, rng):
    n = 500
    sweep = (0.0, rng.uniform(-20, 20, (n, 3)), rng.uniform(0, 0.12, n), rng.uniform(0, 1, n))
    sweep[1][:5] = 0.01  # inside the blind range
    a = jsensors.filter_sweep(jsensors.LidarSweep(*sweep), JCommon(), lidar_type)
    b = tsensors.filter_sweep(tsensors.LidarSweep(*sweep), TCommon(), lidar_type)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_measurement_sync_packets():
    """The dolly stream's sensors through both packetizers: the same
    packets (rendering and filler) with the same points, IMU and images."""
    stream = synthetic.dolly_stream(4, 48, 32, 300, seed=1)
    syncs = [jsensors.MeasurementSync(0.1), tsensors.MeasurementSync(0.1)]
    mods = [jsensors, tsensors]
    out = [[], []]
    for s in stream.init_imu:
        for sy, mod in zip(syncs, mods):
            sy.push_imu(mod.ImuSample(*s))
    for sw in stream.sweeps:
        for i, (sy, mod) in enumerate(zip(syncs, mods)):
            sy.push_sweep(mod.LidarSweep(*sw.lidar))
            for s in sw.imu:
                sy.push_imu(mod.ImuSample(*s))
            sy.push_image(mod.ImageSample(sw.image_time, sw.image))
            out[i] += sy.get()
    assert len(out[0]) == len(out[1]) >= 3
    for a, b in zip(*out):
        assert (a.time_sweep_begin, a.time_sweep_delta, a.time_image, a.rendering) == \
            (b.time_sweep_begin, b.time_sweep_delta, b.time_image, b.rendering)
        np.testing.assert_array_equal(b.points, a.points)
        np.testing.assert_array_equal(b.rel_time, a.rel_time)
        assert [s.t for s in a.imu] == [s.t for s in b.imu]
        assert (a.image is None) == (b.image is None)


def _odometry_run(mod_sensors, mod_odom, odom_opts, icp_opts, stream, use_native):
    """The odometry half of LivoFrontend._drain over the stream."""
    sync = mod_sensors.MeasurementSync(0.1)
    odo = mod_odom.Odometry(odom_opts, icp_opts, use_native=use_native)
    last_q, last_p = np.array([1.0, 0, 0, 0]), np.zeros(3)
    poses = []

    def drain():
        nonlocal last_q, last_p
        for m in sync.get():
            odo.begin_sweep_states()
            for s in m.imu:
                odo.add_imu(s.t, s.gyr, s.acc)
            q1, p1 = odo.eskf.q.copy(), odo.eskf.p.copy()
            if len(odo.imu_states) >= 2:
                pts = mod_odom.motion_compensate_imu(
                    m.points, m.rel_time, odo.imu_states, m.time_sweep_begin, q1, p1,
                    odo.R_il, odo.t_il)
            else:
                pts = mod_odom.motion_compensate_constant(
                    m.points, m.rel_time, last_q, last_p, q1, p1, odo.R_il, odo.t_il,
                    duration_s=m.time_sweep_delta)
            last_q, last_p = q1, p1
            res = odo.add_sweep(m.time_image, pts)
            poses.append((res.q_wxyz, res.t, res.points_world, res.success))

    for s in stream.init_imu:
        sync.push_imu(mod_sensors.ImuSample(*s))
        drain()
    for sw in stream.sweeps:
        sync.push_sweep(mod_sensors.filter_sweep(mod_sensors.LidarSweep(*sw.lidar)))
        drain()
        for s in sw.imu:
            sync.push_imu(mod_sensors.ImuSample(*s))
            drain()
        sync.push_image(mod_sensors.ImageSample(sw.image_time, sw.image))
        drain()
    return poses, odo


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_odometry_over_an_accelerating_stream(native):
    """Six sweeps of the e2e dolly (accelerating, then gliding) through the
    JAX odometry and the port's, IMU deskew and plane-ICP, with and
    without the native voxel map: every pose, world cloud and the final
    covariance to 1e-12."""
    if native and not (jnative.available() and tnative.available()):
        pytest.skip("no C++ compiler for the native voxel map")
    stream = synthetic.dolly_stream(6, 48, 32, 600, seed=2)
    kw = dict(init_num_frames=2, voxel_size=0.05, sample_voxel_size=0.6,
              init_voxel_size=0.05, init_sample_voxel_size=0.6)
    icp = dict(min_number_neighbors=8, max_num_residuals=300, size_voxel_map=0.5,
               num_iters_icp=6)
    jp, jo = _odometry_run(jsensors, jodom, JOdom(**kw), JIcp(**icp), stream, native)
    tp, to = _odometry_run(tsensors, todom, TOdom(**kw), TIcp(**icp), stream, native)
    assert type(to.vmap).__name__ == ("NativeVoxelMap" if native else "VoxelMap")
    assert len(jp) == len(tp) >= 5
    for a, b in zip(jp, tp):
        _close(b[0], a[0])
        _close(b[1], a[1])
        _close(b[2], a[2])
        assert a[3] == b[3]
    _close(to.eskf.covariance, jo.eskf.covariance)
    assert np.linalg.norm(tp[-1][1]) > 0.02  # it moved
