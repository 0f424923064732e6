"""Port parity of the ROS-bag entry point: the port's bag reader and
decoders against the JAX package's on the same bytes (written with
tests/test_rosbag.py's writers: IMU, PointCloud2 with each vendor's time
field, Livox CustomMsg with its tag filter, raw images, compressed images,
poses, a bz2 chunk), the port's own writer read back by both, bag_export,
and run_bag on a mini bag on the CPU, whose poses equal the JAX front end's
fed the same records."""

import bz2
import os
import pathlib
import struct

import numpy as np
import pytest
import torch

import test_rosbag as jw  # the JAX package's bag writers
from gslivm_tpu.frontend import rosbag as jrb
from gslivm_tpu_torch.examples import run_bag
from gslivm_tpu_torch.frontend import rosbag as trb
from gslivm_tpu_torch.tools import bag_export
from gslivm_tpu_torch.utils.outputs import append_tum_pose

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _same(a, b):
    """Two decoded records are equal field by field (arrays bit-equal)."""
    assert type(a).__name__ == type(b).__name__
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype
        else:
            assert x == y


def _pose_msg(t, pos, quat):
    return jw._stamp_header(t) + struct.pack("<7d", *pos, *quat)


def _odom_msg(t, pos, quat):
    child = b"body"
    return (jw._stamp_header(t) + struct.pack("<I", len(child)) + child
            + struct.pack("<7d", *pos, *quat) + struct.pack("<36d", *([0.0] * 36)))


def _chunk(records: bytes) -> bytes:
    return jw._record({"op": bytes([0x05]), "compression": b"bz2",
                       "size": struct.pack("<I", len(records))}, bz2.compress(records))


def test_decoders_match_jax_on_the_same_bytes(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-5, 5, (30, 3)).astype(np.float32)
    times = np.linspace(0, 0.09, 30).astype(np.float32)
    img = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    pos, quat = [1.0, -2.0, 0.5], [0.0, 0.0, 0.6, 0.8]
    conns = [("/imu", "sensor_msgs/Imu"), ("/pc2", "sensor_msgs/PointCloud2"),
             ("/livox", "livox_ros_driver/CustomMsg"), ("/img", "sensor_msgs/Image"),
             ("/pose", "geometry_msgs/PoseStamped"), ("/odom", "nav_msgs/Odometry"),
             ("/other", "std_msgs/String")]
    recs = [jw._conn_record(i, t, d) for i, (t, d) in enumerate(conns)]
    inner = [
        jw._msg_record(0, 100.0, jw._imu_msg([0.1, 0.2, 0.3], [0, 0, 9.81], t=100.25)),
        jw._msg_record(1, 100.05, jw._pc2_msg(xyz, times)),
        jw._msg_record(2, 100.1, jw._livox_msg(xyz[:4].tolist(), [0, 1000, 2000, 3000],
                                               [0x10, 0x00, 0x20, 0x30])),
        jw._msg_record(3, 100.2, jw._image_msg(img)),
        jw._msg_record(4, 100.3, _pose_msg(100.3, pos, quat)),
        jw._msg_record(5, 100.4, _odom_msg(100.4, pos, quat)),
        jw._msg_record(6, 100.5, b"\x00\x00\x00\x00"),
    ]
    path = str(tmp_path / "all.bag")
    # the first messages plain, the rest inside a bz2 chunk
    jw._write_bag(path, recs + inner[:3] + [_chunk(b"".join(inner[3:]))])
    jm, tm = list(jrb.read_bag(path)), list(trb.read_bag(path))
    assert len(tm) == len(jm) == 7
    for a, b in zip(jm, tm):
        assert tuple(a) == tuple(b)
        ja, tb = jrb.decode(a), trb.decode(b)
        if ja is None:
            assert tb is None
        else:
            _same(ja, tb)
    assert trb.decode(tm[2]).xyz.shape[0] == 2  # the 0x20 and 0x30 returns dropped
    assert [m.topic for m in trb.read_bag(path, {"/imu", "/odom"})] == ["/imu", "/odom"]

    # each vendor's PointCloud2 time field, the configured type given or inferred
    for field, dt, vals, types in (
            ("t", 6, [0, 50_000_000, 90_000_000], ("ouster", "auto")),
            ("timestamp", 8, [2000.27, 2000.25, 2000.33], ("robosense", "pandar", "auto")),
            ("time", 7, [0.0, 0.04, 0.08], ("velodyne", "auto"))):
        raw = jw._pc2_msg_generic(xyz[:3].tolist(), vals, field, dt)
        for lt in types:
            _same(jrb.decode_pointcloud2(raw, 10.5, lidar_type=lt),
                  trb.decode_pointcloud2(raw, 10.5, lidar_type=lt))


@pytest.mark.parametrize("encoding", ["rgb8", "bgr8", "mono8"])
def test_raw_images_match_jax(encoding):
    """bgr8 is a channel flip (JAX: cv2.cvtColor); mono8 is repeated."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (7, 9, 1 if encoding == "mono8" else 3), dtype=np.uint8)
    h, w = img.shape[:2]
    data = img.tobytes()
    step = w * img.shape[2]
    raw = (jw._stamp_header(3.5) + struct.pack("<II", h, w)
           + struct.pack("<I", len(encoding)) + encoding.encode() + bytes([0])
           + struct.pack("<I", step) + struct.pack("<I", len(data)) + data)
    a, b = jrb.decode_image(raw, 3.5), trb.decode_image(raw, 3.5)
    _same(a, b)
    if encoding == "bgr8":
        np.testing.assert_array_equal(b.image, img[..., ::-1])


def test_compressed_image_needs_opencv(monkeypatch):
    """A PNG CompressedImage decodes without cv2 (unimportable here) to what
    JAX's decode gives through cv2.imdecode."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)
    ok, png = cv2.imencode(".png", img)
    assert ok
    fmt = b"png"
    raw = (jw._stamp_header(1.0) + struct.pack("<I", len(fmt)) + fmt
           + struct.pack("<I", len(png)) + png.tobytes())
    want = jrb.decode_compressed_image(raw, 1.0)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    _same(want, trb.decode_compressed_image(raw, 1.0))
    np.testing.assert_array_equal(want.image, img[..., ::-1])


def test_port_writer_reads_back_in_both_readers(tmp_path):
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-5, 5, (50, 3))
    rel = np.sort(rng.uniform(0, 0.09, 50))
    img = rng.integers(0, 256, (4, 6, 3), dtype=np.uint8)
    path = str(tmp_path / "w.bag")
    n = trb.write_bag(path, [
        ("/imu", "sensor_msgs/Imu", 5.125, trb.encode_imu(5.125, [0.1, 0, 0], [0, 0, 9.8])),
        ("/lidar", "livox_ros_driver/CustomMsg", 5.2, trb.encode_livox_custom(5.2, xyz, rel)),
        ("/cam", "sensor_msgs/Image", 5.295, trb.encode_image(5.295, img)),
    ])
    assert n == 3
    for ja, tb in zip(jrb.read_bag(path), trb.read_bag(path)):
        assert tuple(ja) == tuple(tb)
        _same(jrb.decode(ja), trb.decode(tb))
    imu, sweep, image = (trb.decode(m) for m in trb.read_bag(path))
    assert imu.t == pytest.approx(5.125, abs=1e-9)
    np.testing.assert_array_equal(sweep.xyz, xyz.astype(np.float32).astype(np.float64))
    np.testing.assert_allclose(sweep.rel_time, rel, atol=1e-9)
    np.testing.assert_array_equal(image.image, img)


def test_bag_export_matches_jax(tmp_path):
    from gslivm_tpu.tools import bag_export as jexport

    pos, quat = [1.0, -2.0, 0.5], [0.0, 0.0, 0.6, 0.8]
    img = np.random.default_rng(4).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    path = str(tmp_path / "gt.bag")
    jw._write_bag(path, [jw._conn_record(0, "/gt", "geometry_msgs/PoseStamped"),
                         jw._conn_record(1, "/cam", "sensor_msgs/Image"),
                         jw._msg_record(0, 1.0, _pose_msg(1.0, pos, quat)),
                         jw._msg_record(0, 1.1, _pose_msg(0.0, pos, quat)),
                         jw._msg_record(1, 1.2, jw._image_msg(img, 1.2))])
    for mod, name in ((jexport, "j"), (bag_export, "t")):
        assert mod.extract_poses(path, "/gt", str(tmp_path / f"{name}.txt")) == 2
        assert mod.extract_images(path, "/cam", str(tmp_path / name / "rgb")) == 1
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert (tmp_path / "t" / "rgb.txt").read_text().replace("t/", "") == \
        (tmp_path / "j" / "rgb.txt").read_text().replace("j/", "")
    assert sorted(os.listdir(tmp_path / "t" / "rgb")) == sorted(os.listdir(tmp_path / "j" / "rgb"))


def _mini_bag(tmp_path):
    """tests/test_rosbag.py's mini livox + IMU + image bag (4 sweeps,
    64x48) and its dataset yaml; returns (bag, yaml, records)."""
    from gslivm_tpu.frontend import synthetic

    rng = np.random.default_rng(0)
    planes = synthetic.default_scene()
    cam = synthetic.make_trajectory(3, 64, 48)[0]
    R_wc = np.asarray(cam.R_cw).T
    center = np.asarray(cam.cam_center)
    recs = [jw._conn_record(0, "/livox/imu", "sensor_msgs/Imu"),
            jw._conn_record(1, "/livox/lidar", "livox_ros_driver/CustomMsg"),
            jw._conn_record(2, "/cam", "sensor_msgs/Image")]
    g, t = [0, 0, 9.81], 1.0
    for _ in range(90):
        recs.append(jw._msg_record(0, t, jw._imu_msg([0, 0, 0], g, t)))
        t += 0.005
    for _ in range(4):
        pts_s = (synthetic.sample_surface_points(cam, planes, 4000, rng) - center) @ R_wc
        offs = np.linspace(0, 90e6, len(pts_s)).astype(np.uint64)
        recs.append(jw._msg_record(1, t, jw._livox_msg(pts_s.tolist(), offs.tolist(),
                                                       [0x10] * len(pts_s), t)))
        for j in range(20):
            recs.append(jw._msg_record(0, t + j * 0.005, jw._imu_msg([0, 0, 0], g, t + j * 0.005)))
        recs.append(jw._msg_record(2, t + 0.095,
                                   jw._image_msg(synthetic.render_image(cam, planes), t + 0.095)))
        t += 0.1
    bag = str(tmp_path / "mini.bag")
    jw._write_bag(bag, recs)
    ds = tmp_path / "ds.yaml"
    ds.write_text(f"""
dataset:
    lidar_topic: "/livox/lidar"
    imu_topic: "/livox/imu"
    image_topic: "/cam"
    lidar_type: livox
    image_width: 64
    image_height: 48
    image_resize_ratio: 1.0
    fx: {float(np.asarray(cam.fx))}
    fy: {float(np.asarray(cam.fy))}
    cx: 31.5
    cy: 23.5
    dist_k1: 0.0
    dist_k2: 0.0
    dist_p1: 0.0
    dist_p2: 0.0
    dist_k3: 0.0
    t_imu_lidar: "0,0,0"
    R_imu_lidar: "1,0,0,0,1,0,0,0,1"
    t_imu_camera: "0,0,0"
    R_imu_camera: "1,0,0,0,1,0,0,0,1"
gp:
    grid: 0.5
odometry:
    init_num_frames: 2
    voxel_size: 0.05
    sample_voxel_size: 0.6
    init_voxel_size: 0.05
    init_sample_voxel_size: 0.6
icp:
    min_number_neighbors: 8
    max_num_residuals: 300
    size_voxel_map: 0.5
    num_iters_icp: 6
""")
    return bag, str(ds)


def test_run_bag_on_the_cpu_matches_the_jax_front_end(tmp_path, capsys):
    from gslivm_tpu.config import load_config, load_yaml
    from gslivm_tpu.frontend.livo import LivoFrontend
    from gslivm_tpu.frontend.sensors import ImageSample, ImuSample, LidarSweep

    bag, ds = _mini_bag(tmp_path)
    common = str(ROOT / "configs" / "basic_common.yaml")
    out = tmp_path / "out"
    run_bag.main([bag, "--dataset", ds, "--common", common, "--out", str(out),
                  "--device", "cpu", "--backend", "naive", "--train-iters-per-frame", "2"])
    printed = capsys.readouterr().out
    assert "bag:" in printed and "pipeline:" in printed
    produced = set(os.listdir(out))
    assert {"map.ply", "rgb_map.pcd", "pose.txt", "log_time.txt", "training"} <= produced
    assert os.listdir(out / "training")

    # the JAX front end fed the same records by the JAX reader
    raw = load_yaml(ds)
    d = raw["dataset"]
    cfg = load_config(dataset_overrides={k: v for k, v in raw.items() if k != "dataset"},
                      common_overrides=load_yaml(common))
    fe = LivoFrontend(config=cfg, fx=d["fx"], fy=d["fy"], cx=d["cx"], cy=d["cy"],
                      width=d["image_width"], height=d["image_height"])
    want = tmp_path / "jax_pose.txt"
    for msg in jrb.read_bag(bag, {d["imu_topic"], d["lidar_topic"], d["image_topic"]}):
        rec = jrb.decode(msg, lidar_type=cfg.common.lidar_type)
        if isinstance(rec, ImuSample):
            fe.push_imu(rec.t, rec.gyr, rec.acc)
        elif isinstance(rec, LidarSweep):
            fe.push_lidar(rec)
        elif isinstance(rec, ImageSample):
            fe.push_image(rec.t, rec.image)
        for _ in fe.pop_frames():
            q, p = fe.pose
            append_tum_pose(str(want), msg.t, p, [q[1], q[2], q[3], q[0]])
    got = (out / "pose.txt").read_text()
    assert got == want.read_text()
    assert len(got.splitlines()) >= 2
