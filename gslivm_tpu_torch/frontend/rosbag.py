"""Dependency-free ROS1 bag reader, sensor message decoders and a small
writer (the port's own copy of gslivm_tpu/frontend/rosbag.py; numpy on the
host, as there).

The reference consumes its datasets (R3LIVE / FAST-LIVO / NTU VIRAL /
Botanic Garden, SURVEY §6) as rosbags played into ROS subscribers
(lioOptimization.cpp:742-850, cloudProcessing.cpp). The port reads the bag
files directly: the ROS1 bag v2.0 container (records, connection headers,
chunks stored plain or bz2; lz4 chunks need the lz4 package, imported when
one is met) and binary decoders for the messages the reference subscribes
to:

  - sensor_msgs/Imu            -> ImuSample (imuHandler)
  - sensor_msgs/PointCloud2    -> LidarSweep (velodyne/ouster/robosense/
                                   pandar paths of cloudProcessing.cpp, per-
                                   point time from 'time'/'t'/'timestamp')
  - livox_ros_driver/CustomMsg -> LidarSweep (livoxHandler,
                                   cloudProcessing.cpp:119-157, incl. the
                                   tag filter)
  - sensor_msgs/Image          -> ImageSample (rgb8, bgr8 by a channel
                                   flip, mono8)
  - sensor_msgs/CompressedImage -> ImageSample (r3live's and FAST-LIVO's
                                   image topics): JPEG through `jpeg`
                                   (entropy decoding in C++, reconstruction
                                   on `device`) and PNG through `png`, each
                                   equal to OpenCV's imdecode
  - geometry_msgs/PoseStamped, nav_msgs/Odometry -> PoseSample

`write_bag` and the `encode_*` functions write the messages the front end
reads (IMU, Livox CustomMsg, raw Image, JPEG CompressedImage) into an
uncompressed v2.0 bag, for a recorded run of a synthetic stream.
"""

from __future__ import annotations

import bz2
import struct
from typing import Iterable, Iterator, NamedTuple

import numpy as np

from . import jpeg, png
from .sensors import ImageSample, ImuSample, LidarSweep


def _read_header(data: bytes) -> dict:
    """Parse a record/connection header: [len][name=value]*."""
    fields = {}
    pos = 0
    while pos < len(data):
        (flen,) = struct.unpack_from("<I", data, pos)
        pos += 4
        item = data[pos:pos + flen]
        pos += flen
        eq = item.index(b"=")
        fields[item[:eq].decode()] = item[eq + 1:]
    return fields


class BagMessage(NamedTuple):
    topic: str
    datatype: str
    t: float
    raw: bytes


def _decompress(compression: str, data: bytes) -> bytes:
    if compression == "bz2":
        return bz2.decompress(data)
    if compression == "lz4":
        try:
            import lz4.frame  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError("lz4-compressed bag needs lz4") from e
        return lz4.frame.decompress(data)
    return data


def read_bag(path: str, topics: set[str] | None = None) -> Iterator[BagMessage]:
    """Stream messages (in storage order) from a ROS1 v2.0 bag."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a ROS1 v2.0 bag: {magic!r}")
        connections: dict[int, tuple[str, str]] = {}

        def parse_records(buf: bytes):
            pos = 0
            while pos + 8 <= len(buf):
                (hlen,) = struct.unpack_from("<I", buf, pos)
                header = _read_header(buf[pos + 4:pos + 4 + hlen])
                pos += 4 + hlen
                (dlen,) = struct.unpack_from("<I", buf, pos)
                data = buf[pos + 4:pos + 4 + dlen]
                pos += 4 + dlen
                yield header, data

        def handle(header, data):
            op = header["op"][0]
            if op == 0x07:  # connection
                conn = struct.unpack("<I", header["conn"])[0]
                ch = _read_header(data)
                connections[conn] = (header["topic"].decode(), ch["type"].decode())
            elif op == 0x02:  # message data
                conn = struct.unpack("<I", header["conn"])[0]
                secs, nsecs = struct.unpack("<II", header["time"])
                topic, dtype = connections.get(conn, ("?", "?"))
                if topics is None or topic in topics:
                    return BagMessage(topic, dtype, secs + nsecs * 1e-9, data)
            return None

        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (hlen,) = struct.unpack("<I", head)
            header = _read_header(f.read(hlen))
            (dlen,) = struct.unpack("<I", f.read(4))
            data = f.read(dlen)
            if header["op"][0] == 0x05:  # chunk
                data = _decompress(header["compression"].decode(), data)
                for h2, d2 in parse_records(data):
                    msg = handle(h2, d2)
                    if msg is not None:
                        yield msg
            else:
                msg = handle(header, data)
                if msg is not None:
                    yield msg


# ---------------------------------------------------------------------------
# Message decoders
# ---------------------------------------------------------------------------

_PC2_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4", 7: "f4", 8: "f8"}


def _skip_std_header(raw: bytes) -> tuple[int, float]:
    """std_msgs/Header: seq(u4) stamp(2u4) frame_id(string)."""
    _, secs, nsecs = struct.unpack_from("<III", raw, 0)
    (flen,) = struct.unpack_from("<I", raw, 12)
    return 16 + flen, secs + nsecs * 1e-9


def decode_imu(raw: bytes) -> ImuSample:
    """sensor_msgs/Imu (the header stamp is the sample time)."""
    pos, stamp = _skip_std_header(raw)
    pos += 4 * 8 + 9 * 8  # orientation + its covariance
    gyr = struct.unpack_from("<3d", raw, pos)
    pos += 3 * 8 + 9 * 8
    acc = struct.unpack_from("<3d", raw, pos)
    return ImuSample(stamp, np.asarray(gyr), np.asarray(acc))


def decode_pointcloud2(raw: bytes, stamp: float, lidar_type: str = "auto") -> LidarSweep:
    """sensor_msgs/PointCloud2 -> LidarSweep with per-point relative time.

    Per-vendor time fields (cloudProcessing.cpp:159-368):
      velodyne ('time'):       seconds from scan start; t_begin = stamp
      ouster ('t'):            NANOseconds from scan start (:221)
      robosense ('timestamp'): absolute epoch seconds, re-based to the
                               earliest point, which is t_begin (:305)
      pandar ('timestamp'):    re-based likewise, but t_begin stays the
                               header stamp (:351)
    "auto" infers velodyne/ouster/robosense from the field table; pass the
    configured lidar_type to tell pandar from robosense."""
    pos, _ = _skip_std_header(raw)
    height, width = struct.unpack_from("<II", raw, pos)
    pos += 8
    (nfields,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    fields = []
    for _ in range(nfields):
        (nlen,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        name = raw[pos:pos + nlen].decode()
        pos += nlen
        offset, datatype, count = struct.unpack_from("<IBI", raw, pos)
        pos += 9
        fields.append((name, offset, datatype, count))
    is_bigendian = raw[pos]
    pos += 1
    point_step, _ = struct.unpack_from("<II", raw, pos)
    pos += 8
    (dlen,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    buf = raw[pos:pos + dlen]

    n = height * width
    order = ">" if is_bigendian else "<"
    col = {name: np.ndarray((n,), dtype=order + _PC2_DTYPES[dt], buffer=buf,
                            offset=off, strides=(point_step,)).copy()
           for name, off, dt, _ in fields}
    xyz = np.stack([col["x"], col["y"], col["z"]], axis=1).astype(np.float64)
    intensity = col.get("intensity", np.zeros(n, np.float32)).astype(np.float32)

    t_begin = stamp
    if lidar_type in ("auto", "livox"):  # a Livox PointCloud2: infer
        lidar_type = ("velodyne" if "time" in col else "ouster" if "t" in col
                      else "robosense" if "timestamp" in col else "unknown")
    if lidar_type == "velodyne":
        rel = col["time"].astype(np.float64)
    elif lidar_type == "ouster":
        rel = col["t"].astype(np.float64) * 1e-9
    elif lidar_type in ("robosense", "pandar"):
        ts = col["timestamp"].astype(np.float64)
        ts0 = ts.min() if n else 0.0
        rel = ts - ts0
        if lidar_type == "robosense":
            t_begin = ts0
    else:
        rel = np.zeros(n)
    return LidarSweep(t_begin, xyz, rel, intensity)


_LIVOX_POINT = np.dtype([("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                         ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1")])


def decode_livox_custom(raw: bytes, stamp: float, tag_filter: bool = True) -> LidarSweep:
    """livox_ros_driver/CustomMsg (livoxHandler, cloudProcessing.cpp:119-157,
    with the `(tag & 0x30) == 0x10 || == 0x00` return filter, :141)."""
    pos, _ = _skip_std_header(raw)
    pos += 8  # timebase
    (point_num,) = struct.unpack_from("<I", raw, pos)
    pos += 4 + 1 + 3  # point_num, lidar_id, rsvd
    pts = np.frombuffer(raw, dtype=_LIVOX_POINT, count=point_num, offset=pos)
    if tag_filter:
        rt = pts["tag"] & 0x30
        pts = pts[(rt == 0x10) | (rt == 0x00)]
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], axis=1).astype(np.float64)
    rel = pts["offset_time"].astype(np.float64) * 1e-9
    return LidarSweep(stamp, xyz, rel, pts["reflectivity"].astype(np.float32))


def decode_compressed_image(raw: bytes, stamp: float, device="cuda") -> ImageSample:
    """sensor_msgs/CompressedImage -> RGB uint8, equal to OpenCV's
    imdecode(IMREAD_COLOR) with BGR->RGB. The format is sniffed from the
    magic bytes, as imdecode does, not from the `format` string
    (compressed_image_transport writes "bgr8; jpeg compressed bgr8"); a
    JPEG's reconstruction runs on `device`."""
    pos, _ = _skip_std_header(raw)
    (flen,) = struct.unpack_from("<I", raw, pos)
    pos += 4 + flen  # format string
    (dlen,) = struct.unpack_from("<I", raw, pos)
    data = raw[pos + 4:pos + 4 + dlen]
    if data.startswith(b"\xff\xd8\xff"):
        return ImageSample(stamp, jpeg.decode(data, device))
    if data.startswith(png.SIGNATURE):
        return ImageSample(stamp, png.decode(data))
    raise ValueError(f"unsupported compressed image format (magic {data[:8].hex()})")


def decode_image(raw: bytes, stamp: float) -> ImageSample:
    """sensor_msgs/Image (raw rgb8, bgr8 or mono8) -> RGB uint8."""
    pos, _ = _skip_std_header(raw)
    height, width = struct.unpack_from("<II", raw, pos)
    pos += 8
    (elen,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    encoding = raw[pos:pos + elen].decode()
    pos += elen + 1  # is_bigendian
    (step,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    (dlen,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    img = np.frombuffer(raw, np.uint8, dlen, pos).reshape(height, step)
    if encoding in ("bgr8", "rgb8"):
        img = img[:, :width * 3].reshape(height, width, 3)
        if encoding == "bgr8":  # cv2.COLOR_BGR2RGB is this channel flip
            img = img[..., ::-1]
    elif encoding == "mono8":
        img = np.repeat(img[:, :width, None], 3, axis=2)
    else:
        raise ValueError(f"unsupported image encoding {encoding!r}")
    return ImageSample(stamp, np.array(img, order="C"))  # a writable copy


class PoseSample(NamedTuple):
    t: float
    position: np.ndarray   # [3]
    quat_xyzw: np.ndarray  # [4]


def _decode_pose_at(raw: bytes, off: int, t: float) -> PoseSample:
    vals = struct.unpack_from("<7d", raw, off)
    return PoseSample(t, np.asarray(vals[:3], np.float64), np.asarray(vals[3:], np.float64))


def decode_pose_stamped(raw: bytes) -> PoseSample:
    """geometry_msgs/PoseStamped: Header + position(3d) + orientation(4d)
    (ground-truth pose topics, python/parse_pose.py:20-28)."""
    off, stamp = _skip_std_header(raw)
    return _decode_pose_at(raw, off, stamp)


def decode_odometry(raw: bytes) -> PoseSample:
    """nav_msgs/Odometry: Header + child_frame_id(string) + pose (7d + 36d
    covariance) [+ twist, ignored] (python/listen_odom.py's recording)."""
    off, stamp = _skip_std_header(raw)
    (clen,) = struct.unpack_from("<I", raw, off)
    return _decode_pose_at(raw, off + 4 + clen, stamp)


def decode(msg: BagMessage, lidar_type: str = "auto", device="cuda"):
    """Route a BagMessage to its sensor record (None for other types); a
    JPEG CompressedImage is reconstructed on `device`."""
    dt = msg.datatype
    if dt == "sensor_msgs/Imu":
        return decode_imu(msg.raw)
    if dt == "sensor_msgs/PointCloud2":
        return decode_pointcloud2(msg.raw, msg.t, lidar_type=lidar_type)
    if dt == "livox_ros_driver/CustomMsg":
        return decode_livox_custom(msg.raw, msg.t)
    if dt == "sensor_msgs/CompressedImage":
        return decode_compressed_image(msg.raw, msg.t, device)
    if dt == "sensor_msgs/Image":
        return decode_image(msg.raw, msg.t)
    if dt == "geometry_msgs/PoseStamped":
        return decode_pose_stamped(msg.raw)
    if dt == "nav_msgs/Odometry":
        return decode_odometry(msg.raw)
    return None


def play_bag(path: str, frontend, imu_topic: str, lidar_topic: str, image_topic: str,
             limit_messages: int | None = None) -> int:
    """Stream a bag into a LivoFrontend (the rosbag-play + subscriber loop).
    Returns the number of messages played."""
    count = 0
    lidar_type = frontend.cfg.common.lidar_type if hasattr(frontend, "cfg") else "auto"
    device = getattr(frontend, "device", "cuda")
    for msg in read_bag(path, {imu_topic, lidar_topic, image_topic}):
        rec = decode(msg, lidar_type=lidar_type, device=device)
        if isinstance(rec, ImuSample):
            frontend.push_imu(rec.t, rec.gyr, rec.acc)
        elif isinstance(rec, LidarSweep):
            frontend.push_lidar(rec)
        elif isinstance(rec, ImageSample):
            frontend.push_image(rec.t, rec.image)
        count += 1
        if limit_messages and count >= limit_messages:
            break
    return count


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _header_bytes(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _record(header: dict, data: bytes) -> bytes:
    h = _header_bytes(header)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _stamp(t: float) -> tuple[int, int]:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return secs, nsecs


def _std_header(t: float, frame: bytes = b"") -> bytes:
    return struct.pack("<III", 0, *_stamp(t)) + struct.pack("<I", len(frame)) + frame


def encode_imu(t: float, gyr, acc) -> bytes:
    """sensor_msgs/Imu with zero orientation and covariances."""
    z9 = struct.pack("<9d", *([0.0] * 9))
    return (_std_header(t) + struct.pack("<4d", 0, 0, 0, 1) + z9
            + struct.pack("<3d", *np.asarray(gyr, np.float64)) + z9
            + struct.pack("<3d", *np.asarray(acc, np.float64)) + z9)


def encode_livox_custom(t: float, xyz, rel_time, tag: int = 0x10) -> bytes:
    """livox_ros_driver/CustomMsg: float32 points, offset_time in integer ns."""
    n = len(xyz)
    pts = np.zeros(n, _LIVOX_POINT)
    pts["offset_time"] = np.round(np.asarray(rel_time) * 1e9).astype(np.uint32)
    for i, c in enumerate("xyz"):
        pts[c] = np.asarray(xyz)[:, i]
    pts["tag"] = tag
    return (_std_header(t) + struct.pack("<QI", int(round(t * 1e9)), n) + bytes(4)
            + pts.tobytes())


def encode_image(t: float, rgb: np.ndarray) -> bytes:
    """sensor_msgs/Image, rgb8."""
    h, w = rgb.shape[:2]
    data = np.ascontiguousarray(rgb, np.uint8).tobytes()
    return (_std_header(t) + struct.pack("<II", h, w) + struct.pack("<I", 4) + b"rgb8"
            + bytes([0]) + struct.pack("<I", w * 3) + struct.pack("<I", len(data)) + data)


def encode_compressed_image(t: float, rgb: np.ndarray, quality: int = 80) -> bytes:
    """sensor_msgs/CompressedImage holding a baseline 4:2:0 JPEG of `rgb`
    (`jpeg.encode`; quality 80 is compressed_image_transport's default),
    with its format string."""
    fmt = b"rgb8; jpeg compressed bgr8"
    data = jpeg.encode(rgb, quality)
    return (_std_header(t) + struct.pack("<I", len(fmt)) + fmt
            + struct.pack("<I", len(data)) + data)


def write_bag(path: str, messages: Iterable[tuple[str, str, float, bytes]]) -> int:
    """Write (topic, datatype, record time, message bytes) in order into an
    uncompressed ROS1 v2.0 bag (connection records before their first
    message; no index). Returns the number of messages written."""
    conns: dict[str, int] = {}
    n = 0
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        for topic, dtype, t, data in messages:
            if topic not in conns:
                conns[topic] = len(conns)
                f.write(_record({"op": bytes([0x07]), "conn": struct.pack("<I", conns[topic]),
                                 "topic": topic.encode()},
                                _header_bytes({"topic": topic.encode(), "type": dtype.encode(),
                                               "md5sum": b"*"})))
            f.write(_record({"op": bytes([0x02]), "conn": struct.pack("<I", conns[topic]),
                             "time": struct.pack("<II", *_stamp(t))}, data))
            n += 1
    return n
