"""Run the full LIVO + 3DGS mapping system on a ROS1 bag (the port's own
copy of examples/run_bag.py).

The ROS-free equivalent of the reference's `roslaunch livo_*.launch` +
`rosbag play` flow: streams the bag through the LivoFrontend (ESKF + plane
ICP + VIO), feeds its posed coloured frames to the IncrementalMapper on
the card, interleaves training, and writes the reference's artifacts:
map.ply, rgb_map.pcd, pose.txt, training/<i>.png and log_time.txt.

Usage:
  python -m gslivm_tpu_torch.examples.run_bag BAG \
      --dataset configs/datasets/r3live.yaml [--out DIR] \
      [--train-iters-per-frame 10] [--max-messages N] [--device cuda|cpu] \
      [--backend auto|naive|tiles] [--overlap]

The JAX example's flags, defaults and artifacts; its --cpu is --device cpu
here, and the default device is the card. Image topics stored as
sensor_msgs/CompressedImage (r3live, FAST-LIVO) are decoded by the port's
own JPEG and PNG decoders (a JPEG's reconstruction on --device), and the
dataset's image_resize_ratio and distortion run on --device too; nothing
needs OpenCV. Besides the JAX example's lines it prints `bag:` (host ms to
read the bag, to decode each message type, and `intake_ms`, the front
end's resize and undistortion of the images), `pipeline:` (wall, front
end, mapper and wall_fps, sweeps a second) and `keyframes:` (each
keyframe's PSNR when staged, before training on it, in the serial loop,
and at the end) as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict


def _vec(s: str):
    import numpy as np  # noqa: PLC0415

    return np.asarray([float(x) for x in str(s).split(",")])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("bag")
    ap.add_argument("--dataset", required=True, help="dataset yaml (configs/datasets/*.yaml)")
    ap.add_argument("--common", default="configs/basic_common.yaml")
    ap.add_argument("--out", default="output")
    ap.add_argument("--train-iters-per-frame", type=int, default=10)
    ap.add_argument("--max-messages", type=int, default=None)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--watchdog-period", type=float, default=1000.0,
                    help="stall-watchdog check period in seconds (heartHandler analog)")
    ap.add_argument("--overlap", action="store_true",
                    help="train in a worker thread overlapped with bag decoding + odometry "
                         "(optimize_vis thread analog)")
    args = ap.parse_args(argv)

    import numpy as np  # noqa: PLC0415

    from gslivm_tpu_torch.config import load_config, load_yaml  # noqa: PLC0415
    from gslivm_tpu_torch.frontend import rosbag  # noqa: PLC0415
    from gslivm_tpu_torch.frontend.livo import LivoFrontend  # noqa: PLC0415
    from gslivm_tpu_torch.frontend.sensors import (  # noqa: PLC0415
        ImageSample,
        ImuSample,
        LidarSweep,
    )
    from gslivm_tpu_torch.ops.rasterize import RasterizeSettings  # noqa: PLC0415
    from gslivm_tpu_torch.pipeline import ConcurrentMapper, IncrementalMapper  # noqa: PLC0415
    from gslivm_tpu_torch.utils import outputs  # noqa: PLC0415
    from gslivm_tpu_torch.utils.device import resolve_device  # noqa: PLC0415
    from gslivm_tpu_torch.utils.timer import Timer  # noqa: PLC0415
    from gslivm_tpu_torch.utils.watchdog import StallWatchdog  # noqa: PLC0415

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    raw = load_yaml(args.dataset)
    ds = raw["dataset"]
    overrides = {k: v for k, v in raw.items() if k != "dataset"}
    cfg = load_config(dataset_overrides=overrides,
                      common_overrides=load_yaml(args.common))

    fe = LivoFrontend(
        config=cfg,
        fx=ds["fx"], fy=ds["fy"], cx=ds["cx"], cy=ds["cy"],
        width=ds["image_width"], height=ds["image_height"],
        R_imu_lidar=_vec(ds["R_imu_lidar"]).reshape(3, 3),
        t_imu_lidar=_vec(ds["t_imu_lidar"]),
        R_imu_camera=_vec(ds["R_imu_camera"]).reshape(3, 3),
        t_imu_camera=_vec(ds["t_imu_camera"]),
        distortion=[ds["dist_k1"], ds["dist_k2"], ds["dist_p1"], ds["dist_p2"], ds["dist_k3"]],
        image_resize_ratio=float(ds.get("image_resize_ratio", 1.0)),
        device=dev,
    )
    mapper = IncrementalMapper(config=cfg, settings=RasterizeSettings(backend=args.backend),
                               device=dev)

    # stall watchdog (heartHandler analog, lioOptimization.cpp:236,760-765):
    # once mapping has started, a check period with no sensor data ends the
    # run and falls through to the shutdown artifacts
    dog = StallWatchdog(period_s=args.watchdog_period)
    dog.start()
    cm = ConcurrentMapper(mapper, iters_per_frame=args.train_iters_per_frame) \
        if args.overlap else None

    pose_path = os.path.join(args.out, "pose.txt")
    if os.path.exists(pose_path):
        os.remove(pose_path)
    t0 = time.time()
    t_loop = time.perf_counter()
    t_frontend = t_mapper = t_read = 0.0
    decode_s, counts = defaultdict(float), defaultdict(int)
    count = trained = sweeps = 0
    m = None
    staged = []  # keyframe PSNRs when staged, on the device until the end
    messages = rosbag.read_bag(args.bag, {ds["imu_topic"], ds["lidar_topic"], ds["image_topic"]})
    while True:
        tr = time.perf_counter()
        msg = next(messages, None)
        t_read += time.perf_counter() - tr
        if msg is None:
            break
        if dog.stopped:
            print("watchdog: no sensor data for a full period — stopping")
            break
        tf0 = time.perf_counter()
        rec = rosbag.decode(msg, lidar_type=cfg.common.lidar_type, device=dev)
        decode_s[msg.datatype] += time.perf_counter() - tf0
        counts[msg.datatype] += 1
        if isinstance(rec, ImuSample):
            dog.notify_data()  # is_received_data (imuHandler:768)
            fe.push_imu(rec.t, rec.gyr, rec.acc)
        elif isinstance(rec, LidarSweep):
            sweeps += 1
            with Timer.evaluate("lidar_sweep"):
                fe.push_lidar(rec)
        elif isinstance(rec, ImageSample):
            with Timer.evaluate("image_frame"):
                fe.push_image(rec.t, rec.image)
        t_frontend += time.perf_counter() - tf0
        count += 1
        if args.max_messages and count >= args.max_messages:
            break

        for frame in fe.pop_frames():
            q, p = fe.pose
            outputs.append_tum_pose(pose_path, msg.t, p, [q[1], q[2], q[3], q[0]])
            if cm is not None:
                cm.submit_frame(frame)
                if mapper.started:
                    dog.notify_started()
                m = cm.last_metrics
                if m is not None and cm.trained % 50 == 0:
                    print(f"msgs {count:7d} gaussians {int(mapper.params.n_active):8d} "
                          f"kf {len(mapper.cameras):4d} loss {float(m.loss):.4f}", flush=True)
                continue
            tm0 = time.perf_counter()
            kf = len(mapper.cameras)
            with Timer.evaluate("gsPointCloudUpdate"):
                stats = mapper.add_frame(frame)
            if len(mapper.cameras) > kf:
                staged.append(mapper.score_keyframe(kf)[0])
            if mapper.started:
                dog.notify_started()  # is_gs_started gate
            for _ in range(args.train_iters_per_frame):
                with Timer.evaluate("optimize_vis_iter"):
                    m = mapper.train_iteration() or m
            trained += args.train_iters_per_frame
            t_mapper += time.perf_counter() - tm0
            if m is not None:
                print(f"msgs {count:7d} gaussians {stats['active']:8d} "
                      f"kf {stats['keyframes']:4d} loss {float(m.loss):.4f} "
                      f"psnr {float(m.psnr):.2f}", flush=True)
    dog.cancel()

    if cm is not None:
        mapper = cm.finish()
        trained, t_mapper = cm.trained, cm.busy_s
    elif dev.type == "cuda":
        import torch  # noqa: PLC0415

        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_loop
    print("bag:", json.dumps({
        "messages": dict(counts), "read_ms": t_read * 1e3,
        "decode_ms": {k: v * 1e3 for k, v in decode_s.items()},
        "decode_ms_per_message": {k: decode_s[k] * 1e3 / counts[k] for k in counts},
        "intake_ms": fe.stage_seconds["intake"] * 1e3}),
        flush=True)
    serial_sum = t_frontend + t_mapper
    print("pipeline:", json.dumps({
        "mode": "overlap" if cm is not None else "serial", "sweeps": sweeps,
        "train_iters": trained, "wall_s": wall, "frontend_s": t_frontend,
        "mapper_busy_s": t_mapper, "serial_sum_s": serial_sum,
        "overlap_gain": serial_sum / wall if wall > 0 else None,
        "wall_fps": sweeps / wall if wall > 0 else None}), flush=True)

    # shutdown artifacts (saveRender / saveColorPoints equivalents)
    mapper.save_ply(os.path.join(args.out, "map.ply"))
    colored = fe.color_map
    ok = colored.n_rgb >= cfg.map.pub_point_minimum_views
    if ok.any():
        outputs.save_pcd_rgb(os.path.join(args.out, "rgb_map.pcd"),
                             colored.position[ok].astype(np.float32),
                             np.clip(colored.rgb[ok], 0, 255).astype(np.uint8))
    os.makedirs(os.path.join(args.out, "training"), exist_ok=True)
    final = []
    for i in range(len(mapper.cameras)):
        out = mapper.render_keyframe(i)
        outputs.save_side_by_side(os.path.join(args.out, "training", f"{i}.png"),
                                  out.color.cpu().numpy(), mapper.gt_images[i])
        final.append(float(mapper.score_keyframe(i)[0]))
    print("keyframes:", json.dumps({
        "psnr_staged": [float(v) for v in staged] if cm is None else None,
        "psnr_final": final}), flush=True)
    Timer.dump_into_file(max(len(mapper.cameras), 1), (time.time() - t0) * 1e3,
                         os.path.join(args.out, "log_time.txt"))
    print("eval:", mapper.evaluate())
    print("artifacts in", args.out)


if __name__ == "__main__":
    main()
