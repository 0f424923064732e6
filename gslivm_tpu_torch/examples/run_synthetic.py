"""End-to-end demo: full LIVO front-end + mapping on synthetic data (the
port's own copy of examples/run_synthetic.py).

Runs the complete system the way a dataset run would (SURVEY §3 call
stacks): IMU/LiDAR/image streams -> MeasurementSync -> ESKF+ICP odometry ->
colored map -> voxel-GPR -> incremental 3DGS optimization -> metrics +
artifacts (PLY map, PCD colour map, TUM poses, side-by-side renders,
cfg_args, log_time.txt).

Usage: python -m gslivm_tpu_torch.examples.run_synthetic [--frames N]
           [--iters N] [--out DIR] [--device cuda|cpu] [--backend auto|naive|tiles]
           [--overlap]

The JAX example's flags, defaults and artifacts; its --cpu is --device cpu
here, and the default device is the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default="/tmp/gslivm_demo")
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--backend", default="auto",
                    help="rasterizer backend: auto|naive|tiles")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--overlap", action="store_true",
                    help="run the mapper/training in a worker thread "
                         "overlapped with the front-end (the reference's "
                         "optimize_vis thread topology)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gslivm_tpu_torch.config import Config, GpParams, IcpOptions, OdometryOptions
    from gslivm_tpu_torch.frontend import synthetic
    from gslivm_tpu_torch.frontend.livo import LivoFrontend
    from gslivm_tpu_torch.frontend.sensors import LidarSweep
    from gslivm_tpu_torch.ops.rasterize import RasterizeSettings
    from gslivm_tpu_torch.pipeline import ConcurrentMapper, IncrementalMapper
    from gslivm_tpu_torch.utils import metrics as M
    from gslivm_tpu_torch.utils import outputs
    from gslivm_tpu_torch.utils.device import resolve_device
    from gslivm_tpu_torch.utils.timer import Timer

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)
    t_wall0 = time.time()

    cfg = Config(
        gp=GpParams(grid=0.5),
        odometry=OdometryOptions(init_num_frames=2, voxel_size=0.05,
                                 sample_voxel_size=0.6, init_voxel_size=0.05,
                                 init_sample_voxel_size=0.6),
        icp=IcpOptions(min_number_neighbors=8, max_num_residuals=300,
                       size_voxel_map=0.5, num_iters_icp=6),
    )

    planes = synthetic.default_scene()
    cams = synthetic.make_trajectory(args.frames, args.width, args.height, device=dev)
    fx = float(cams[0].fx)
    fe = LivoFrontend(config=cfg, fx=fx, fy=fx,
                      cx=(args.width - 1) / 2, cy=(args.height - 1) / 2,
                      width=args.width, height=args.height, device=dev)
    mapper = IncrementalMapper(
        config=cfg,
        settings=RasterizeSettings(backend=args.backend),
        bootstrap_points=200, initial_capacity=8192, device=dev)

    # ---- front-end streaming ----
    g = np.array([0, 0, 9.81])
    t = 0.0
    for _ in range(80):  # static IMU init
        fe.push_imu(t, np.zeros(3), g + rng.normal(0, 1e-3, 3))
        t += 0.005

    # NOTE: the demo front-end holds the sensor static per sweep packet (the
    # synthetic trajectory moves cameras for mapping variety); feed the
    # mapper with GT-posed frames like the dataset path would.
    frames = synthetic.make_sequence(args.frames, args.width, args.height,
                                     points_per_frame=5000, device=dev)
    iters_per_frame = max(1, -(-args.iters // max(args.frames, 1)))

    # ---- the live loop: per sweep, front-end work + mapping + training.
    # Serial mode runs them back to back (frontend -> add_frame -> train);
    # --overlap submits frames to the ConcurrentMapper worker so the device
    # trains WHILE the host front-end processes the next sweep (the
    # reference's optimize_vis thread, lioOptimization.cpp:2496-2501).
    cm = ConcurrentMapper(mapper, iters_per_frame=iters_per_frame) if args.overlap else None

    t_loop0 = time.perf_counter()
    t_frontend = 0.0
    t_mapper_serial = 0.0
    for k, cam in enumerate(cams):
        tf0 = time.perf_counter()
        with Timer.evaluate("frontend_sweep"):
            R_wc = cam.R_cw.cpu().numpy().T
            center = cam.cam_center.cpu().numpy()
            pts_w = synthetic.sample_surface_points(cam, planes, 5000, rng)
            pts_sensor = (pts_w - center) @ R_wc
            fe.push_lidar(LidarSweep(t, pts_sensor,
                                     np.linspace(0, 0.09, len(pts_sensor)),
                                     np.zeros(len(pts_sensor))))
            for j in range(20):
                fe.push_imu(t + j * 0.005, np.zeros(3),
                            g + rng.normal(0, 1e-3, 3))
            fe.push_image(t + 0.095, synthetic.render_image(cam, planes))
            t += 0.1
        q, p = fe.pose
        outputs.append_tum_pose(os.path.join(args.out, "pose.txt"),
                                t, p, [q[1], q[2], q[3], q[0]])
        t_frontend += time.perf_counter() - tf0

        if cm is not None:
            cm.submit_frame(frames[k])
        else:
            tm0 = time.perf_counter()
            with Timer.evaluate("gsPointCloudUpdate"):
                mapper.add_frame(frames[k])
            metrics = None
            for _ in range(iters_per_frame):
                with Timer.evaluate("optimize_vis_iter"):
                    metrics = mapper.train_iteration() or metrics
            t_mapper_serial += time.perf_counter() - tm0
            if metrics is not None:
                print(f"frame {k} loss {float(metrics.loss):.4f} "
                      f"psnr {float(metrics.psnr):.2f}")

    if cm is not None:
        mapper = cm.finish()
        t_mapper = cm.busy_s
        trained = cm.trained
    else:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_mapper = t_mapper_serial
        trained = mapper.iter
    wall = time.perf_counter() - t_loop0

    serial_sum = t_frontend + t_mapper
    overlap_stats = {
        "mode": "overlap" if args.overlap else "serial",
        "frames": args.frames,
        "train_iters": trained,
        "wall_s": round(wall, 3),
        "frontend_s": round(t_frontend, 3),
        "mapper_busy_s": round(t_mapper, 3),
        "serial_sum_s": round(serial_sum, 3),
        "overlap_gain": round(serial_sum / wall, 3) if wall > 0 else None,
        "wall_fps": round(args.frames / wall, 3) if wall > 0 else None,
    }
    print("pipeline:", json.dumps(overlap_stats))

    e1 = mapper.evaluate()
    print(f"eval: psnr {e1['mean_psnr']:.2f}, ssim {e1['mean_ssim']:.3f}")

    # ---- artifacts (saveRender / saveColorPoints equivalents) ----
    mapper.save_ply(os.path.join(args.out, "map.ply"))
    colored = fe.color_map
    ok = colored.n_rgb >= cfg.map.pub_point_minimum_views
    outputs.save_pcd_rgb(os.path.join(args.out, "rgb_map.pcd"),
                         colored.position[ok].astype(np.float32),
                         np.clip(colored.rgb[ok], 0, 255).astype(np.uint8))
    os.makedirs(os.path.join(args.out, "training"), exist_ok=True)
    for i in range(len(mapper.cameras)):
        out = mapper.render_keyframe(i)
        outputs.save_side_by_side(
            os.path.join(args.out, "training", f"{i}.png"),
            out.color.cpu().numpy(), mapper.gt_images[i])
    outputs.write_cfg_args(args.out, cfg.model.sh_degree,
                           cfg.model.white_background)
    Timer.dump_into_file(len(mapper.cameras), (time.time() - t_wall0) * 1e3,
                         os.path.join(args.out, "log_time.txt"))

    res = M.evaluate_dir(os.path.join(args.out, "training"), device=dev)
    print("offline eval harness:", res)
    print("artifacts in", args.out, ":", sorted(os.listdir(args.out)))


if __name__ == "__main__":
    main()
