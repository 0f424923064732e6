"""Output writers: TUM poses, PCD point clouds, side-by-side renders,
(the port's own copy of gslivm_tpu/utils/outputs.py; numpy on the host, as there)
cfg_args — the reference's shutdown artifact set (SURVEY §5 checkpoint).

Behavioral spec:
  - recordSinglePose (lioOptimization.cpp:1937-1977): TUM-style lines
    "time tx ty tz qx qy qz qw" in pose.txt, plus velocity.txt / bias.txt.
  - saveColorPoints (lioOptimization.cpp:2247-2287): binary PCD of the
    colored map points filtered by pub_point_minimum_views.
  - saveRender (lioOptimization.cpp:2182-2245): per-keyframe side-by-side
    render|GT PNG + JET-colormapped depth.
  - Write_model_parameters_to_file (parameters.cu:13-36): cfg_args for the
    SIBR viewer.
"""

from __future__ import annotations

import os

import numpy as np


def append_tum_pose(path: str, t: float, translation, quat_xyzw):
    """pose.txt line: 'time tx ty tz qx qy qz qw' (recordSinglePose)."""
    tr = np.asarray(translation, np.float64)
    q = np.asarray(quat_xyzw, np.float64)
    with open(path, "a") as f:
        f.write(
            f"{t:.6f} {tr[0]:.6e} {tr[1]:.6e} {tr[2]:.6e} "
            f"{q[0]:.6e} {q[1]:.6e} {q[2]:.6e} {q[3]:.6e}\n"
        )


def append_vec3(path: str, t: float, v):
    v = np.asarray(v, np.float64)
    with open(path, "a") as f:
        f.write(f"{t:.6f} {v[0]:.6e} {v[1]:.6e} {v[2]:.6e}\n")


def save_pcd_rgb(path: str, points: np.ndarray, colors: np.ndarray):
    """Binary PCD with xyz + packed rgb (pcl::PointXYZRGB layout)."""
    n = points.shape[0]
    rgb = colors.astype(np.uint32)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    packed_f = packed.astype(np.uint32).view(np.float32)

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z rgb\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        "DATA binary\n"
    )
    data = np.concatenate(
        [points.astype("<f4"), packed_f.reshape(-1, 1).astype("<f4")], axis=1
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())


def load_pcd_rgb(path: str):
    """Read back the PCD written by save_pcd_rgb."""
    with open(path, "rb") as f:
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("POINTS"):
                n = int(line.split()[-1])
            elif line.startswith("DATA"):
                break
        data = np.frombuffer(f.read(n * 16), dtype="<f4").reshape(n, 4)
    points = data[:, :3]
    packed = data[:, 3].copy().view(np.uint32)
    colors = np.stack(
        [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], axis=1
    ).astype(np.uint8)
    return points, colors


def jet_colormap(values: np.ndarray) -> np.ndarray:
    """OpenCV-JET-style colormap for depth PNGs ([..., 3] uint8 RGB)."""
    v = np.clip(values, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def save_png(path: str, image_u8: np.ndarray):
    """Minimal dependency-free PNG writer (RGB8)."""
    import struct
    import zlib

    h, w = image_u8.shape[:2]
    if image_u8.ndim == 2:
        image_u8 = np.repeat(image_u8[:, :, None], 3, axis=2)
    raw = b"".join(
        b"\x00" + image_u8[i].astype(np.uint8).tobytes() for i in range(h)
    )

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def save_side_by_side(path: str, render_chw: np.ndarray, gt_chw: np.ndarray):
    """render|GT side-by-side PNG (saveRender, lioOptimization.cpp:2198-2228);
    the layout `evaluate_image.py` splits back apart."""
    render = (np.clip(render_chw, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    gt = (np.clip(gt_chw, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    save_png(path, np.concatenate([render, gt], axis=1))


def save_depth_sbs(path: str, depth_a: np.ndarray, depth_b: np.ndarray):
    """Side-by-side JET depth PNG (consumed by see_depth_l1.py-style evals)."""
    lo = min(depth_a.min(), depth_b.min())
    hi = max(depth_a.max(), depth_b.max(), lo + 1e-6)
    img = np.concatenate(
        [jet_colormap((depth_a - lo) / (hi - lo)),
         jet_colormap((depth_b - lo) / (hi - lo))], axis=1)
    save_png(path, img)


def export_video(image_dir: str, out_path: str, fps: int = 10) -> bool:
    """PNG sequence -> mp4 (saveRender's ffmpeg step,
    lioOptimization.cpp:2236-2244). Returns False when ffmpeg is absent."""
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        return False
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
             "-i", os.path.join(image_dir, "*.png"),
             "-pix_fmt", "yuv420p", out_path],
            check=True, capture_output=True, timeout=600)
        return True
    except Exception:
        return False


def write_cfg_args(output_path: str, sh_degree: int = 0,
                   white_background: bool = True, images: str = "images"):
    """cfg_args for SIBR-viewer compatibility (parameters.cu:13-36)."""
    os.makedirs(output_path, exist_ok=True)
    with open(os.path.join(output_path, "cfg_args"), "w") as f:
        f.write(
            "Namespace("
            f"eval=False, images='{images}', model_path='{output_path}', "
            f"resolution=-1, sh_degree={sh_degree}, source_path='', "
            f"white_background={white_background})"
        )
