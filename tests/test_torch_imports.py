"""The port stands alone: no module of gslivm_tpu_torch imports JAX, flax,
optax or the JAX package, importing it loads none of them, its main path
runs without OpenCV, and its entry points refuse to fall back to the CPU
on their own."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import gslivm_tpu_torch

PKG = pathlib.Path(gslivm_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gslivm_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    return sorted(PKG.rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    assert len(_modules()) >= 15
    bad = []
    for path in _modules():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(PKG)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(PKG.parent).with_suffix("").parts)
            for p in _modules()]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "added = sorted(set(sys.modules) - before)\n"
        "print('\\n'.join(added))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120, check=True)
    added = out.stdout.split()
    for m in ("gslivm_tpu_torch.ops.rasterize_tiles", "gslivm_tpu_torch.pipeline",
              "gslivm_tpu_torch.frontend.gpmap", "gslivm_tpu_torch.frontend.synthetic",
              "gslivm_tpu_torch.ops.gp3d", *NEW_MODULES):
        assert m in added, m
    assert not [m for m in added if _forbidden(m)]
    assert "cv2" not in added


# the LIVO slice: the host front end, checkpoint, utils and examples
NEW_MODULES = tuple(f"gslivm_tpu_torch.{m}" for m in (
    "frontend.so3", "frontend.eskf", "frontend.voxelmap", "frontend.native",
    "frontend.sensors", "frontend.odometry", "frontend.vision", "frontend.vio",
    "frontend.livo", "utils.checkpoint", "utils.timer", "utils.outputs",
    "utils.trajectory", "utils.watchdog", "utils.debug", "utils.metrics",
    "examples.run_synthetic", "examples.offline_fit",
    # the sharded step and the ROS-bag entry point
    "parallel", "parallel.collectives", "parallel.primitive", "parallel.sharding",
    "tools.multihost_demo", "frontend.rosbag", "examples.run_bag", "tools.bag_export",
    # the camera intake (its C++ loaded by frontend.native) and the offline tools
    "frontend.jpeg", "frontend.png", "frontend.imgproc", "tools.calib", "tools.nerf_export",
    "tools.traj_plot", "tools.time_plot", "tools.see_image", "tools.sbs_video",
    "tools.gp_figure",
    # the stage profilers of the 1080p render and its losses
    "tools.profile_stages", "tools.profile_binning", "tools.microbench_losses",
    "tools.microbench_gridsample"))


JAX_PKG = PKG.parent / "gslivm_tpu"
# what the JAX package has and the port has not, by module (file) or
# module:name, each with the reason
NO_TWIN = {
    "ops/blur_pallas.py": "the Pallas blur became K3, csrc/blur.cu, bound in ops/blur.py "
                          "(blur_many) through kernels.py",
    "ops/rasterize_pallas.py": "the Pallas rasterizer became K1 and K2, csrc/tile_forward.cu "
                               "and csrc/tile_backward.cu, bound in ops/rasterize_tiles.py "
                               "through kernels.py",
    "pipeline.py:MapperState": "a dataclass that nothing uses",
    "utils/timer.py:DeviceTrace": "a trace exporter nothing read; the program's spans "
                                  "(timer.span) open ranges in the caller's profiler",
    "utils/timer.py:device_memory_mb": "nothing read it; tools/memlog.py keeps its own",
}


def _public_defs(path) -> list[str]:
    tree = ast.parse(path.read_text(), str(path))
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef | ast.AsyncFunctionDef | ast.ClassDef)
            and not n.name.startswith("_")]


def _top_level_names(path) -> set[str]:
    names = set()
    for n in ast.parse(path.read_text(), str(path)).body:
        if isinstance(n, ast.FunctionDef | ast.AsyncFunctionDef | ast.ClassDef):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
    return names


def test_every_public_name_of_the_jax_package_has_a_twin():
    """Every public top-level function and class of each gslivm_tpu module
    is defined under the same name in the gslivm_tpu_torch module at the
    same path; the exceptions are NO_TWIN's, each still without a twin."""
    missing = set()
    jax_modules = sorted(JAX_PKG.rglob("*.py"))
    assert len(jax_modules) >= 40
    for path in jax_modules:
        rel = path.relative_to(JAX_PKG).as_posix()
        twin = PKG / rel
        if not twin.exists():
            missing.add(rel)
            continue
        have = _top_level_names(twin)
        missing |= {f"{rel}:{name}" for name in _public_defs(path) if name not in have}
    assert missing == set(NO_TWIN), sorted(missing ^ set(NO_TWIN))


def test_opencv_is_imported_only_for_the_off_path_options():
    """`import cv2` appears once, inside a helper function: the mp4 writer
    of tools/sbs_video.py. The camera intake (CompressedImage decoding,
    resize, undistortion) and the image path run without it."""
    def cv2_imports(tree):
        return [n for n in ast.walk(tree) if isinstance(n, ast.Import | ast.ImportFrom)
                and "cv2" in [a.name for a in n.names] + [getattr(n, "module", None)]]

    sites, found = set(), 0
    for path in _modules():
        tree = ast.parse(path.read_text(), str(path))
        found += len(cv2_imports(tree))
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef) and cv2_imports(fn):
                sites.add((path.name, fn.name))
    assert sites == {("sbs_video.py", "_video_writer")} and found == 1, (sites, found)


NO_CV2_RUN = '''
import sys
sys.modules["cv2"] = None
import torch
torch.set_num_threads(1)
from gslivm_tpu_torch.config import Config, GpParams, IcpOptions, OdometryOptions
from gslivm_tpu_torch.examples import run_bag
from gslivm_tpu_torch.frontend import rosbag, synthetic
from gslivm_tpu_torch.frontend.livo import LivoFrontend
from gslivm_tpu_torch.pipeline import IncrementalMapper
from gslivm_tpu_torch.utils.outputs import save_png

tmp = sys.argv[1]
R3LIVE = [-0.1080, 0.1050, -1.2872e-04, 5.7923e-05, -0.0222]  # r3live.yaml
cfg = Config(gp=GpParams(grid=0.5),
             odometry=OdometryOptions(init_num_frames=2, sample_voxel_size=0.6,
                                      init_sample_voxel_size=0.6),
             icp=IcpOptions(min_number_neighbors=8, size_voxel_map=0.5))


def run(fe, st):
    for s in st.init_imu:
        fe.push_imu(*s)
    for sw in st.sweeps:
        fe.push_lidar(sw.lidar)
        for s in sw.imu:
            fe.push_imu(*s)
        fe.push_image(sw.image_time, sw.image)
    return fe.pop_frames()


st = synthetic.dolly_stream(6, 64, 48, 600)
fe = LivoFrontend(cfg, fx=st.fx, fy=st.fy, cx=st.cx, cy=st.cy, width=64, height=48,
                  device="cpu")
frames = run(fe, st)
assert len(frames) >= 4 and fe.stage_seconds["lk"] > 0, len(frames)
m = IncrementalMapper(cfg, bootstrap_points=50, initial_capacity=1024, device="cpu")
print(m.add_frame(frames[-1])["voxels"]["cells"])

big = synthetic.dolly_stream(6, 128, 96, 600)
fe = LivoFrontend(cfg, fx=big.fx, fy=big.fy, cx=big.cx, cy=big.cy, width=128, height=96,
                  image_resize_ratio=0.5, distortion=R3LIVE, device="cpu")
frames = run(fe, big)
assert len(frames) >= 4 and frames[-1].image.shape == (48, 64, 3), len(frames)
assert fe.stage_seconds["intake"] > 0


def png_message(t, rgb):
    save_png(tmp + "/f.png", rgb)
    data = open(tmp + "/f.png", "rb").read()
    return (rosbag._std_header(t) + (3).to_bytes(4, "little") + b"png"
            + len(data).to_bytes(4, "little") + data)


def messages():
    for t, g, a in big.init_imu:
        yield "/imu", "sensor_msgs/Imu", t, rosbag.encode_imu(t, g, a)
    for i, sw in enumerate(big.sweeps):
        li = sw.lidar
        yield ("/lidar", "livox_ros_driver/CustomMsg", li.t_begin,
               rosbag.encode_livox_custom(li.t_begin, li.xyz, li.rel_time))
        for t, g, a in sw.imu:
            yield "/imu", "sensor_msgs/Imu", t, rosbag.encode_imu(t, g, a)
        msg = rosbag.encode_compressed_image(sw.image_time, sw.image) if i % 2 \\
            else png_message(sw.image_time, sw.image)
        yield "/cam", "sensor_msgs/CompressedImage", sw.image_time, msg


rosbag.write_bag(tmp + "/c.bag", messages())
k1, k2, p1, p2, k3 = R3LIVE
open(tmp + "/ds.yaml", "w").write(f"""dataset:
    lidar_topic: /lidar
    imu_topic: /imu
    image_topic: /cam
    lidar_type: livox
    image_width: 128
    image_height: 96
    image_resize_ratio: 0.5
    fx: {big.fx}
    fy: {big.fy}
    cx: {big.cx}
    cy: {big.cy}
    dist_k1: {k1}
    dist_k2: {k2}
    dist_p1: {p1}
    dist_p2: {p2}
    dist_k3: {k3}
    t_imu_lidar: "0,0,0"
    R_imu_lidar: "1,0,0,0,1,0,0,0,1"
    t_imu_camera: "0,0,0"
    R_imu_camera: "1,0,0,0,1,0,0,0,1"
gp:
    grid: 0.5
odometry:
    init_num_frames: 2
    sample_voxel_size: 0.6
    init_sample_voxel_size: 0.6
icp:
    min_number_neighbors: 8
    size_voxel_map: 0.5
""")
run_bag.main([tmp + "/c.bag", "--dataset", tmp + "/ds.yaml", "--out", tmp + "/out",
              "--device", "cpu", "--backend", "naive", "--train-iters-per-frame", "1"])
print(len(open(tmp + "/out/pose.txt").read().splitlines()))
print("cv2" in sys.modules and sys.modules["cv2"] is None)
'''


def test_livo_frontend_runs_without_opencv(tmp_path):
    """With cv2 unimportable, the default-option front end runs on the CPU
    over a few sweeps with images (LK, F and PnP RANSAC included) and one
    emitted frame goes into a CPU mapper; a front end at image_resize_ratio
    0.5 with configs/datasets/r3live.yaml's distortion runs too; and
    run_bag takes a mini bag of JPEG and PNG CompressedImages with such a
    dataset yaml."""
    out = subprocess.run([sys.executable, "-c", NO_CV2_RUN, str(tmp_path)], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.split("\n")
    cells, poses, untouched = lines[0], lines[-3], lines[-2]
    assert int(cells) > 0 and int(poses) >= 4 and untouched == "True", out.stdout[-2000:]
    assert '"sensor_msgs/CompressedImage": 6' in out.stdout


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from gslivm_tpu_torch import convert, pipeline
    from gslivm_tpu_torch.examples import offline_fit, run_bag, run_synthetic
    from gslivm_tpu_torch.frontend import gpmap, synthetic
    from gslivm_tpu_torch.frontend.livo import LivoFrontend
    from gslivm_tpu_torch.models import cameras, gaussian_model, training
    from gslivm_tpu_torch.tools import bag_export, multihost_demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu = gaussian_model.create_empty(3, device="cpu")
    gaussian_model.save_ply(cpu, str(tmp_path / "m.ply"))
    fields = {f: np.asarray(getattr(cpu, f).detach()) for f in convert.PARAM_FIELDS}
    calls = [
        lambda: cameras.make_camera(np.eye(3), np.zeros(3), 8, 8, fovx=1.0, fovy=1.0),
        lambda: gaussian_model.create_empty(3),
        lambda: gaussian_model.load_ply(str(tmp_path / "m.ply")),
        lambda: convert.params_from_numpy(fields),
        lambda: convert.simi_from_numpy({"points": np.zeros((2, 3)), "point_mask": np.ones(2),
                                         "gauss_idx": np.zeros(2), "gauss_mask": np.ones(2)}),
        lambda: training.empty_simi(),
        lambda: convert.cam_projection_from_numpy(
            {"R_wc": np.eye(3), "t_wc": np.zeros(3), "fx": 1.0, "fy": 1.0, "cx": 0.0,
             "cy": 0.0, "dist": np.zeros(4)}),
        lambda: gpmap.GpMap(),
        lambda: synthetic.make_sequence(n_frames=1, width=8, height=8, points_per_frame=10),
        lambda: pipeline.IncrementalMapper(initial_capacity=8),
        lambda: LivoFrontend(),
        lambda: run_synthetic.main(["--out", str(tmp_path / "demo")]),
        lambda: offline_fit.main([]),
        lambda: multihost_demo.main(["--nproc", "2"]),
        lambda: run_bag.main([str(tmp_path / "none.bag"), "--dataset",
                              str(tmp_path / "none.yaml"), "--out", str(tmp_path / "bag")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # and each runs when the caller asks for the CPU
    assert gaussian_model.load_ply(str(tmp_path / "m.ply"), device="cpu").xyz.device.type == "cpu"
    assert pipeline.IncrementalMapper(initial_capacity=8, device="cpu").params.xyz.device.type == "cpu"
    assert LivoFrontend(device="cpu").device.type == "cpu"
    assert not (tmp_path / "demo").exists() and not (tmp_path / "bag").exists()
    # bag_export is host code: it runs with no card, and is not on the list
    from gslivm_tpu_torch.frontend import rosbag

    img = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3)
    rosbag.write_bag(str(tmp_path / "cam.bag"),
                     [("/cam", "sensor_msgs/Image", 1.0, rosbag.encode_image(1.0, img))])
    bag_export.main(["images", str(tmp_path / "cam.bag"), "--topic", "/cam",
                     "--out", str(tmp_path / "rgb")])
    assert os.listdir(tmp_path / "rgb") == ["1.000000.png"]


def test_kernels_are_not_built_at_import():
    from gslivm_tpu_torch import kernels

    assert kernels._FNS == {}
    assert set(kernels.SOURCES) == {p.stem for p in (PKG / "csrc").glob("*.cu")}
    for name in kernels.SOURCES:
        assert kernels.library_path(name).name.startswith(f"lib{name}-")


def test_library_name_follows_the_nvcc_flags(monkeypatch):
    """An edited flag must rebuild a kernel, not reuse the old library."""
    from gslivm_tpu_torch import kernels

    before = {n: kernels.library_path(n) for n in kernels.SOURCES}
    monkeypatch.setattr(kernels, "NVCC_FLAGS", [*kernels.NVCC_FLAGS, "--use_fast_math"])
    for name in kernels.SOURCES:
        assert kernels.library_path(name) != before[name]
        assert kernels.library_path(name).parent == before[name].parent


def test_library_name_follows_the_included_headers(monkeypatch, tmp_path):
    """An edited header must rebuild every kernel that includes it, and
    only those."""
    import shutil

    from gslivm_tpu_torch import kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {n: kernels.library_path(n) for n in kernels.SOURCES}
    users = {n for n in kernels.SOURCES
             if "tile_common.cuh" in kernels._local_headers((csrc / f"{n}.cu").read_bytes())}
    # K1, K2 and the ablation of K1's chunk walk (T2) share the pair math
    assert users == {"tile_forward", "tile_backward", "microbench_fwdablate"}
    with open(csrc / "tile_common.cuh", "a") as f:
        f.write("\n// edited\n")
    for name in kernels.SOURCES:
        assert (kernels.library_path(name) != before[name]) == (name in users), name


def test_library_name_follows_the_usage_header(monkeypatch, tmp_path):
    """The runtime's resource report lives in one header; editing it must
    rebuild every library that exports a `<name>_usage` entry, and only
    those."""
    import shutil

    from gslivm_tpu_torch import kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {n: kernels.library_path(n) for n in kernels.SOURCES}
    users = {n for n in kernels.SOURCES
             if "kernel_usage.cuh" in kernels._local_headers((csrc / f"{n}.cu").read_bytes())}
    assert users == set(kernels._USAGE_ARGS) == {"tile_forward", "tile_backward", "blur",
                                                  "microbench_fwdablate"}
    with open(csrc / "kernel_usage.cuh", "a") as f:
        f.write("\n// edited\n")
    for name in kernels.SOURCES:
        assert (kernels.library_path(name) != before[name]) == (name in users), name
