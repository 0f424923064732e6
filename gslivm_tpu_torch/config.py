"""Configuration system: two-layer (dataset over common) dataclass configs
(the port's own copy of gslivm_tpu/config.py, which imports no JAX; the two
must stay field-for-field equal, tests/test_torch_training.py checks it).

Mirrors the reference's ROS-parameter config surface (readParameters,
src/liw/lioOptimization.cpp:246-425) and the YAML layering of
launch/livo_*.launch: a dataset yaml (topics, intrinsics, extrinsics) is
loaded OVER config/basic_common.yaml (odometry/ICP/map/gs/gp3d
hyperparameters). Defaults below are the values of basic_common.yaml so a
bare config reproduces the reference's behavior.

All config classes are frozen dataclasses (hashable) so they can be passed
as static arguments to jit'ed functions.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class GsOptimParams:
    """gs: section of basic_common.yaml:55-68 -> OptimizationParameters
    (parameters.cuh:10-36)."""

    scale_factor: float = 3.0
    position_lr_init: float = 0.0005
    position_lr_final: float = 0.0005
    feature_lr: float = 0.001
    percent_dense: float = 0.01
    opacity_lr: float = 0.025
    scaling_lr: float = 0.0025
    rotation_lr: float = 0.0025
    lambda_dssim: float = 0.2
    lambda_depth_simi: float = 0.2
    lambda_delta_depth_simi: float = 0.2
    empty_iterations: int = 200
    adam_eps: float = 1e-15  # gaussian.cu:421-427
    spatial_lr_scale: float = 1.0
    # Optional LR decay horizon (steps; 0 disables — the parity default:
    # the reference DEFINES Expon_lr_func (general_utils.cuh:49-83) with
    # position_lr_init/final fields but never constructs it, so its live
    # path runs constant LRs). When > 0, the xyz group log-lerps
    # position_lr_init -> position_lr_final and the scaling group
    # scaling_lr -> scaling_lr_final over this many steps — needed for
    # long STATIC optimization runs, where constant position/scale LRs
    # keep the geometry oscillating between per-camera fits after
    # convergence (tools/quality_bench.py r4 diagnosis).
    lr_max_steps: int = 0
    scaling_lr_final: float = 0.0025
    # Pruning lifecycle (capability completion of the reference's
    # never-called prune_optimizer, gaussian.cu:430): every prune_interval
    # training iterations the mapper drops gaussians whose activated
    # opacity fell below prune_min_opacity, compacting the Adam state with
    # the same permutation and remapping the hash->index registry. 0
    # disables (exact reference behavior: the map only ever grows).
    prune_interval: int = 500
    prune_min_opacity: float = 0.005
    # Optional max-scale prune criterion (world units; 0 disables — the
    # parity default). Long STATIC optimization runs exhibit the classic
    # 3DGS runaway-blob failure: a few gaussians grow exponentially in
    # scale (measured: max activated scale 0.3 -> 44 m over iters 800-1600
    # at 960x600, tools/quality_bench.py r4 diagnosis) and occlude the
    # scene, degrading PSNR after its peak. The reference never faces this
    # regime — its training window rides a moving sensor stream — and its
    # prune_optimizer is never called at all; this knob lets offline
    # convergence runs cull blobs the way original 3DGS prunes
    # world-size outliers.
    prune_max_scale: float = 0.0


@dataclasses.dataclass(frozen=True)
class GpParams:
    """gp3d: section of basic_common.yaml:70-88 -> GpParameter
    (gp_types.h:78-91)."""

    full_cover: bool = False
    grid: float = 0.2
    min_points_num_to_gp: int = 10
    num_gp_side: int = 4
    neighbour_size: int = 3
    eigen_1: float = 1.0
    max_var_mean: float = 0.30
    variance_sensor: float = 0.05
    kernel_size: float = 1.0
    image_sliding_window: int = 50
    curr_cam_per_iter: int = 1
    history_cam_per_iter: int = 1
    # Deferred colorization (KNOWN DEVIATION — a completion, not a port):
    # the reference marks a voxel added BEFORE checking its colors
    # (added_final_gs_sample insert, gpprocess.cu:804-812) and drops
    # color-invalid gaussians, so a voxel whose GP runs while it is outside
    # the camera image NEVER gets splats — a permanent hole wherever the
    # LiDAR leads the camera (measured: right-wall hole, init PSNR 18.3 ->
    # 9.0 along the r4 quality-bench trajectory, tools/quality_diag.py).
    # Here the visible subset of a voxel's gaussians inserts immediately
    # (reference timing) while the still-unseen REMAINDER waits in a
    # colorization pool and is appended by the first later frame that sees
    # it (HashIndexRegistry grows a second range). This knob caps how many
    # frames a remainder stays a candidate; expired gaussians were seen by
    # no camera and are uninsertable anyway. Negative restores the strict
    # reference behavior (drop the unseen remainder forever).
    pending_colorize_max_age: int = 12

    @property
    def test_side(self) -> int:
        """Test-grid points per side = num_gp_side * neighbour_size
        (gpprocess.cuh:90-91: 4*3 = 12 -> 144 test points)."""
        return self.num_gp_side * self.neighbour_size


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """ModelParameters (parameters.cuh:38-45)."""

    sh_degree: int = 0
    white_background: bool = True
    resolution: int = -1


@dataclasses.dataclass(frozen=True)
class OdometryOptions:
    """odometry_options: basic_common.yaml:10-22 (parameters.h:59-94)."""

    init_voxel_size: float = 0.2
    init_sample_voxel_size: float = 1.0
    voxel_size: float = 0.1
    sample_voxel_size: float = 1.5
    max_distance: float = 2000.0
    max_num_points_in_voxel: int = 10
    init_num_frames: int = 20
    min_distance_points: float = 0.15
    distance_error_threshold: float = 100.0
    motion_compensation: str = "CONSTANT_VELOCITY"
    initialization: str = "INIT_CONSTANT_VELOCITY"


@dataclasses.dataclass(frozen=True)
class IcpOptions:
    """icp_options: basic_common.yaml:24-43 (parameters.h:8-57)."""

    size_voxel_map: float = 1.0
    num_iters_icp: int = 5
    min_number_neighbors: int = 20
    voxel_neighborhood: int = 1
    power_planarity: float = 2.0
    max_number_neighbors: int = 20
    max_dist_to_plane_icp: float = 0.5
    threshold_orientation_norm: float = 0.1
    threshold_translation_norm: float = 0.01
    num_closest_neighbors: int = 1
    threshold_voxel_occupancy: int = 1
    weight_neighborhood: float = 0.5
    weight_alpha: float = 0.5
    min_num_residuals: int = 200
    max_num_residuals: int = 400


@dataclasses.dataclass(frozen=True)
class MapOptions:
    """map_options: basic_common.yaml:45-53 (parameters.h:96-110)."""

    size_voxel_map: float = 0.2
    max_num_points_in_voxel: int = 15
    min_distance_points: float = 0.01
    add_point_step: int = 1
    pub_point_minimum_views: int = 3
    max_delta_trans: float = 0.01
    max_delta_degree: float = 0.03


@dataclasses.dataclass(frozen=True)
class CommonOptions:
    """common: + lidar_parameter: sections of basic_common.yaml:1-8."""

    point_filter_num: int = 4
    image_filter_num: int = 1  # every Nth image (LivoFrontend.push_image)
    # accepted-but-unused, matching the reference: time_sync_en appears in
    # basic_common.yaml:4 but is read nowhere in its source either
    time_sync_en: bool = False
    blind: float = 0.1
    det_range: float = 100.0
    # lidar_parameter/lidar_type (cloudProcessing.h:25 LID_TYPE enum; the
    # reference encodes 1..5, the dataset yamls pick per sensor) — governs
    # the per-vendor time-field decode + sort/clip/decimate normalization
    # (sensors.filter_sweep, rosbag.decode_pointcloud2)
    lidar_type: str = "livox"  # livox|velodyne|ouster|robosense|pandar


@dataclasses.dataclass(frozen=True)
class Config:
    common: CommonOptions = CommonOptions()
    odometry: OdometryOptions = OdometryOptions()
    icp: IcpOptions = IcpOptions()
    map: MapOptions = MapOptions()
    gs: GsOptimParams = GsOptimParams()
    gp: GpParams = GpParams()
    model: ModelParams = ModelParams()


def _apply_overrides(obj: Any, overrides: dict) -> Any:
    """Recursively dataclasses.replace from a nested dict."""
    updates = {}
    for key, val in overrides.items():
        if not hasattr(obj, key):
            raise KeyError(f"unknown config key: {key!r} on {type(obj).__name__}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            updates[key] = _apply_overrides(cur, val)
        else:
            updates[key] = type(cur)(val) if cur is not None else val
    return dataclasses.replace(obj, **updates)


def load_config(dataset_overrides: dict | None = None,
                common_overrides: dict | None = None) -> Config:
    """Two-layer composition: common overrides then dataset overrides, like
    the launch files loading basic_common.yaml then the dataset yaml."""
    cfg = Config()
    if common_overrides:
        cfg = _apply_overrides(cfg, common_overrides)
    if dataset_overrides:
        cfg = _apply_overrides(cfg, dataset_overrides)
    return cfg


def load_yaml(path: str) -> dict:
    """Minimal YAML subset loader (mappings + scalars) for config files.

    Avoids a pyyaml dependency; supports the two-space-indented mapping
    style of the reference's config files.
    """
    root: dict = {}
    stack: list[tuple[int, dict]] = [(-1, root)]
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            indent = len(line) - len(line.lstrip())
            key, _, val = line.lstrip().partition(":")
            val = val.strip()
            while stack and indent <= stack[-1][0]:
                stack.pop()
            parent = stack[-1][1]
            if not val:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = _parse_scalar(val)
    return root


def _parse_scalar(s: str):
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s.strip("\"'")
