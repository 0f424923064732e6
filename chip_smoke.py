#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, tools and mapping paths on
one NVIDIA card and hold its hand-written CUDA kernels against their plain
PyTorch versions.

    python3 chip_smoke.py

The serving path: a saved Gaussian map is loaded onto the card, three
1920x1080 views are rendered through the tile rasterizer (kernel K1,
`gslivm_tpu_torch/csrc/tile_forward.cu`) and each render is scored with
PSNR / SSIM / L1 (the SSIM blur is kernel K3, `csrc/blur.cu`). The map is
the repo's full-size benchmark scene (bench.py): 200,000 gaussians from
numpy.random.default_rng(0), in the JAX parameter layout, carried over with
`convert.params_from_numpy`, written with `save_ply` and read back with
`load_ply`.

The training path: `training.train_step` at the JAX bench's production
step shape (bench.py:196-218): the same map with its colours and positions
perturbed by seeded noise, the three views (the last two a delta-depth
history pair) with the served renders of the unperturbed map as ground
truth and their cached SSIM statistics, 500 anchor points for simi_loss,
default GsOptimParams and RasterizeSettings. One step renders each view
through K1 with checkpoints, scores it with L1 + SSIM (K3 forward and
backward), backpropagates through the backward tile kernel K2
(`csrc/tile_backward.cu`, which returns the gradient summed per gaussian)
and preprocess, and takes a six-group Adam step.

Phases print one JSON line each: env, build, reference (K1's plain version
renders each view: the ground truth the views are scored against), serve
(the serving path, with every kernel launch counter set to 0 just before it
and read just after), profile (torch.profiler over one served view: device
busy time, idle share, kernels by device time), k1_parity (with the pairs
inside each instance's tile-rect, the work of K1's bound), k3_parity (K3 on
view 0's served SSIM stack [15, 1080, 1920] and on the training stack [9,
1080, 1920], each in both tap orientations, with its time, bound, plain
version, a clone of the stack (copy_ms, the card's byte rate at that size)
and F.conv2d (conv2d_ms, the library yardstick), and K3's registers and
blocks per SM from the CUDA runtime), train (10 steps of the training path;
the counters are set to 0 just before its first step and read just after),
train_profile (with the index_add_ kernels left on the step), k2_parity
(K1's checkpoints and K2 against their plain versions at full size, with
the cotangents of view 0's real loss; K2's spread over 5 launches),
tile_usage (registers, local bytes, shared memory and resident blocks per
SM of K1 and K2 as the CUDA runtime reports them for the main path's
launches, and the waves of their blocks), tile_sass (instruction counts of
the same two kernels), grad_parity (the tiles backend's parameter gradients
against the naive backend's on a small scene).

The measurement-tools path (`gslivm_tpu_torch/tools/`), each phase through
the tool's own `run`/`sweep` entry point: kernelcost (K1, K2 and the
differentiable render on fabricated runs of 1, 2, 4 and 8 chunks per tile:
the per-chunk slope and per-tile intercept, with neff == nch asserted in
every tile), t1_fetch (T1, `csrc/microbench_fetch.cu`: per-tile sums of
2,040 runs of 4 chunks read four ways; its launch counter set to 0 just
before the tool's run and read just after; then each variant against its
plain version, and the library yardstick for the aligned case), t2_ablate
(T2, `csrc/microbench_fwdablate.cu`: K1's chunk walk, in K1's warp patches,
at 2,040 tiles x 4 chunks with one piece removed at a time, its counter
around the tool's run, each variant against its plain version at full size
with its registers and blocks per SM, FULL's time per chunk beside K1's
slope from kernelcost, and the SASS instruction counts of each variant
where the toolkit has cuobjdump) and step_profile (the overdraw statistics
and the stage times of the three-camera train step at the JAX tool's
budgets).

The mapping path (`gslivm_tpu_torch/pipeline.py`): 50 synthetic frames at
640x512 with 30,000 points each (`synthetic.make_sequence`, the shape of
BASELINE.json configs[1]), GP grid 0.1, 500 bootstrap points, every other
setting at its default. map_parity ingests the first 5 frames with a CPU
mapper and a card mapper of the port: active counts within 0.5%, equal
registries except voxels with a GP decision within 1e-5 of its threshold
(counted), and gp_forward on the batches of a third GpMap fed the same
frames, on the CPU and on the card, within 1e-3 of scale (the JAX bench's
kernel gate). map runs the
live loop on the card: add_frame, then 10 train_iterations per frame
through K1, K2 and K3 (the counters set to 0 just before it and read just
after; the quality probes are not counted); it reports the map's growth
with Adam's rows, budget refits and escalations, ingest time per frame by
stage, train_iter_ms by CUDA events, one profiled iteration, each
keyframe's PSNR when staged and every keyframe's PSNR/SSIM at the end,
then a forced prune at the 5th percentile of opacity and 20 more steps,
and last holds K1 (with checkpoints), K2 and K3 against their plain
versions at the loop's own shapes (kernel_parity: the views of one
train_iteration at the final capacity and budgets, 640x512, K3 on the
[9, 512, 640] training SSIM stack, its VJP and the [6, 512, 640] stack of
ssim_ref_stats), with the gates of k1_parity, k2_parity and k3_parity.
It asserts finite losses, a growth while Adam's moments are live, Adam's
rows equal to the capacity after every growth and the prune, keyframe 0
up >= 3 dB and the keyframe mean at or above its staged mean.

The system's entry point (`gslivm_tpu_torch/frontend/livo.py` into the
mapper): livo drives the LIVO front end with raw sensor streams of the
synthetic room (`synthetic.dolly_stream`: the e2e test's dolly,
tests/test_e2e_regression.py:41-53, for 50 sweeps at 10 Hz; 24,000 LiDAR
points a sweep, each sampled at its own time; IMU at 200 Hz; one 640x512
RGB image a sweep, fed uncompressed), the e2e test's front-end options,
GP grid 0.1 and 500 bootstrap points; the front end's own frames go to the
mapper with 10 train_iterations a frame (the K1-K3 counters set to 0 just
before the loop and read just after: launches_livo). It prints the front
end's host ms per sweep by stage (sync and IMU, deskew, ICP, colour map,
gray, LK, F-RANSAC, PnP, esikf and photometric, render_recent, emit),
whether the native voxel map is built, the frames emitted, the ATE against
the dolly (asserted < 0.05 m, the e2e floor), ingest and train_iter_ms as
in map with one profiled iteration, the map's size, growths and peak
memory, the staged and final keyframe PSNR (keyframe 0 up >= 3 dB and the
mean at or above its staged mean, asserted), the pipeline fields of
run_synthetic for the serial loop and for a second run through
ConcurrentMapper (the front end's positions asserted equal in both), and
kernel_parity on the serial mapper at its final capacity and budgets, with
map's gates. checkpoint saves that mapper, loads it into a fresh card
mapper (parameters, Adam moments and steps bit-equal, each Adam state keyed
to the restored mapper's own Parameters; registry, loss-anchor keys, colour
pool, GP cells and cameras equal; evaluate() equal), trains 10 more
iterations (finite) and loads the same files into a CPU mapper (parameters
equal), with the bytes and the save and load seconds. run_synthetic runs
`python -m gslivm_tpu_torch.examples.run_synthetic` at its defaults on the
card in a subprocess: exit 0 and every artifact written.

The sharded step (`gslivm_tpu_torch/parallel/`): shard takes the train
phase's state (200,000 gaussians, three 1920x1080 views with a history
pair, its ground truth and anchors) and (a) runs `sharded_train_step` in a
world of one NCCL rank through `python -m
gslivm_tpu_torch.tools.multihost_demo --nproc 1` in a subprocess, for the
"tiles" and "primitive" renderers, against `train_step` from the same state
(loss within 1e-5 relative, every parameter's .grad within 1e-3 of its
scale, overflow 0; the rank sets the K1-K3 counters to 0 just before each
step and reads them just after: launches_shard); with two or more cards it
also runs a real NCCL world of them, else it prints "multi_rank": "1 card".
(b) It runs the per-rank work of a (gauss 2, pixel 2) and a (4, 1) mesh one
rank after another on the card, with no collective: each pixel band of each
view, for "primitive" each depth slab's band (the slabs cut by the
exchange's own packing, `split_depth_slabs`), the slabs folded by
`fold_partials` and the bands stitched, against the single-device render
(rows C, D, A, T within K1's gate and the stop bound) and the per-gaussian
gradients of a fixed loss against the single-device ones; then the pixel
ranks' loss bands of the stitched view 0 against its ground truth for N in
1, 2, 4, 8 (`ssim_band_sum` through K3, `l1_band_sum`,
`delta_depth_band_sum` on views 1 and 2), each K3 call held against the
plain blur; the fwd+bwd time of one rank's band for pixel N in 1, 2, 4, 8
and of one slab for gauss g in 1, 2, 4 by CUDA events with the profiler's
device busy time; each virtual rank's peak memory for "primitive" against
"tiles"; and the bytes each collective would move per step, computed from
the shapes. Its K1-K3 launches are `launches_ranks`.
run_bag writes the livo phase's streams as a ROS1 bag (Livox CustomMsg
with float32 points and integer-ns offsets, IMU at 200 Hz, rgb8 Images)
and runs `python -m gslivm_tpu_torch.examples.run_bag` on it on the card in
a subprocess, with the livo phase's configuration: exit 0, every artifact,
each pose in pose.txt within 1e-4 m of the livo phase's front-end position
after the sweep that emitted the frame, ATE < 0.05 m; it prints the host ms
to read and decode the bag by message type and wall_fps.

The camera intake (`frontend/{jpeg,png,imgproc}.py`, no OpenCV):
bag_compressed's bag holds the livo phase's LiDAR and IMU streams
unchanged and, at each sweep's image time, the dolly camera's view at
r3live's camera (configs/datasets/r3live.yaml: 1280x1024, its topics and
five distortion coefficients; the dolly's intrinsics scaled to that size),
ray-cast through that distortion (`synthetic.render_image(...,
distortion=)`, one spawned process per core) and written as a JPEG
sensor_msgs/CompressedImage at quality 80 by `rosbag.
encode_compressed_image`. codec_parity decodes each of those JPEGs:
entropy decoding on the host (C++), reconstruction on the card and on the
CPU, bit-equal; resize to 640x512 (OpenCV's 2x2 area path) and to 896x716
(its bilinear path), and the 640x512 image remapped through r3live's
undistortion map, each card result bit-equal to the CPU's (integer ops: no
tolerance); it prints the host ms of entropy decoding and of a whole
decode, the CUDA-event ms of reconstruction, resizes and remap (medians
over the images) and the JPEG bytes. bag_compressed runs examples/run_bag
on that bag in a subprocess with a dataset yaml of r3live's camera at
ratio 0.5 with its distortion, so decoding, resize and remap run on the
card: exit 0 and every artifact, poses within 1e-4 m of the livo phase's,
ATE < 0.05 m, and from run_bag's `keyframes:` line keyframe 0 up >= 3 dB
and the keyframe mean at or above its staged mean; it prints wall_fps, the
front end's ms a sweep and decoding ms by message type beside the raw
run_bag phase's, and both bags' bytes. gp_figure runs
`tools/gp_figure.compute(seed=42)` on the card against the CPU within
1e-3 of scale (map_parity's GP gate).

The root tools that drive the mapper and the rasterizer
(`gslivm_tpu_torch/tools/`), each phase through the tool's own `run`,
with the K1-K3 counters set to 0 just before each tool run and read just
after: quality (quality_bench at QUALITY_r05.json's settings: 960x600, 30
keyframes, 30,000 points a frame, GP grid 0.12, 2,000 iterations with the
log-lerped position and scaling rates and a prune every 100, a curve point
every 50; overflow 0 at every curve point, every loss finite and the
tool's 25 dB floor asserted; the final PSNR/SSIM, minimum keyframe, depth
L1, gaussians, prunes, budget refits and escalations, peak memory (with
what the earlier phases hold at its start), and the
train seconds with an idle share estimated from 20 profiled iterations,
beside QUALITY_r05.json's quality, never its TPU times), quality_diag
(init, and oracle at its default spacing: 102,400 splats, 800 iterations),
loop_profile (profile_iteration's stages A, A2, B, D, C with device busy
time, and profile_ingest over 10 frames), blocks (exp_block's sweep of
(2,2), (3,2), (2,3), (4,2), (2,4) on the bench scene: expansion, kept,
busiest tile, fitted budgets, overflow 0 there, fwd+bwd ms and busy ms;
then crosscheck_blocks of each against (2,2) with its gates) and
projection (band_projection for N = 1, 2, 4, 8 with the NVLink rate it
assumes, and scaling_bench on one NCCL rank in this process: N = 1, larger
N reported as needing more cards).

The stage profilers of the 1080p render and its losses, one phase,
stages, its tool runs in a fresh process (late in this one the profiler
drops the records of short windows), which sets the K1-K3 counters to 0
just before them, reads them just after and hands them back:
profile_stages on the bench scene at its budgets (6700*128 instances, 16
chunks, slack 0.2, 2x2; overflow 0 asserted) in its forward
cuts (preprocess, + binning, + feature pack, + fwd kernel, full fwd, the
kernel-only and the FULL fwd+bwd) and its backward cuts (K1 with
checkpoints, K2, + backward to the preprocessed fields, + backward to the
five parameters), profile_binning's
cuts inside bin_instances, microbench_losses (ssim, l1, image_loss, psnr
and the F.conv2d SSIM at 3x1080x1920; the stacked SSIM against five
separate blurs) and microbench_gridsample (the warp and three gathers at
1080x1920, held against each other): each row's ms by CUDA events, device
busy ms, kernels and the busy ms of K1, K2, K3 and the rest (a row whose
profiler records are still not whole when profiled again fails the
phase), with the FULL fwd+bwd's busy ms beside the blocks phase's (2,2)
busy ms of the same run; then K1 and K2 against their plain versions at
profile_stages' budgets and K3 on microbench_losses' [15, 1080, 1920]
SSIM stack and on one [3, 1080, 1920] image (the separate chains' shape)
in both tap orientations against blur_plain (not counted).

Then the card's name and power limit as nvidia-smi prints them, the
kernels table as one JSON line (T1's and T2's `launches` count their tool
runs, the path they belong to; K1-K3 also give `launches_tools`, their
launches in kernelcost and step_profile, and `launches_map`, their
launches in the map loop, `launches_livo`, their launches in the
livo loop, `launches_shard`, their launches in the one-rank sharded
steps, and `launches_quality`, `launches_quality_diag`,
`launches_loop_profile`, `launches_blocks`, `launches_projection` and
`launches_stages`, their launches in those phases, each added into `launches` (0 for T1 and
T2); K1, K2, K3 and T2 carry their
registers and blocks per SM and say where their times before the redesign
stand, which this script does not measure), and last {"ok": true, "device":
{...}}. Any failure raises, prints its traceback and the last phase
printed on stderr, and exits 1; without CUDA, or without the package beside
it (the script alone), the script exits 1 and prints no result.

Tolerances: K1 against its plain version, rows C, D, A, T: max abs
deviation over max(|plain|, 1) per row <= 1e-3 (sequential compositing vs a
prefix product in f32, the hardware exp against torch.exp); at most 0.1% of
pixels may differ in n_contrib and of tiles in neff (a rounding at the 1e-4
stop or the 1/255 alpha test can move them); checkpoints below neff: max
abs <= 1e-3 with at most 0.1% of done flags flipped. K2 against its plain
version (the per-instance rows summed per gaussian by
scatter_instance_grads), per gradient row of the table and per parameter
gradient after preprocess: max abs deviation over the plain version's max
abs <= 1e-3 (pixel sums in another order, sequential T against a prefix
product, the later contributors' sum as the pixel total minus a running
prefix against a suffix scan, a gaussian's instances summed by atomics in
run-to-run order); the same gate holds the tiles backend's
gradients against the naive backend's (the JAX bench's on-chip oracle
gate, bench.py:220-228). K3 against the plain shift-add, both stacks and
both tap orientations: max abs <= 1e-5 (f32 sums of 121 taps in the same
order, FMA allowed). T1 against its plain version, every
variant: relative error <= 1e-5 per tile (f32 sums of 8,192 squares in
another order). T2 against its plain version, every variant, rows C0-T:
max abs deviation over max(|plain|, 1) per row <= 1e-3 (K1's gate:
sequential compositing against the prefix product). shard: the one-rank
sharded step against train_step, loss within 1e-5 relative and .grad
within 1e-3 of scale per parameter; the stitched bands and the folded
slabs against the single render, rows C, D, A, T within 1e-3 of scale
(K1's gate) plus, per pixel, fold_stop_bound times the largest splat
colour (depth for D, 1 for A and T): the early stop fires per slab, so
where a walk stopped the fold and the one-pass render drop different
light, which that bound holds; the primitive gradients against the
single-device ones within GRAD_FOLD_TOL (3e-3 of scale, set from readings:
the largest in every sound run was 2.22e-3; a fold that skips T, run as a
control, must land above it); the kernels' slab path against the plain
versions of the same per-slab semantics, rows and gradients within 1e-3
(K1's and K2's gates). K3 on the pixel ranks' loss bands (a band of
ceil(H/N) rows plus the 5-row halo, for every band of every N in 1, 2, 4,
8): each K3 call against blur_plain on the same input within 1e-5 of
max(|plain|, 1) (K3's gate), and ssim_band_sum's value (1e-5 of
max(|sum|, its element count)) against the same call with the plain
blur, and its VJP no further from the float64 VJP than twice the plain
f32 VJP's distance (or 1e-5 of scale: f32 rounding alone moves it by
~1e-4 where flat regions cancel large cotangents); the
band sums of SSIM, L1 and delta-depth add up to the full-frame sums
within 1e-5 relative. run_bag:
poses within 1e-4 m of the livo phase's (the bag holds float32 points and
integer-ns times). codec_parity: the card's reconstruction, resizes and
remap equal the CPU's in every value (integer ops: no tolerance).
bag_compressed: as run_bag, and keyframe 0 up >= 3 dB with the mean at or
above its staged mean, as in livo. gp_figure: 1e-3 of scale
(map_parity's GP gate). blocks: crosscheck_blocks' own gates, color,
depth and acc within max |diff| < 5e-4 and each of the five gradients
within 2e-3 of the (2,2) gradient's max (tools/crosscheck_blocks.py).
quality: the tool's 25 dB floor on the final PSNR. stages: overflow 0 at
profile_stages' budgets; the grid-sample variants within 1e-6 of scale of
each other; K1 and K2 at K1's and K2's gates above; K3 max abs <= 1e-5
(k3_parity's gate).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
N_GAUSS = 200_000
VIEWS = ([0.0, 0.0, 0.0], [0.05, 0.0, 0.0], [0.0, 0.05, 0.0])  # bench.py:95, 200-203
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) flop/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# flops per (instance, pixel) pair that K1 evaluates: dx, dy (2), the conic
# quadratic (9), exp (counted 2), alpha and its tests (2)
K1_FLOPS_PER_PAIR = 15
# K2 evaluates every pair once as K1 does (15), and for each
# contributing pair forms psi (7), dL/dalpha (6), d opacity and d power (3),
# u and v (2) and adds 10 gradient terms (12 more products): 30
K2_FLOPS_PER_CONTRIB = 30
TRAIN_STEPS = 10
SIMI_SEED = 1
# where the times of the redesigned kernels (K1, K2, K3, T2) before their
# redesign stand; this script measures only the kernels in the checkout
EARLIER_TIMES = "PERF.md section 6"
# the mapping configuration: BASELINE.json configs[1]'s shape (50 keyframes,
# ~200k gaussians, 640x512) on the repo's synthetic scene, at
# examples/offline_fit.py's GP grid and tools/quality_bench.py's bootstrap
MAP_FRAMES, MAP_W, MAP_H, MAP_POINTS = 50, 640, 512, 30_000
MAP_GRID, MAP_BOOTSTRAP = 0.1, 500
MAP_ITERS = 10          # train iterations per frame (ConcurrentMapper's default)
MAP_PARITY_FRAMES = 5
MAP_AFTER_PRUNE = 20    # steps after the forced prune
# the JAX package's ingest of this configuration on a CPU (all 50 frames,
# naive backend, no training): the gaussian count the port should reach
JAX_CPU_GAUSSIANS = 179_672
# the LIVO configuration: the system's entry point, raw sensors to map. The
# e2e dolly (tests/test_e2e_regression.py:41-53) for 50 sweeps at 10 Hz;
# 24,000 LiDAR points a sweep (a Livox Avia's 240k points/s), each sampled at
# its own time; IMU at 200 Hz; one 640x512 RGB image a sweep (r3live's
# 1280x1024 at ratio 0.5, configs/datasets/r3live.yaml:8-10); the e2e test's
# front-end options, GP grid 0.1 and 500 bootstrap points as in `map`
LIVO_SWEEPS, LIVO_W, LIVO_H, LIVO_POINTS = 50, 640, 512, 24_000
LIVO_ITERS = 10
LIVO_ATE_MAX = 0.05  # the e2e floor (test_e2e_regression.py:211)
LIVO_CHECKPOINT_ITERS = 10
# the sharded step (shard): the train phase's state, full width; the per-rank
# work of these meshes runs one rank after another on the card
SHARD_MESHES = ((2, 2), (4, 1))
SHARD_PIXEL_N = (1, 2, 4, 8)
SHARD_GAUSS_G = (1, 2, 4)
SHARD_BLOCK = (2, 2)            # RasterizeSettings' supertile, as in the train phase
SHARD_MAX_INSTANCES = 1 << 20   # RasterizeSettings' budget, per band or slab
SHARD_SLACK = 4.0               # sharded_train_step's exchange_slack default
SHARD_FLOATS = 14               # xyz 3, f_dc 3, f_rest 0, scaling 3, rotation 4, opacity 1
EXCHANGE_ROWS = 17              # 15 screen rows, the slab position, the occupied flag
# the primitive gradients against the single-device step's (scale-relative):
# the per-slab stop moves them deterministically, by 2.22e-3 at most in
# every sound run of this phase on the bench scene (PERF.md section 6);
# no bound is derived for them, so the gate sits above those readings and
# a control (a fold that skips T) must exceed it
GRAD_FOLD_TOL = 3e-3
# the ROS-bag entry point (run_bag): the livo phase's streams written as a bag
BAG_TOPICS = {"imu": "/livox/imu", "lidar": "/livox/lidar", "image": "/camera/image"}
# the camera intake (codec_parity, bag_compressed): the livo streams with each
# image at r3live's camera (configs/datasets/r3live.yaml: its topics, 1280x1024,
# resize ratio 0.5, its five distortion coefficients), ray-cast through that
# distortion and JPEG-encoded at compressed_image_transport's default quality
R3LIVE_YAML = os.path.join(ROOT, "configs", "datasets", "r3live.yaml")
JPEG_QUALITY = 80
ODD_RESIZE = (896, 716)  # the non-integer ratio 0.7 of 1280x1024: OpenCV's bilinear path
# the root tools' slice: quality_bench at QUALITY_r05.json's settings (the
# tool's defaults, 960x600, 30 keyframes, 30,000 points a frame, GP grid
# 0.12, with 2,000 iterations and a curve point every 50), and the JAX
# reference's record of that run (quality only: its times are a TPU's)
QUALITY_ARGV = ["--iters", "2000", "--curve-every", "50"]
QUALITY_RECORD = os.path.join(ROOT, "QUALITY_r05.json")
QUALITY_RECORD_KEYS = ("final_psnr", "final_ssim", "min_keyframe_psnr", "depth_l1_inv",
                       "gaussians", "keyframes", "resolution", "iters")
QUALITY_PROFILE_ITERS = 20   # iterations of the trained map under the profiler
# quality_diag's oracle at its default spacing (102,400 splats); its
# iterations are the first cut should the script outgrow its time limit
DIAG_ORACLE_ITERS = 800
PROJECTION_DEVICES = (1, 2, 4, 8)
# scaling_bench on one NCCL rank: N = 1 runs, N = 2 and 4 are reported as
# needing more cards
SCALING_ARGV = ["--devices", "1", "2", "4", "--phases"]
NEW_PHASES = ("quality", "quality_diag", "loop_profile", "blocks", "projection", "stages")


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)
    emit.last_phase = phase


emit.last_phase = None


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scaled_err(a, b) -> float:
    """max |a - b| over max |b| (b the plain version or the oracle)."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)


def sass_counts(lib_path) -> dict | None:
    """Instruction counts by opcode of each kernel in a built library, from
    `cuobjdump -sass`; None where the toolkit has no cuobjdump."""
    from collections import Counter

    from torch.utils.cpp_extension import CUDA_HOME

    exe = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), Counter())
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)",
                      line)
        if m and cur is not None:
            cur["total"] += 1
            op = m.group(1)
            for key in ("MUFU.EX2", "BAR.SYNC", "LDS", "LDG", "FFMA", "FMUL", "FADD",
                        "FSETP", "FMNMX", "SHFL", "VOTE", "RED"):
                if op == key or op.startswith(key + "."):
                    cur[key] += 1
    return {name: dict(c) for name, c in counts.items()}


def walked_slots(binned, neff):
    """(tile, slot) of every instance a tile kernel walks: the first
    min(cnt_allowed, 128 neff) instances of each tile's run."""
    import torch

    from gslivm_tpu_torch.ops.binning import CHUNK

    n = torch.minimum(binned.cnt_allowed.long(), neff.long() * CHUNK)
    tile = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    first = torch.cumsum(n, 0) - n
    pos = torch.arange(int(n.sum()), device=n.device) - first[tile]
    return tile, binned.sorted_start.long()[tile] + pos


def rect_pairs(inst, binned, neff, cfg) -> int:
    """The walked (instance, pixel) pairs whose pixel lies inside the
    instance's 16x16 tile-rect (every walked pair without the rect test):
    the pairs any design has to evaluate."""
    from gslivm_tpu_torch.ops import rasterize_tiles as rt

    tile, slot = walked_slots(binned, neff)
    if not cfg.rect_test:
        return int(slot.numel()) * cfg.npix
    r = inst[slot]
    x0 = (tile % cfg.grid_x * cfg.pw).float()
    y0 = (tile // cfg.grid_x * cfg.ph).float()
    ox = (r[:, rt._FX1].minimum(x0 + cfg.pw) - r[:, rt._FX0].maximum(x0)).clamp(min=0)
    oy = (r[:, rt._FY1].minimum(y0 + cfg.ph) - r[:, rt._FY0].maximum(y0)).clamp(min=0)
    return int((ox * oy).long().sum())


def make_simi(rng):
    """500 anchor points around the scene and 2048 gaussian indices, about
    half of each masked in, as numpy arrays (SimiInputs fields)."""
    return {"points": rng.normal(0, 2.0, (500, 3)) + [0, 0, 6.0],
            "point_mask": rng.uniform(size=500) < 0.5,
            "gauss_idx": rng.integers(0, N_GAUSS, 2048),
            "gauss_mask": rng.uniform(size=2048) < 0.5}


def make_map():
    """The bench.py scene (bench.py:87-94) in the JAX parameter layout."""
    rng = np.random.default_rng(0)
    n = N_GAUSS
    means = rng.normal(0, 2.0, (n, 3)) + [0, 0, 6.0]
    scales = rng.uniform(0.01, 0.05, (n, 3))
    q = rng.normal(size=(n, 4))
    quats = q / np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, (n,))
    shs = rng.uniform(-0.3, 0.8, (n, 1, 3))
    return {
        "xyz": means.astype(np.float32),
        "features_dc": shs.astype(np.float32),
        "features_rest": np.zeros((n, 0, 3), np.float32),
        "scaling": np.log(scales).astype(np.float32),
        "rotation": quats.astype(np.float32),
        "opacity": np.log(opac / (1.0 - opac))[:, None].astype(np.float32),
        "n_active": np.int32(n),
    }


def frame_to(frame, dev):
    """A pipeline Frame with its camera and projection tensors on dev."""
    import dataclasses

    cam = dataclasses.replace(frame.camera, **{
        f.name: getattr(frame.camera, f.name).to(dev)
        for f in dataclasses.fields(frame.camera) if f.name not in ("width", "height")})
    return frame._replace(camera=cam, cam_projection=type(frame.cam_projection)(
        *(t.to(dev) for t in frame.cam_projection)))


def nan_scaled_err(a, b) -> float:
    """scaled_err over the entries where b is not NaN; inf if the NaNs differ."""
    import torch

    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return float("inf")
    ok = ~torch.isnan(b)
    return scaled_err(a[ok], b[ok]) if bool(ok.any()) else 0.0


def map_parity(frames_cpu, frames_gpu, cfg, dev):
    """The first frames of the mapping configuration ingested by a CPU
    mapper and a card mapper of the port, with a third GpMap on the CPU fed
    the same frames as the mappers feed theirs: its batches go through
    gp_forward on the CPU and on the card. Returns the phase's fields;
    raises if a count or the GP disagrees beyond its gate, or if a voxel is
    in one registry only without a GP decision (var_mean against the reopen
    gate or the [0, 1] error bounds) within 1e-5 of its threshold."""
    import torch

    from gslivm_tpu_torch import pipeline
    from gslivm_tpu_torch.frontend import gpmap
    from gslivm_tpu_torch.ops import gp3d

    mappers = {d: pipeline.IncrementalMapper(cfg, bootstrap_points=MAP_BOOTSTRAP, device=d)
               for d in ("cpu", dev)}
    t0 = time.perf_counter()
    for fc, fg in zip(frames_cpu, frames_gpu):
        sc, sg = mappers["cpu"].add_frame(fc), mappers[dev].add_frame(fg)
    seconds = time.perf_counter() - t0
    cpu, gpu = mappers["cpu"], mappers[dev]

    # the GP on the same batches, on the CPU and on the card
    gmap, recs = gpmap.GpMap(cfg.gp, device="cpu"), []
    gp_err, mask_flips = 0.0, 0
    for fc in frames_cpu:
        div = gmap.divide_points(fc.points_world)
        rc = gp3d.gp_forward(div.batch, cfg.gp)
        rg = gp3d.gp_forward(gp3d.GpBatch(*(t.to(dev) for t in div.batch)), cfg.gp)
        for f in gp3d.GpResult._fields:
            a, b = getattr(rg, f).cpu(), getattr(rc, f)
            if b.dtype == torch.bool:
                mask_flips += int((a != b).sum())
            else:
                gp_err = max(gp_err, nan_scaled_err(a, b))
        gmap.update_variance(div.hashes, rc.reopen.numpy(), rc.update_variance.numpy())
        recs.append((div.hashes, div.batch.mask, rc.var_mean, rg.var_mean.cpu()))
    # a voxel in one registry only: its nearest GP decision to a threshold
    only = set(cpu.registry._ranges) ^ set(gpu.registry._ranges)
    margins = dict.fromkeys(only, 1.0)
    if only:
        thr = cfg.gp.max_var_mean
        for hashes, live, *var_means in recs:
            for vm in var_means:
                vm = vm.double()[live]
                dist = torch.stack([(vm - thr).abs(), vm.abs(), (vm - 1).abs()]).amin(0)
                for h, d in zip(hashes[live.numpy()], dist.tolist()):
                    if int(h) in only:
                        margins[int(h)] = min(margins[int(h)], d)
    near = {h for h in only if margins[h] <= 1e-5}
    active = (sc["active"], sg["active"])
    out = {"frames": len(frames_cpu), "active_cpu": active[0], "active_card": active[1],
           "active_rel_diff": abs(active[0] - active[1]) / active[0],
           "registry_cpu": len(cpu.registry), "registry_card": len(gpu.registry),
           "registry_only_one_side": len(only), "of_them_within_1e-5_of_a_threshold": len(near),
           "gp_batches": len(recs), "gp_max_scaled_err": gp_err, "gp_tol": 1e-3,
           "gp_mask_flips": mask_flips, "stats_cpu": sc, "stats_card": sg,
           "ingest_seconds_both": seconds}
    assert out["active_rel_diff"] <= 5e-3, out
    assert gp_err <= 1e-3, out
    assert only == near, (sorted(only - near)[:10], out)
    return out


def tile_kernel_parity(table, binned, cfg, cotangent, depth_grad, k1):
    """K1 with its checkpoints and K2 against their plain versions on one
    binned render. Adds K1's worst scaled row error and its n_contrib,
    neff and checkpoint disagreements into the dict k1; K2 takes the tile
    cotangent `cotangent(tiles)` (tiles from K1). Returns (K2's per-gaussian
    rows, the plain ones, K2's worst scaled row error, K1's tiles)."""
    import torch

    from gslivm_tpu_torch.ops import rasterize_tiles as rt

    dev = table.device
    with torch.no_grad():
        inst = table.detach().t()[binned.gid_sorted.long()].contiguous()
        kargs = (inst, binned.sorted_start, binned.tile_nchunks, binned.cnt_allowed, cfg)
        tiles, ckpt = rt.composite_tiles(*kargs, save_ckpt=True)
        ptiles, pckpt = rt.composite_tiles_plain(*kargs, save_ckpt=True)
        for row in range(6):
            scale = max(float(ptiles[:, row].abs().max()), 1.0)
            k1["rows"] = max(k1["rows"],
                             float((tiles[:, row] - ptiles[:, row]).abs().max()) / scale)
        k1["ncontrib"] += int((tiles[:, 6] != ptiles[:, 6]).sum())
        k1["neff"] += int((tiles[:, 7, 0] != ptiles[:, 7, 0]).sum())
        neff = torch.maximum(tiles[:, 7, 0], ptiles[:, 7, 0]).long()
        walked = torch.arange(cfg.max_chunks, device=dev)[None, :] < neff[:, None]
        if bool(walked.any()):
            k1["ckpt"] = max(k1["ckpt"], float((ckpt.abs() - pckpt.abs())[walked].abs().max()))
        k1["flags"] += int(((ckpt < 0) != (pckpt < 0))[walked].sum())
        k1["pixels"] += cfg.num_tiles * cfg.npix
        k1["tiles"] += cfg.num_tiles
        k1["ckpt_values"] += int(walked.sum()) * cfg.npix
        del ptiles, pckpt
    g_tiles = cotangent(tiles).contiguous()
    bwd_args = (inst, binned.sorted_start, binned.cnt_allowed, g_tiles, tiles, ckpt, cfg)
    n = table.shape[1]
    with torch.no_grad():
        d_k = rt.composite_tiles_bwd(*bwd_args, n, depth_grad)
        d_p = rt.scatter_instance_grads(rt.composite_tiles_bwd_plain(*bwd_args, depth_grad),
                                        n, depth_grad)
    return d_k, d_p, max(scaled_err(d_k[c], d_p[c]) for c in range(10)), tiles


def k1_fields(k1) -> dict:
    return {"k1_max_scaled_err": k1["rows"], "k1_ncontrib_mismatch_pixels": k1["ncontrib"],
            "pixels": k1["pixels"], "k1_neff_mismatch_tiles": k1["neff"], "tiles": k1["tiles"],
            "ckpt_max_abs_err": k1["ckpt"], "ckpt_flag_flips": k1["flags"],
            "ckpt_walked_values": k1["ckpt_values"]}


def check_k1(k1):
    """k1_parity's gates: rows and checkpoints 1e-3 of scale, at most 0.1%
    of pixels, tiles and checkpoint values disagreeing."""
    assert k1["rows"] <= 1e-3 and k1["ckpt"] <= 1e-3, k1
    assert k1["ncontrib"] <= 1e-3 * k1["pixels"] and k1["neff"] <= 1e-3 * k1["tiles"], k1
    assert k1["flags"] <= 1e-3 * k1["ckpt_values"], k1


def map_kernel_parity(mapper, dev, size=(MAP_W, MAP_H)):
    """K1, K2 and K3 against their plain versions at the map loop's own
    shapes: the views of one train_iteration drawn by the mapper's sampler,
    binned at its current capacity and refitted budgets, the cotangents of
    each view's image loss (L1 + SSIM against the staged GT statistics).
    Gates as k1_parity and k2_parity (scaled 1e-3, flips <= 0.1%) and
    k3_parity (max abs 1e-5) for the training SSIM stack, its VJP, and the
    staging stack of ssim_ref_stats. Returns the fields; raises on a gate."""
    import torch

    from gslivm_tpu_torch.models import training
    from gslivm_tpu_torch.ops import blur, losses, rasterize_reference
    from gslivm_tpu_torch.ops import rasterize_tiles as rt

    p, st = mapper.params, mapper.settings
    curr, hist = mapper._sample_cameras()
    views = curr + [i for pair in hist for i in pair]
    lam, dg = training.GsOptimParams().lambda_dssim, st.depth_grad
    taps = losses.gaussian_1d()
    k1 = dict.fromkeys(("rows", "ncontrib", "neff", "ckpt", "flags", "pixels", "tiles",
                        "ckpt_values"), 0)
    k2, param_err, k3, shapes = 0.0, {}, {}, []
    for i in views:
        cam, gt = mapper.cameras[i], mapper._gt_device[i]
        w, h = cam.width, cam.height
        pre = rasterize_reference.preprocess(
            p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity()[:, 0],
            p.get_features(), cam, active_mask=p.active_mask())
        table, binned, cfg = rt.bin_tiles(
            pre, w, h, max_instances=st.max_instances,
            max_chunks_per_tile=st.max_chunks_per_tile, capacity_slack=st.capacity_slack,
            block_x=st.block_x, block_y=st.block_y, contrib_stats=False)
        color = None

        def image_loss_cotangent(tiles, i=i, gt=gt):
            nonlocal color
            tiles_g = tiles.clone().requires_grad_(True)
            img = rt.tiles_to_image(tiles_g, cfg)[:, :h, :w]
            color = img[0:3] + img[5][None] * mapper._bg[:, None, None]
            loss = (1.0 - lam) * losses.l1_loss(color, gt) + lam * (
                1.0 - losses.ssim(color, gt, ref_stats=mapper._gt_stats[i]))
            return torch.autograd.grad(loss, tiles_g)[0]

        d_k, d_p, err, _ = tile_kernel_parity(table, binned, cfg, image_loss_cotangent, dg, k1)
        k2 = max(k2, err)
        leaves = {"xyz": p.xyz, "scaling": p.scaling, "rotation": p.rotation,
                  "opacity": p.opacity, "features_dc": p.features_dc}
        gk = torch.autograd.grad(table, list(leaves.values()), d_k, retain_graph=True)
        gp = torch.autograd.grad(table, list(leaves.values()), d_p)
        for name, a, b in zip(leaves, gk, gp):
            param_err[name] = max(param_err.get(name, 0.0), scaled_err(a, b))
        del d_k, d_p, table, pre
        # K3 on the stacks the step and the staging blur: ssim against the
        # cached GT statistics blurs [a, a^2, ab] (9 slices, its VJP the
        # reversed taps), ssim_ref_stats blurs [b, b^2] (6 slices)
        a, b = color.detach(), gt
        stacks = {"train": torch.cat([a, a * a, a * b]).contiguous(),
                  "ref_stats": torch.cat([b, b * b]).contiguous()}
        with torch.no_grad():
            for key, x in stacks.items():
                for orient, t in (("taps", taps), ("reversed", taps[::-1])):
                    e = float((blur.blur_cuda(x, t) - blur.blur_plain(x, t)).abs().max())
                    k3[f"{key}_{orient}"] = max(k3.get(f"{key}_{orient}", 0.0), e)
        x = stacks["train"].clone().requires_grad_(True)
        g = torch.rand_like(x)
        (vjp,) = torch.autograd.grad(blur.blur_many(x, taps), x, g)
        e = float((vjp - blur.blur_plain(g, taps[::-1])).abs().max())
        k3["train_vjp"] = max(k3.get("train_vjp", 0.0), e)
        shapes.append({"view": i, "width": w, "height": h, "tiles": cfg.num_tiles,
                       "max_chunks": cfg.max_chunks,
                       "k3_stacks": {k: list(v.shape) for k, v in stacks.items()}})
        del stacks, x, g, vjp
    out = {"views": shapes, "capacity": p.capacity, "max_instances": st.max_instances,
           "max_chunks_per_tile": st.max_chunks_per_tile, **k1_fields(k1),
           "k2_max_scaled_err": k2, "k2_param_scaled_err": param_err, "k1_k2_tol": 1e-3,
           "k3_max_abs_err": k3, "k3_tol": 1e-5}
    assert views and all((v["width"], v["height"]) == size for v in shapes), out
    check_k1(k1)
    assert k2 <= 1e-3 and max(param_err.values()) <= 1e-3, out
    assert max(k3.values()) <= 1e-5, out
    return out


def map_loop(frames, cfg, dev, profiled, counters):
    """The live mapping loop on the card: add_frame, then MAP_ITERS
    train_iterations per frame, over every frame; then a forced prune and
    MAP_AFTER_PRUNE more steps. `counters` are the launch-counted kernel
    wrappers; they count the loop (ingest and training) and nothing of the
    quality probes. Returns (phase fields, launches by kernel)."""
    import torch

    from gslivm_tpu_torch import pipeline

    mapper = pipeline.IncrementalMapper(cfg, bootstrap_points=MAP_BOOTSTRAP, device=dev)

    def adam_rows():
        """(every moment has `capacity` rows, any moment is non-zero)"""
        moments = [mapper.optimizer.state[p][k] for g in mapper.optimizer.param_groups
                   for p in g["params"] if p in mapper.optimizer.state
                   for k in ("exp_avg", "exp_avg_sq")]
        return (all(m.shape[0] == mapper.params.capacity for m in moments),
                any(bool(m.any()) for m in moments))

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t_phase = time.perf_counter()
    capacity, growths, ingest, staged, losses_, events = [mapper.params.capacity], [], [], [], [], []
    train_launches = dict.fromkeys(counters, 0)
    for fr in frames:
        kf = len(mapper.cameras)
        t0 = time.perf_counter()
        stats = mapper.add_frame(fr)
        torch.cuda.synchronize()
        ingest.append({"total": time.perf_counter() - t0, **mapper.ingest_seconds})
        if mapper.params.capacity != capacity[-1]:
            rows_ok, live = adam_rows()
            growths.append({"frame": len(ingest) - 1, "from": capacity[-1],
                            "to": mapper.params.capacity, "adam_rows_equal_capacity": rows_ok,
                            "adam_moments_nonzero": live})
            capacity.append(mapper.params.capacity)
        if len(mapper.cameras) > kf:  # staged: its score before training on it
            staged.append(uncounted(counters, lambda: mapper.score_keyframe(kf)))
        before = {k: c.launches for k, c in counters.items()}
        frame_losses = []
        for _ in range(MAP_ITERS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            m = mapper.train_iteration()
            e1.record()
            if m is not None:
                events.append((e0, e1))
                frame_losses.append(m.loss)
        for k, c in counters.items():
            train_launches[k] += c.launches - before[k]
        if frame_losses:  # one read per frame
            losses_.append(torch.stack(frame_losses).cpu())
    torch.cuda.synchronize()
    loop_seconds = time.perf_counter() - t_phase
    launches = {k: c.launches for k, c in counters.items()}
    iter_ms = np.asarray([a.elapsed_time(b) for a, b in events])
    all_losses = torch.cat(losses_).numpy()
    assert np.isfinite(all_losses).all(), all_losses
    prof = uncounted(counters, lambda: profiled(mapper.train_iteration))

    final = uncounted(counters, lambda: torch.stack([mapper.score_keyframe(i)
                                           for i in range(len(mapper.cameras))]))
    final, staged = final.cpu().numpy(), torch.stack(staged).cpu().numpy()
    gaussians, voxels = int(mapper.params.n_active), len(mapper.registry)

    # a forced prune at the 5th percentile of opacity: compact_opt_state on
    # live moments, then training goes on
    with torch.no_grad():
        cut = float(mapper.params.get_opacity()[:gaussians, 0].quantile(0.05))
    moments_live = adam_rows()[1]
    dropped = uncounted(counters, lambda: mapper.prune_map(min_opacity=cut))
    rows_after_prune = adam_rows()[0]
    after = uncounted(counters, lambda: torch.stack([mapper.train_iteration().loss
                                           for _ in range(MAP_AFTER_PRUNE)]).cpu().numpy())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9  # before the plain versions' buffers
    # the loop's kernels against their plain versions at its own shapes,
    # capacity and budgets
    kernel_parity = uncounted(counters, lambda: map_kernel_parity(mapper, dev))
    stage = {k: [f[k] * 1e3 for f in ingest] for k in ingest[0]}
    out = {
        "config": {"frames": len(frames), "width": MAP_W, "height": MAP_H,
                   "points_per_frame": MAP_POINTS, "grid": MAP_GRID,
                   "bootstrap_points": MAP_BOOTSTRAP, "iters_per_frame": MAP_ITERS},
        "gaussians": gaussians, "gaussians_after_last_ingest": stats["active"],
        "jax_cpu_gaussians": JAX_CPU_GAUSSIANS,
        "rel_diff_to_jax_cpu": stats["active"] / JAX_CPU_GAUSSIANS - 1.0,
        "keyframes": len(mapper.cameras), "registry_voxels": voxels,
        "registry_voxels_after_prune": len(mapper.registry),
        "loss_anchors": len(mapper.loss_anchors), "last_stats": stats,
        "capacity_history": capacity, "growths": growths,
        "budget_refits": mapper.budget_refits, "escalations": mapper.overflow_escalations,
        "last_overflow": mapper.last_overflow,
        "settings": {"max_instances": mapper.settings.max_instances,
                     "max_chunks_per_tile": mapper.settings.max_chunks_per_tile},
        "train_iterations": len(iter_ms),
        "ingest_ms_median": {k: float(np.median(v)) for k, v in stage.items()},
        "ingest_ms_max": {k: float(np.max(v)) for k, v in stage.items()},
        "train_iter_ms_median": float(np.median(iter_ms)),
        "train_iter_ms_p90": float(np.percentile(iter_ms, 90)),
        "train_iter_ms_mean": float(iter_ms.mean()),
        "profiled_iteration": {k: v for k, v in prof.items() if k != "top"},
        "profiled_top": prof["top"][:6],
        "launches": launches, "launches_train": train_launches,
        "launches_per_iteration": {k: v / len(iter_ms) for k, v in train_launches.items()},
        "loss_first_last": [float(all_losses[0]), float(all_losses[-1])],
        "psnr_staged": staged[:, 0].tolist(), "psnr_final": final[:, 0].tolist(),
        "ssim_final": final[:, 1].tolist(),
        "kf0_psnr_staged_final": [float(staged[0, 0]), float(final[0, 0])],
        "mean_psnr_staged_final": [float(staged[:, 0].mean()), float(final[:, 0].mean())],
        "mean_ssim_staged_final": [float(staged[:, 1].mean()), float(final[:, 1].mean())],
        "prune_min_opacity": cut, "pruned": dropped, "adam_moments_live_at_prune": moments_live,
        "adam_rows_equal_capacity_after_prune": rows_after_prune,
        "losses_after_prune_first_last": [float(after[0]), float(after[-1])],
        "kernel_parity": kernel_parity,
        "memory_at_start_gb": mem0 / 1e9,
        "peak_memory_gb": peak_gb,
        "loop_seconds": loop_seconds,
    }
    assert len(mapper.cameras) == len(frames), out
    assert any(g["adam_moments_nonzero"] for g in growths), out
    assert all(g["adam_rows_equal_capacity"] for g in growths) and rows_after_prune, out
    assert moments_live and dropped > 0 and np.isfinite(after).all(), out
    assert final[0, 0] >= staged[0, 0] + 3.0, out["kf0_psnr_staged_final"]
    assert final[:, 0].mean() >= staged[:, 0].mean(), out["mean_psnr_staged_final"]
    assert all(v > 0 for v in launches.values()), launches
    return out, launches


def livo_config():
    """The LIVO configuration: the e2e test's front-end options
    (test_e2e_regression.py:61-69) with the map phase's GP grid."""
    from gslivm_tpu_torch.config import Config, GpParams, IcpOptions, OdometryOptions

    return Config(
        gp=GpParams(grid=MAP_GRID),
        odometry=OdometryOptions(init_num_frames=2, voxel_size=0.05, sample_voxel_size=0.6,
                                 init_voxel_size=0.05, init_sample_voxel_size=0.6),
        icp=IcpOptions(min_number_neighbors=8, max_num_residuals=300, size_voxel_map=0.5,
                       num_iters_icp=6))


def livo_frontend(stream, cfg, dev):
    """A LivoFrontend on the stream's camera, its ESKF initialised by the
    stream's static IMU samples."""
    from gslivm_tpu_torch.frontend.livo import LivoFrontend

    fe = LivoFrontend(config=cfg, fx=stream.fx, fy=stream.fy, cx=stream.cx, cy=stream.cy,
                      width=LIVO_W, height=LIVO_H, device=dev)
    for s in stream.init_imu:
        fe.push_imu(*s)
    return fe


def push_sweep(fe, sweep):
    """One sweep's raw data into the front end; returns the frames it emitted."""
    fe.push_lidar(sweep.lidar)
    for s in sweep.imu:
        fe.push_imu(*s)
    fe.push_image(sweep.image_time, sweep.image)
    return fe.pop_frames()


def pipeline_fields(mode, sweeps, trained, wall, frontend_s, mapper_s) -> dict:
    """The `pipeline:` line of examples/run_synthetic.py."""
    serial_sum = frontend_s + mapper_s
    return {"mode": mode, "frames": sweeps, "train_iters": trained, "wall_s": wall,
            "frontend_s": frontend_s, "mapper_busy_s": mapper_s, "serial_sum_s": serial_sum,
            "overlap_gain": serial_sum / wall, "wall_fps": sweeps / wall}


def livo_serial(stream, cfg, dev, profiled, counters):
    """The system's main path, serial: each sweep's raw data through the
    LIVO front end, its frames to the mapper, LIVO_ITERS train_iterations
    a frame. `counters` count the loop (ingest and training), none of the
    quality probes. Returns (phase fields, launches by kernel, mapper, the
    front end's position after each sweep)."""
    import torch

    from gslivm_tpu_torch import pipeline
    from gslivm_tpu_torch.frontend import native

    fe = livo_frontend(stream, cfg, dev)
    mapper = pipeline.IncrementalMapper(cfg, bootstrap_points=MAP_BOOTSTRAP, device=dev)

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    capacity, growths, ingest, staged, losses_, events = [mapper.params.capacity], [], [], [], [], []
    stages, est, gt, n_frames, per_sweep = [], [], [], 0, []
    t_frontend = t_mapper = t_probe = 0.0
    t_loop = time.perf_counter()
    for sweep in stream.sweeps:
        fe.stage_seconds.clear()
        t0 = time.perf_counter()
        frames = push_sweep(fe, sweep)
        t_frontend += time.perf_counter() - t0
        stages.append(dict(fe.stage_seconds))
        per_sweep.append(len(frames))
        est.append(fe.pose[1])
        gt.append(sweep.gt_displacement)
        n_frames += len(frames)
        for fr in frames:
            kf = len(mapper.cameras)
            t0 = time.perf_counter()
            stats = mapper.add_frame(fr)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ingest.append({"total": t1 - t0, **mapper.ingest_seconds})
            if mapper.params.capacity != capacity[-1]:
                growths.append({"sweep": len(stages) - 1, "from": capacity[-1],
                                "to": mapper.params.capacity})
                capacity.append(mapper.params.capacity)
            if len(mapper.cameras) > kf:  # staged: its score before training on it
                staged.append(uncounted(counters, lambda: mapper.score_keyframe(kf)))
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            t_probe += t2 - t1
            frame_losses = []
            for _ in range(LIVO_ITERS):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                m = mapper.train_iteration()
                e1.record()
                if m is not None:
                    events.append((e0, e1))
                    frame_losses.append(m.loss)
            if frame_losses:  # one read per frame
                losses_.append(torch.stack(frame_losses).cpu())
            t_mapper += (t1 - t0) + time.perf_counter() - t2
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_loop - t_probe  # the loop without the staged probes
    launches = {k: c.launches for k, c in counters.items()}
    iter_ms = np.asarray([a.elapsed_time(b) for a, b in events])
    all_losses = torch.cat(losses_).numpy()
    assert np.isfinite(all_losses).all(), all_losses
    prof = uncounted(counters, lambda: profiled(mapper.train_iteration))
    final = uncounted(counters, lambda: torch.stack([mapper.score_keyframe(i)
                                           for i in range(len(mapper.cameras))]))
    final, staged = final.cpu().numpy(), torch.stack(staged).cpu().numpy()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernel_parity = uncounted(counters,
                              lambda: map_kernel_parity(mapper, dev, (LIVO_W, LIVO_H)))
    est, gt = np.asarray(est), np.asarray(gt)
    ate = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))
    stage_ms = {k: [st.get(k, 0.0) * 1e3 for st in stages] for k in fe.stage_seconds}
    ing = {k: [f[k] * 1e3 for f in ingest] for k in ingest[0]}
    out = {
        "config": {"sweeps": LIVO_SWEEPS, "width": LIVO_W, "height": LIVO_H,
                   "points_per_sweep": LIVO_POINTS, "imu_hz": 200, "grid": MAP_GRID,
                   "bootstrap_points": MAP_BOOTSTRAP, "iters_per_frame": LIVO_ITERS},
        "native_voxel_map": native.available(),
        "vmap": type(fe.odometry.vmap).__name__,
        "frames_emitted": n_frames, "frames_per_sweep": per_sweep,
        "color_map_points": len(fe.color_map),
        "tracks": len(fe.tracker.track_idx), "vio_time_td": fe.vio_state.time_td,
        "frontend_ms_per_sweep_median": float(np.median([sum(st.values()) for st in stages]) * 1e3),
        "frontend_ms_per_sweep_max": float(np.max([sum(st.values()) for st in stages]) * 1e3),
        "frontend_stage_ms_median": {k: float(np.median(v)) for k, v in stage_ms.items()},
        "frontend_stage_ms_max": {k: float(np.max(v)) for k, v in stage_ms.items()},
        "ate_m": ate, "ate_max_m": LIVO_ATE_MAX, "final_position": est[-1].tolist(),
        "final_gt_position": gt[-1].tolist(),
        "gaussians": int(mapper.params.n_active), "keyframes": len(mapper.cameras),
        "registry_voxels": len(mapper.registry), "last_stats": stats,
        "capacity_history": capacity, "growths": growths,
        "budget_refits": mapper.budget_refits, "escalations": mapper.overflow_escalations,
        "settings": {"max_instances": mapper.settings.max_instances,
                     "max_chunks_per_tile": mapper.settings.max_chunks_per_tile},
        "ingest_ms_median": {k: float(np.median(v)) for k, v in ing.items()},
        "ingest_ms_max": {k: float(np.max(v)) for k, v in ing.items()},
        "train_iterations": len(iter_ms),
        "train_iter_ms_median": float(np.median(iter_ms)),
        "train_iter_ms_p90": float(np.percentile(iter_ms, 90)),
        "profiled_iteration": {k: v for k, v in prof.items() if k != "top"},
        "profiled_top": prof["top"][:6],
        "launches": launches,
        "loss_first_last": [float(all_losses[0]), float(all_losses[-1])],
        "psnr_staged": staged[:, 0].tolist(), "psnr_final": final[:, 0].tolist(),
        "kf0_psnr_staged_final": [float(staged[0, 0]), float(final[0, 0])],
        "mean_psnr_staged_final": [float(staged[:, 0].mean()), float(final[:, 0].mean())],
        "mean_ssim_staged_final": [float(staged[:, 1].mean()), float(final[:, 1].mean())],
        "memory_at_start_gb": mem0 / 1e9, "peak_memory_gb": peak_gb,
        "pipeline": pipeline_fields("serial", len(stream.sweeps), mapper.iter, wall,
                                    t_frontend, t_mapper),
        "kernel_parity": kernel_parity,
    }
    assert n_frames >= len(stream.sweeps) - 5, out
    assert ate < LIVO_ATE_MAX, out["ate_m"]
    assert final[0, 0] >= staged[0, 0] + 3.0, out["kf0_psnr_staged_final"]
    assert final[:, 0].mean() >= staged[:, 0].mean(), out["mean_psnr_staged_final"]
    assert all(v > 0 for v in launches.values()), launches
    return out, launches, mapper, est


def livo_overlap(stream, cfg, dev):
    """The same path with the mapper in ConcurrentMapper's worker (as
    run_synthetic's --overlap): the front end takes the next sweep while the
    card trains. Returns (fields, the front end's positions)."""
    import torch

    from gslivm_tpu_torch import pipeline

    fe = livo_frontend(stream, cfg, dev)
    cm = pipeline.ConcurrentMapper(
        pipeline.IncrementalMapper(cfg, bootstrap_points=MAP_BOOTSTRAP, device=dev),
        iters_per_frame=LIVO_ITERS)
    est, t_frontend = [], 0.0
    t_loop = time.perf_counter()
    for sweep in stream.sweeps:
        t0 = time.perf_counter()
        frames = push_sweep(fe, sweep)
        t_frontend += time.perf_counter() - t0
        est.append(fe.pose[1])
        for fr in frames:
            cm.submit_frame(fr)
    mapper = cm.finish()
    wall = time.perf_counter() - t_loop
    ev = mapper.evaluate()
    out = {"pipeline": pipeline_fields("overlap", len(stream.sweeps), cm.trained, wall,
                                       t_frontend, cm.busy_s),
           "frames_mapped": cm.frames_mapped, "keyframes": len(mapper.cameras),
           "gaussians": int(mapper.params.n_active), "evaluate": ev,
           "last_loss": float(cm.last_metrics.loss)}
    assert np.isfinite(out["last_loss"]) and cm.trained > 0, out
    del cm, mapper
    torch.cuda.empty_cache()
    return out, np.asarray(est)


def checkpoint_check(mapper, cfg, dev):
    """Save the LIVO mapper; load it into a fresh card mapper (parameters,
    Adam moments and steps bit-equal; registry, colour pool, GP cells and
    cameras equal; evaluate() equal), train it LIVO_CHECKPOINT_ITERS more
    iterations (finite), and load the same files into a CPU mapper
    (parameters equal)."""
    import torch

    from gslivm_tpu_torch import pipeline
    from gslivm_tpu_torch.utils import checkpoint

    def adam(m):
        return {g["name"]: m.optimizer.state.get(g["params"][0], {})
                for g in m.optimizer.param_groups}

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        checkpoint.save_mapper(mapper, tmp)
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t0
        sizes = {n: os.path.getsize(os.path.join(tmp, n)) for n in sorted(os.listdir(tmp))}
        t0 = time.perf_counter()
        card = checkpoint.load_mapper(
            pipeline.IncrementalMapper(cfg, bootstrap_points=MAP_BOOTSTRAP, device=dev), tmp)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cpu = checkpoint.load_mapper(
            pipeline.IncrementalMapper(cfg, bootstrap_points=MAP_BOOTSTRAP, device="cpu"), tmp)
    params_equal = all(torch.equal(a, b) for a, b in zip(
        mapper.params.state_dict().values(), card.params.state_dict().values()))
    adam_equal = all(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
                     for a, b in zip(adam(mapper).values(), adam(card).values()))
    same_parameters = all(g["params"][0] is getattr(card.params, g["name"])
                          for g in card.optimizer.param_groups)
    pool_equal = (mapper._pending_color.keys() == card._pending_color.keys() and all(
        all(np.array_equal(x, y) for x, y in zip(mapper._pending_color[h], card._pending_color[h]))
        for h in mapper._pending_color))
    cells_equal = (mapper.gpmap.cells.keys() == card.gpmap.cells.keys() and all(
        np.array_equal(a.ijk, b.ijk) and np.array_equal(a.points, b.points)
        and np.array_equal(a.variance, b.variance) and a.converged == b.converged
        for a, b in ((mapper.gpmap.cells[h], card.gpmap.cells[h]) for h in mapper.gpmap.cells)))
    cameras_equal = len(mapper.cameras) == len(card.cameras) and all(
        torch.equal(getattr(a, f), getattr(b, f)) and (a.width, a.height) == (b.width, b.height)
        for a, b in zip(mapper.cameras, card.cameras) for f in checkpoint._TENSOR_FIELDS)
    ev, ev_card = mapper.evaluate(), card.evaluate()
    more = torch.stack([card.train_iteration().loss
                        for _ in range(LIVO_CHECKPOINT_ITERS)]).cpu().numpy()
    cpu_equal = all(torch.equal(a, b.cpu()) for a, b in zip(
        cpu.params.state_dict().values(), mapper.params.state_dict().values()))
    out = {"bytes": sizes, "save_s": save_s, "load_s": load_s,
           "capacity": card.params.capacity, "gaussians": int(card.params.n_active),
           "params_bit_equal": params_equal, "adam_bit_equal": adam_equal,
           "adam_keyed_to_own_parameters": same_parameters,
           "registry_equal": card.registry._ranges == mapper.registry._ranges,
           "loss_anchor_keys_equal": list(card.loss_anchors) == list(mapper.loss_anchors),
           "pending_color_equal": pool_equal, "gp_cells_equal": cells_equal,
           "cameras_equal": cameras_equal, "evaluate": ev, "evaluate_restored": ev_card,
           "losses_after_resume": more.tolist(), "cpu_params_equal": cpu_equal}
    assert params_equal and adam_equal and same_parameters and cpu_equal, out
    assert out["registry_equal"] and out["loss_anchor_keys_equal"], out
    assert pool_equal and cells_equal and cameras_equal, out
    assert ev == ev_card, out
    assert np.isfinite(more).all(), out
    return out


def run_synthetic_check(dev):
    """The port's example at its defaults on the card, as a user runs it:
    exit 0 and every artifact written."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "gslivm_tpu_torch.examples.run_synthetic",
               "--out", tmp, "--device", str(dev)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        listing = sorted(os.listdir(tmp))
        pngs = sorted(os.listdir(os.path.join(tmp, "training"))) \
            if os.path.isdir(os.path.join(tmp, "training")) else []
    out = {"command": " ".join(["python", *cmd[1:4], "<tmp>", *cmd[5:]]),
           "returncode": proc.returncode, "seconds": seconds, "artifacts": listing,
           "training_pngs": len(pngs),
           "pipeline": next((ln for ln in lines if ln.startswith("pipeline:")), None),
           "eval": next((ln for ln in lines if ln.startswith("eval:")), None),
           "offline_eval": next((ln for ln in lines if ln.startswith("offline eval")), None),
           "stderr_tail": proc.stderr[-2000:] if proc.returncode else ""}
    assert proc.returncode == 0, out
    assert {"map.ply", "rgb_map.pcd", "pose.txt", "cfg_args", "log_time.txt",
            "training"} <= set(listing) and pngs, out
    return out


def collective_bytes(g: int, n: int, renderer: str, n_gauss: int, cams, block) -> dict:
    """Bytes one rank of a (g, n) mesh sends and receives by each collective
    of one sharded_train_step (computed from shapes, not timed): all_gather
    receives the (size-1) other blocks; all_reduce is counted as a ring,
    2 (size-1)/size of the tensor each way; the exchange's all_to_all moves
    the (g-1) boxes of budget rows out and in, and back in backward."""
    from gslivm_tpu_torch.ops.rasterize_reference import tile_grid
    from gslivm_tpu_torch.parallel import primitive, sharding

    def ring(size, nbytes):
        return 2 * (size - 1) / size * nbytes

    shard = n_gauss // g
    out = {"param_grad_all_reduce_pixel": ring(n, shard * SHARD_FLOATS * 4)}
    for cam in cams:
        br = sharding.band_rows_for(cam, n, block)
        band_px = br * 16 * block[1] * tile_grid(cam.width, cam.height)[0] * 16
        rows = 5 if renderer == "tiles" else 6
        add = {"image_all_gather_pixel": (n - 1) * rows * band_px * 4,
               "image_cotangent_all_reduce_pixel": ring(n, n * rows * band_px * 4)}
        if renderer == "tiles":
            add["param_all_gather_gauss"] = (g - 1) * shard * SHARD_FLOATS * 4 / len(cams)
            add["param_cotangent_all_reduce_gauss"] = ring(
                g, n_gauss * SHARD_FLOATS * 4) / len(cams)
        else:
            box = primitive.default_budget(shard, g, SHARD_SLACK)
            add["depth_key_all_gather_gauss"] = (g - 1) * shard * 4
            add["exchange_all_to_all_gauss"] = 2 * 2 * (g - 1) * box * EXCHANGE_ROWS * 4
            add["partial_all_gather_gauss"] = (g - 1) * 6 * band_px * 4
            add["partial_cotangent_all_reduce_gauss"] = ring(g, g * 6 * band_px * 4)
        for k, v in add.items():
            out[k] = out.get(k, 0.0) + v
    out = {k: v for k, v in out.items() if v}
    out["total"] = sum(out.values())
    return out


def band_loss_parity(view, gt, cams, renders):
    """The pixel ranks' loss bands on the card at full width, as the
    sharded loss calls them: for every band p of every N in SHARD_PIXEL_N
    (ceil(H/N) rows from p*ceil(H/N)), ssim_band_sum of the view [3, H, W]
    against gt[0] (its five blurs one K3 launch of [15, rows + 10, W], and
    one more in its VJP), l1_band_sum, and delta_depth_band_sum of views 1
    and 2 (rows D and A of `renders`). Every K3 call is held against
    blur_plain on the same input (max abs over max(|plain|, 1) <= 1e-5:
    k3_parity's gate, scaled because the VJP blurs cotangents far above
    1), and ssim_band_sum's value and VJP against the same call with the
    plain blur (the value within 1e-5 of max(|sum|, its element count),
    SSIM lying in [-1, 1]); the VJP, whose f32 rounding alone reaches
    ~1e-4 of scale, no further from the float64 VJP (plain blur) than
    twice the plain f32 path's distance, or 1e-5 of scale; each loss's
    band sums add up to its full-frame sum (1e-5 relative)."""
    import torch

    from gslivm_tpu_torch.models import training
    from gslivm_tpu_torch.ops import blur, losses

    H, W = view.shape[1:]
    target = gt[0]
    impl = blur._blur_impl
    calls = []

    def checked(x, taps):  # K3, and its plain version on the same input
        out = impl(x, taps)
        plain = blur.blur_plain(x, taps)
        calls.append((tuple(x.shape), float((out - plain).abs().max())
                      / max(float(plain.abs().max()), 1.0)))
        return out

    def plain_many(x, taps):
        return blur.blur_plain(x, tuple(float(t) for t in taps))

    def ssim_and_vjp(lo, n, dtype=torch.float32):
        x = view.to(dtype).requires_grad_(True)
        v = losses.ssim_band_sum(x, target.to(dtype), lo, n)
        return float(v.detach()), torch.autograd.grad(v, x)[0]

    depth = [r[3, :H, :W] for r in renders[1:3]]
    acc = [r[4, :H, :W] for r in renders[1:3]]
    with torch.no_grad():
        full = {"ssim": float(losses.ssim(view, target)) * view.numel(),
                "l1": float(losses.l1_loss(view, target)) * view.numel(),
                "delta": float(training.delta_depth_loss(
                    depth[0], acc[0], cams[1], depth[1], acc[1], cams[2])) * H * W}
    out = {"per_n": {}, "value_rel_err": 0.0, "vjp_scaled_err": 0.0, "vjp_f64_err": 0.0,
           "vjp_plain_f64_err": 0.0}
    for n_pixel in SHARD_PIXEL_N:
        rows = -(-H // n_pixel)
        sums = {"ssim": 0.0, "l1": 0.0, "delta": 0.0}
        for p in range(n_pixel):
            blur._blur_impl = checked
            try:
                v, g = ssim_and_vjp(p * rows, rows)
            finally:
                blur._blur_impl = impl
            losses.blur_many = plain_many
            try:
                v_plain, g_plain = ssim_and_vjp(p * rows, rows)
                _, g64 = ssim_and_vjp(p * rows, rows, torch.float64)
            finally:
                losses.blur_many = blur.blur_many
            # SSIM lies in [-1, 1]: the sum's scale is at least its element count
            n_el = view.shape[0] * min(rows, H - p * rows) * W
            out["value_rel_err"] = max(out["value_rel_err"],
                                       abs(v - v_plain) / max(abs(v_plain), n_el))
            out["vjp_scaled_err"] = max(out["vjp_scaled_err"], scaled_err(g, g_plain))
            out["vjp_f64_err"] = max(out["vjp_f64_err"], scaled_err(g.double(), g64))
            out["vjp_plain_f64_err"] = max(out["vjp_plain_f64_err"],
                                           scaled_err(g_plain.double(), g64))
            with torch.no_grad():
                sums["ssim"] += v
                sums["l1"] += float(losses.l1_band_sum(view, target, p * rows, rows))
                sums["delta"] += float(training.delta_depth_band_sum(
                    depth[0], acc[0], cams[1], depth[1], acc[1], cams[2], p * rows, rows))
        out["per_n"][n_pixel] = {
            "band_rows": rows, "k3_shape": [15, rows + 10, W],
            "partition_rel_err": {k: abs(sums[k] - full[k]) / abs(full[k]) for k in sums}}
    out["k3_calls"] = len(calls)
    out["k3_max_scaled_err"] = max(e for _, e in calls)
    out["k3_shapes"] = sorted({shape for shape, _ in calls}, reverse=True)
    out["tol"] = 1e-5
    assert out["k3_calls"] == 2 * sum(SHARD_PIXEL_N), out  # a forward and a VJP a band
    assert out["k3_max_scaled_err"] <= 1e-5, out
    assert out["value_rel_err"] <= 1e-5, out
    # the VJP sums blurred cotangents near 1/C2 that cancel where the image
    # is flat, so f32 rounding alone moves it by ~1e-4 of scale: K3's path
    # is held to the plain f32 path's own distance from float64
    assert out["vjp_f64_err"] <= max(2.0 * out["vjp_plain_f64_err"], 1e-5), out
    assert all(e <= 1e-5 for r in out["per_n"].values()
               for e in r["partition_rel_err"].values()), out
    return out


def shard_ranks(params, cams, gt, dev, profiled, counters):
    """The per-rank work of the SHARD_MESHES, one rank after another on one
    card (no collective runs): each pixel rank's band of each view (tiles:
    the whole map; primitive: each depth slab's band, the slabs cut by
    split_depth_slabs and folded in depth order by fold_partials),
    stitched, against the single-device render (rows C, D, A, T: K1's gate
    plus, for the slabs, the stop bound) and the per-gaussian gradients of
    a fixed loss (random weights on C, A and T) against the single-device
    ones (tiles 1e-3 of scale, primitive GRAD_FOLD_TOL, with the no-T
    control above it); then band_loss_parity on the stitched view 0. Then
    fwd+bwd times of one rank (a band of each SHARD_PIXEL_N, a slab of each
    SHARD_GAUSS_G) by CUDA events with the profiler's device busy time,
    each virtual rank's peak memory, and the
    collective bytes. `counters` count every launch here."""
    import torch

    from gslivm_tpu_torch.ops import rasterize_reference, rasterize_tiles
    from gslivm_tpu_torch.ops.rasterize_reference import tile_grid
    from gslivm_tpu_torch.parallel import primitive, sharding

    for c in counters.values():
        c.launches = 0
    W, H = cams[0].width, cams[0].height
    block = SHARD_BLOCK
    gx, gy = tile_grid(W, H)
    sgrid_y = -(-gy // block[1])
    Hp, Wp = sgrid_y * 16 * block[1], -(-gx // block[0]) * 16 * block[0]
    n_gauss = params.capacity
    with torch.no_grad():
        base = [params.xyz, params.get_scaling(), params.get_rotation(),
                params.get_opacity()[:, 0], params.get_features()]
    mask = params.active_mask()
    rng = np.random.default_rng(5)
    weights = [torch.as_tensor(rng.uniform(0.5, 1.5, (6, Hp, Wp)), dtype=torch.float32,
                               device=dev) for _ in cams]
    for w in weights:
        w[3] = 0.0  # the sharded loss stops the depth gradient

    def leaves(rows=slice(None)):
        return [t[rows].detach().clone().requires_grad_(True) for t in base]

    def pre_of(args, cam, rows=slice(None)):
        return rasterize_reference.preprocess(*args, cam, active_mask=mask[rows])

    def band(pre, n, p):
        br = sharding.band_rows_for(cams[0], n, block)
        img, binned, _ = rasterize_tiles.render_tiles_raw(
            pre, W, H, depth_grad=False, max_instances=SHARD_MAX_INSTANCES,
            block_x=block[0], block_y=block[1], contrib_stats=False, band_rows=br,
            band_start=p * br)
        assert int(binned.overflow) == 0
        return img[:6]

    def slab_band(slab, n, p):
        br = sharding.band_rows_for(cams[0], n, block)
        part, binned = primitive.render_slab_band(
            slab, W, H, br, p * br, max_instances=SHARD_MAX_INSTANCES, block=block)
        assert int(binned.overflow) == 0
        return part

    def render(renderer, g, n, args, cam, t_one=None, fold=primitive.fold_partials):
        """The stitched [6, Hp, Wp] rows of one view, and for "primitive" the
        deviation each row may take from the one-pass render whose T row is
        t_one: fold_stop_bound times the largest splat colour, depth, or 1."""
        pre = pre_of(args, cam)
        if renderer == "tiles":  # every gauss row renders the same bands
            return torch.cat([band(pre, n, p) for p in range(n)], dim=1)[:, :Hp], None
        slabs, overflow = primitive.split_depth_slabs(
            pre, g, primitive.default_budget(n_gauss // g, g, SHARD_SLACK))
        assert int(overflow) == 0
        bands, bounds = [], []
        for p in range(n):
            parts = torch.stack([slab_band(s, n, p) for s in slabs])
            bands.append(fold(parts))
            if t_one is not None:
                t = torch.ones_like(parts[0, 5])
                rows = t_one[p * t.shape[0]:(p + 1) * t.shape[0]]
                t[:rows.shape[0]] = rows
                bounds.append(primitive.fold_stop_bound(parts, t))
        if t_one is None:
            return torch.cat(bands, dim=1)[:, :Hp], None
        with torch.no_grad():
            valid = pre.valid
            c, d = float(pre.color[valid].max()), float(pre.depth[valid].max())
        bound = torch.cat(bounds, dim=0)[:Hp]
        allow = torch.stack([bound * peak for peak in (c, c, c, d, 1.0, 1.0)])
        return torch.cat(bands, dim=1)[:, :Hp], allow

    def fold_without_t(parts):
        """The control: slabs summed with no transmittance between them."""
        return torch.cat([parts[:, :5].sum(dim=0), parts[:, 5].prod(dim=0)[None]], dim=0)

    @contextlib.contextmanager
    def plain_kernels():
        """K1 and K2 replaced by their plain versions (the same per-slab
        semantics), for the reference of the kernels' slab path."""
        k1, k2 = rasterize_tiles.composite_tiles, rasterize_tiles.composite_tiles_bwd

        def bwd(inst, start, cnt, g_tiles, fwd, ckpt, cfg, n, depth_grad=True):
            return rasterize_tiles.scatter_instance_grads(
                rasterize_tiles.composite_tiles_bwd_plain(inst, start, cnt, g_tiles, fwd, ckpt,
                                                          cfg, depth_grad), n, depth_grad)
        rasterize_tiles.composite_tiles = rasterize_tiles.composite_tiles_plain
        rasterize_tiles.composite_tiles_bwd = bwd
        try:
            yield
        finally:
            rasterize_tiles.composite_tiles, rasterize_tiles.composite_tiles_bwd = k1, k2

    def row_errs(imgs, refs, allows=None):
        """Per row group, max |a - b| over max(|b|, 1); with allows, the
        largest ratio of |a - b| to the pixel's allowed deviation plus
        1e-3 of that scale (<= 1 passes)."""
        out = {}
        for name, r in (("C", slice(0, 3)), ("D", 3), ("A", 4), ("T", 5)):
            worst = 0.0
            for i, (a, b) in enumerate(zip(imgs, refs)):
                scale = max(float(b[r].abs().max()), 1.0)
                d = (a[r].detach() - b[r]).abs()
                if allows is None:
                    worst = max(worst, float(d.max()) / scale)
                else:
                    worst = max(worst, float((d / (allows[i][r] + 1e-3 * scale)).max()))
            out[name] = worst
        return out

    def loss_of(imgs):
        return sum((img * w).sum() for img, w in zip(imgs, weights))

    # the single-device render and gradients
    args = leaves()
    single = [band(pre_of(args, cam), 1, 0) for cam in cams]
    g_single = torch.autograd.grad(loss_of(single), args)
    single = [s.detach() for s in single]
    del args

    names = ("means", "scales", "quats", "opacities", "shs")
    parity = {}
    for g, n in SHARD_MESHES:
        for renderer in ("tiles", "primitive"):
            args = leaves()
            out = [render(renderer, g, n, args, cam, ref[5]) for cam, ref in zip(cams, single)]
            imgs = [o[0] for o in out]
            grads = torch.autograd.grad(loss_of(imgs), args)
            r = {"grad_scaled_err": {k: scaled_err(a, b)
                                     for k, a, b in zip(names, grads, g_single)},
                 "rows_scaled_err": row_errs(imgs, single)}
            if renderer == "tiles":
                if (g, n) == SHARD_MESHES[0]:
                    stitched_view = imgs[0][:3, :H, :W].detach()
            else:
                allows = [o[1] for o in out]
                r["rows_bound_ratio"] = row_errs(imgs, single, allows)
                r["stopped_pixel_share"] = float(sum(
                    (a[4] > 0).float().mean() for a in allows)) / len(cams)
                del allows
                ctl_args = leaves()
                ctl = [render(renderer, g, n, ctl_args, cam, fold=fold_without_t)[0]
                       for cam in cams]
                r["grad_scaled_err_control_no_t"] = {
                    k: scaled_err(a, b) for k, a, b in zip(
                        names, torch.autograd.grad(loss_of(ctl), ctl_args), g_single)}
                del ctl, ctl_args
                with plain_kernels():
                    plain_args = leaves()
                    plain = [render(renderer, g, n, plain_args, cam)[0] for cam in cams]
                    g_plain = torch.autograd.grad(loss_of(plain), plain_args)
                plain = [x.detach() for x in plain]
                r["rows_scaled_err_plain"] = row_errs(imgs, plain)
                r["grad_scaled_err_plain"] = {k: scaled_err(a, b)
                                              for k, a, b in zip(names, grads, g_plain)}
                del plain, g_plain, plain_args
            parity[f"{renderer} {g}x{n}"] = r
            del args, out, imgs, grads
    torch.cuda.empty_cache()

    def timed(fn):
        """fwd+bwd ms by CUDA events (median of 3 after a warm-up), and the
        profiler's device busy time of one more call."""
        fn()
        ms = []
        for _ in range(3):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        prof = profiled(fn)
        return {"ms": float(np.median(ms)), "device_busy_ms": prof["device_busy_ms"],
                "launches": prof["launches"]}

    cam = cams[0]
    args = leaves()

    def band_work(n, p):
        """A tiles rank's work on view 0: preprocess the whole map, render
        band p of n, backward a fixed loss of the band to the map."""
        rows = sharding.band_rows_for(cam, n, block) * 16 * block[1]
        w = torch.zeros((6, rows, Wp), device=dev)
        piece = weights[0][:, p * rows:(p + 1) * rows]
        w[:, :piece.shape[1]] = piece

        def fn():
            img = band(pre_of(args, cam), n, p)
            torch.autograd.grad((img * w).sum(), args)
        return fn

    bands_ms = {}
    for n in SHARD_PIXEL_N:
        per = [timed(band_work(n, p)) for p in range(n)]
        bands_ms[n] = {"band_ms": [r["ms"] for r in per],
                       "busy_ms": [r["device_busy_ms"] for r in per],
                       "max_band_ms": max(r["ms"] for r in per)}
    slabs_ms = {}
    for g in SHARD_GAUSS_G:
        with torch.no_grad():
            slab_rows = [primitive._pre_to_rows(s) for s in
                         primitive.split_depth_slabs(pre_of(args, cam), g)[0]]
        per = []
        for k, rows in enumerate(slab_rows):
            shard_args = leaves(slice(k * n_gauss // g, (k + 1) * n_gauss // g))
            leaf = rows.detach().clone().requires_grad_(True)

            def fn(shard_args=shard_args, leaf=leaf, k=k):
                # the rank's preprocess of its shard, and its slab over the image
                pre = pre_of(shard_args, cam, slice(k * n_gauss // g, (k + 1) * n_gauss // g))
                part = slab_band(primitive._rows_to_pre(leaf), 1, 0)
                loss = (part * weights[0]).sum() + primitive._pre_to_rows(pre)[:10].sum()
                torch.autograd.grad(loss, [leaf, *shard_args])
            per.append(timed(fn))
        slabs_ms[g] = {"slab_ms": [r["ms"] for r in per],
                       "busy_ms": [r["device_busy_ms"] for r in per],
                       "max_slab_ms": max(r["ms"] for r in per)}
        del slab_rows
    del args
    torch.cuda.empty_cache()

    # each virtual rank's peak memory, three views fwd+bwd, above its inputs
    memory = {}
    for g, n in SHARD_MESHES:
        for renderer in ("tiles", "primitive"):
            peaks = []
            for k in range(g):
                for p in range(n):
                    rows = slice(k * n_gauss // g, (k + 1) * n_gauss // g)
                    if renderer == "tiles":
                        inputs = leaves()
                    else:
                        inputs = leaves(rows)
                        with torch.no_grad():
                            full = leaves()
                            slab_in = [primitive._pre_to_rows(primitive.split_depth_slabs(
                                pre_of(full, c), g)[0][k]).detach().requires_grad_(True)
                                for c in cams]
                            del full
                    torch.cuda.synchronize()
                    before = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    if renderer == "tiles":
                        imgs = [band(pre_of(inputs, c), n, p) for c in cams]
                        loss = sum(i.sum() for i in imgs)
                        torch.autograd.grad(loss, inputs)
                    else:
                        pres = [pre_of(inputs, c, rows) for c in cams]
                        parts = [slab_band(primitive._rows_to_pre(s), n, p) for s in slab_in]
                        gathered = [torch.empty((g,) + tuple(pt.shape), device=dev)
                                    for pt in parts]  # the partials' all_gather
                        loss = (sum(pt.sum() for pt in parts)
                                + sum(primitive._pre_to_rows(q)[:10].sum() for q in pres))
                        torch.autograd.grad(loss, [*inputs, *slab_in])
                        del pres, parts, gathered
                        del slab_in
                    torch.cuda.synchronize()
                    peaks.append((torch.cuda.max_memory_allocated() - before) / 1e9)
                    del inputs
            memory[f"{renderer} {g}x{n}"] = {"rank_peak_gb": peaks, "max_gb": max(peaks)}
    torch.cuda.empty_cache()

    bytes_ = {f"{r} {g}x{n}": collective_bytes(g, n, r, n_gauss, cams, block)
              for g, n in SHARD_MESHES for r in ("tiles", "primitive")}
    for name, r in parity.items():
        # K1/K2's gates against the single render and, for the slabs, against
        # the plain versions of the same per-slab semantics; the slabs'
        # rows against the single render within the stop bound as well
        if name.startswith("tiles"):
            assert max(r["rows_scaled_err"].values()) <= 1e-3, (name, r)
            assert max(r["grad_scaled_err"].values()) <= 1e-3, (name, r)
            continue
        assert max(r["rows_bound_ratio"].values()) <= 1.0, (name, r)
        assert max(r["rows_scaled_err_plain"].values()) <= 1e-3, (name, r)
        assert max(r["grad_scaled_err_plain"].values()) <= 1e-3, (name, r)
        assert max(r["grad_scaled_err"].values()) <= GRAD_FOLD_TOL, (name, r)
        assert max(r["grad_scaled_err_control_no_t"].values()) > GRAD_FOLD_TOL, (name, r)
    band_losses = band_loss_parity(stitched_view, gt, cams, single)
    return {"parity": parity, "tol": 1e-3, "grad_fold_tol": GRAD_FOLD_TOL,
            "band_losses": band_losses, "band_fwd_bwd": bands_ms,
            "slab_fwd_bwd": slabs_ms, "rank_peak_memory": memory,
            "collective_bytes_per_step": bytes_,
            "launches_ranks": {k: c.launches for k, c in counters.items()}}



def shard_step_check(params, cams, gt, simi, dev):
    """sharded_train_step in a world of one NCCL rank, run by multihost_demo
    in a subprocess as a user runs it, for "tiles" and "primitive" from the
    train phase's state, against train_step from the same state: loss within
    1e-5 relative, each parameter's .grad within 1e-3 of its scale (K2's
    atomics vary from run to run), overflow 0; the rank counts its K1/K2/K3
    launches around each step. With two or more cards, a real NCCL world of
    them takes the same steps against the same gates."""
    import torch

    from gslivm_tpu_torch.models import training
    from gslivm_tpu_torch.models.gaussian_model import GaussianParams
    from gslivm_tpu_torch.ops.rasterize import RasterizeSettings
    from gslivm_tpu_torch.parallel import sharding
    from gslivm_tpu_torch.tools import multihost_demo

    ref = GaussianParams(*[getattr(params, f).detach().clone() for f in sharding.FIELDS],
                         n_active=int(params.n_active))
    m = training.train_step(ref, training.make_optimizer(ref), cams, gt, simi,
                            settings=RasterizeSettings(
                                max_instances=SHARD_MAX_INSTANCES, block_x=SHARD_BLOCK[0],
                                block_y=SHARD_BLOCK[1]), n_history_pairs=1)
    want_loss = float(m.loss)
    want = {f: getattr(ref, f).grad for f in sharding.FIELDS if getattr(ref, f).numel()}

    def world(nproc, axes, tmp):
        state, out = os.path.join(tmp, "state.pt"), os.path.join(tmp, f"out{nproc}.pt")
        if not os.path.exists(state):
            multihost_demo.save_state(state, params, cams, gt, simi)
        cmd = [sys.executable, "-m", "gslivm_tpu_torch.tools.multihost_demo",
               "--nproc", str(nproc), "--gauss-axis", axes,
               "--renderer", f"tiles,primitive:{SHARD_SLACK}",
               "--state", state, "--out", out, "--history-pairs", "1",
               "--block", ",".join(map(str, SHARD_BLOCK)),
               "--max-instances", str(SHARD_MAX_INSTANCES),
               "--timeout", "300", "--device", str(dev)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stderr[-4000:]
        steps = {}
        for key, r in torch.load(out, weights_only=True).items():
            steps[f"{key[1].partition(':')[0]} {key[0]}x{nproc // key[0]}"] = {
                "loss": r["metrics"]["loss"], "overflow": r["metrics"]["overflow"],
                "num_instances": r["metrics"]["num_instances"], "step_s": r["seconds"],
                "launches": r["launches"],
                "loss_rel_err": abs(r["metrics"]["loss"] - want_loss) / abs(want_loss),
                "grad_scaled_err": {f: scaled_err(r["grads"][f].to(dev), w)
                                    for f, w in want.items()}}
        return {"seconds": seconds, "steps": steps}

    with tempfile.TemporaryDirectory() as tmp:
        one = world(1, "1", tmp)
        count = torch.cuda.device_count()
        multi = (world(min(count, 4), f"1,{min(count, 4)}", tmp) if count >= 2
                 else "1 card")
    out = {"want_loss": want_loss, "one_rank_nccl": one, "multi_rank": multi,
           "loss_rtol": 1e-5, "grad_tol": 1e-3}
    for res in [one] + ([multi] if isinstance(multi, dict) else []):
        for name, r in res["steps"].items():
            assert r["overflow"] == 0 and r["loss_rel_err"] <= 1e-5, (name, r)
            assert max(r["grad_scaled_err"].values()) <= 1e-3, (name, r)
    launches = {k: sum(r["launches"][k] for r in one["steps"].values())
                for k in ("K1", "K2", "K3")}
    # a step: a K1 and a K2 per view, a forward and a backward K3 per view
    assert all(r["launches"] == {"K1": 3, "K2": 3, "K3": 6} for r in one["steps"].values()), one
    return out, launches


def write_dolly_bag(stream, path: str) -> dict:
    """The livo phase's streams as a ROS1 bag, in the order the livo phase
    pushes them: the static IMU, then per sweep its Livox CustomMsg (float32
    points, offsets in integer ns, every tag a first return), its IMU
    samples and its rgb8 Image."""
    from gslivm_tpu_torch.frontend import rosbag

    def messages():
        for t, gyr, acc in stream.init_imu:
            yield (BAG_TOPICS["imu"], "sensor_msgs/Imu", t, rosbag.encode_imu(t, gyr, acc))
        for sw in stream.sweeps:
            li = sw.lidar
            yield (BAG_TOPICS["lidar"], "livox_ros_driver/CustomMsg", li.t_begin,
                   rosbag.encode_livox_custom(li.t_begin, li.xyz, li.rel_time))
            for t, gyr, acc in sw.imu:
                yield (BAG_TOPICS["imu"], "sensor_msgs/Imu", t, rosbag.encode_imu(t, gyr, acc))
            yield (BAG_TOPICS["image"], "sensor_msgs/Image", sw.image_time,
                   rosbag.encode_image(sw.image_time, sw.image))

    t0 = time.perf_counter()
    n = rosbag.write_bag(path, messages())
    return {"messages": n, "bytes": os.path.getsize(path),
            "write_seconds": time.perf_counter() - t0}


def r3live_camera() -> dict:
    """configs/datasets/r3live.yaml's image topics, size, ratio and
    distortion."""
    from gslivm_tpu_torch.config import load_yaml

    ds = load_yaml(R3LIVE_YAML)["dataset"]
    return {"topics": {"imu": ds["imu_topic"], "lidar": ds["lidar_topic"],
                       "image": ds["image_topic"]},
            "size": (ds["image_width"], ds["image_height"]),
            "ratio": float(ds["image_resize_ratio"]),
            "K": np.array([[ds["fx"], 0, ds["cx"]], [0, ds["fy"], ds["cy"]], [0, 0, 1.0]]),
            "dist": [ds[k] for k in ("dist_k1", "dist_k2", "dist_p1", "dist_p2", "dist_k3")]}


def render_jpeg_message(job) -> bytes:
    """One bag_compressed image (run in a pool worker): the dolly camera at
    `center` with r3live's size and distortion, ray-cast and encoded as a
    JPEG sensor_msgs/CompressedImage."""
    import torch

    from gslivm_tpu_torch.frontend import rosbag, synthetic
    from gslivm_tpu_torch.models.cameras import make_camera

    torch.set_num_threads(1)
    t, center, (w, h), dist = job
    cam = make_camera(np.eye(3), center, w, h, fovx=synthetic.LIDAR_FOVX,
                      fovy=synthetic.LIDAR_FOVX * h / w, device="cpu")
    img = synthetic.render_image(cam, synthetic.default_scene(), distortion=dist)
    return rosbag.encode_compressed_image(t, img, JPEG_QUALITY)


def write_compressed_bag(stream, path: str, cam: dict):
    """The livo phase's LiDAR and IMU streams unchanged, each sweep's image
    at the same time rendered by r3live's camera and JPEG-encoded
    (render_jpeg_message, one spawned process per core), on r3live's
    topics. Returns (bag fields, the CompressedImage messages)."""
    import multiprocessing

    from gslivm_tpu_torch.frontend import rosbag, synthetic

    t0 = time.perf_counter()
    start = stream.sweeps[0].lidar.t_begin  # when the dolly's motion began
    jobs = [(sw.image_time, synthetic.dolly_position(sw.image_time - start), cam["size"],
             cam["dist"]) for sw in stream.sweeps]
    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        images = pool.map(render_jpeg_message, jobs)
    render_s = time.perf_counter() - t0
    topics = cam["topics"]

    def messages():
        for t, gyr, acc in stream.init_imu:
            yield (topics["imu"], "sensor_msgs/Imu", t, rosbag.encode_imu(t, gyr, acc))
        for sw, msg in zip(stream.sweeps, images):
            li = sw.lidar
            yield (topics["lidar"], "livox_ros_driver/CustomMsg", li.t_begin,
                   rosbag.encode_livox_custom(li.t_begin, li.xyz, li.rel_time))
            for t, gyr, acc in sw.imu:
                yield (topics["imu"], "sensor_msgs/Imu", t, rosbag.encode_imu(t, gyr, acc))
            yield (topics["image"], "sensor_msgs/CompressedImage", sw.image_time, msg)

    n = rosbag.write_bag(path, messages())
    sizes = [len(m) - m.index(b"\xff\xd8\xff") for m in images]
    return {"messages": n, "bytes": os.path.getsize(path), "render_encode_seconds": render_s,
            "write_seconds": time.perf_counter() - t0 - render_s, "images": len(images),
            "jpeg_bytes_mean": float(np.mean(sizes)), "jpeg_bytes_min": min(sizes),
            "jpeg_bytes_max": max(sizes)}, images


def codec_parity(messages, cam: dict, dev, profiled) -> dict:
    """The camera intake on the card against the CPU, bit for bit, on the
    bag_compressed images: each JPEG entropy-decoded once on the host (host
    ms), reconstructed on the card (CUDA-event ms) and on the CPU, resized
    to half size (OpenCV's 2x2 area path) and to ODD_RESIZE (its bilinear
    path), and the half-size image remapped through r3live's undistortion
    map (CUDA-event ms); medians over the images. Then one image's
    reconstruction, and its resize and remap, under the profiler (device
    busy time, idle share, launches)."""
    import torch

    from gslivm_tpu_torch.frontend import imgproc, jpeg

    w, h = (int(v * cam["ratio"]) for v in cam["size"])
    K = cam["K"] * np.array([[cam["ratio"]], [cam["ratio"]], [1.0]])  # as LivoFrontend scales it
    xy, fxy = imgproc.undistort_rectify_map(K, cam["dist"], (w, h))
    maps_cpu = (torch.from_numpy(xy), torch.from_numpy(fxy.astype(np.int32)))
    maps = tuple(m.to(dev) for m in maps_cpu)

    def timed(fn):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        return out, (e0, e1)

    entropy_ms, decode_ms, events = [], [], {"reconstruct": [], "resize_half": [],
                                             "resize_odd": [], "remap": []}
    mismatches = {k: 0 for k in events}
    for i, msg in enumerate(messages):
        data = msg[msg.index(b"\xff\xd8\xff"):]
        t0 = time.perf_counter()
        coefs = jpeg.entropy_decode(data)
        entropy_ms.append((time.perf_counter() - t0) * 1e3)
        card, ev = timed(lambda: jpeg.reconstruct(coefs, dev))
        events["reconstruct"].append(ev)
        half, ev = timed(lambda: imgproc.resize_linear(card, (w, h)))
        events["resize_half"].append(ev)
        odd, ev = timed(lambda: imgproc.resize_linear(card, ODD_RESIZE))
        events["resize_odd"].append(ev)
        und, ev = timed(lambda: imgproc.remap_linear(half, *maps))
        events["remap"].append(ev)
        cpu = jpeg.reconstruct(coefs, "cpu")
        cpu_half = imgproc.resize_linear(cpu, (w, h))
        for key, a, b in (("reconstruct", card, cpu), ("resize_half", half, cpu_half),
                          ("resize_odd", odd, imgproc.resize_linear(cpu, ODD_RESIZE)),
                          ("remap", und, imgproc.remap_linear(cpu_half, *maps_cpu))):
            mismatches[key] += int((a.cpu() != b).sum())
        t0 = time.perf_counter()
        jpeg.decode(data, dev)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    # the first image pays the card's first calls of each op: medians skip nothing
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in events.items()}
    prof = {"reconstruct": profiled(lambda: jpeg.reconstruct(coefs, dev)),
            "resize_remap": profiled(lambda: imgproc.remap_linear(
                imgproc.resize_linear(card, (w, h)), *maps))}
    out = {"images": len(messages), "shape": [cam["size"][1], cam["size"][0], 3],
           "half": [h, w], "odd": [ODD_RESIZE[1], ODD_RESIZE[0]],
           "mismatched_values": mismatches,
           "entropy_host_ms_median": float(np.median(entropy_ms)),
           "decode_host_ms_median": float(np.median(decode_ms)),
           **{f"{k}_ms_median": float(np.median(v)) for k, v in ms.items()},
           **{f"{k}_ms_max": float(np.max(v)) for k, v in ms.items()},
           "map_pixels_outside": int(((xy[..., 0] < 0) | (xy[..., 0] >= w)
                                      | (xy[..., 1] < 0) | (xy[..., 1] >= h)).sum()),
           **{f"profile_{k}": {f: v[f] for f in ("wall_ms", "device_busy_ms", "idle_share",
                                                  "launches")} | {"top": v["top"][:4]}
              for k, v in prof.items()}}
    assert not any(mismatches.values()), out
    return out


def gp_figure_check(dev) -> dict:
    """tools/gp_figure.compute on the card against the CPU (map_parity's GP
    gate, 1e-3 of scale), then its plot where matplotlib exists."""
    import torch

    from gslivm_tpu_torch.ops import gp3d
    from gslivm_tpu_torch.tools import gp_figure

    _, card = gp_figure.compute(seed=42, device=dev)
    _, cpu = gp_figure.compute(seed=42, device="cpu")
    errs = {}
    for f in gp3d.GpResult._fields:
        a, b = getattr(card, f).cpu(), getattr(cpu, f)
        errs[f] = float((a != b).sum()) if b.dtype == torch.bool else nan_scaled_err(a, b)
    out = {"errors": errs, "tol": 1e-3, "device": str(card.means.device),
           "test_points": list(card.test_points.shape)}
    assert card.means.device.type == "cuda" and max(errs.values()) <= 1e-3, out
    return out


def dolly_dataset_yaml(path: str, stream, topics=BAG_TOPICS, size=(LIVO_W, LIVO_H),
                       ratio: float = 1.0, dist=(0.0,) * 5):
    """A dataset yaml of the dolly's camera (its intrinsics scaled to
    `size`, a centred principal point) and `topics` (identity extrinsics),
    whose overrides are livo_config()'s."""
    w, h = size
    fx, fy = stream.fx * w / LIVO_W, stream.fy * h / LIVO_H
    with open(path, "w") as f:
        f.write(f"""dataset:
    lidar_topic: "{topics['lidar']}"
    imu_topic: "{topics['imu']}"
    image_topic: "{topics['image']}"
    lidar_type: livox
    image_width: {w}
    image_height: {h}
    image_resize_ratio: {ratio!r}
    fx: {float(fx)!r}
    fy: {float(fy)!r}
    cx: {(w - 1) / 2.0!r}
    cy: {(h - 1) / 2.0!r}
    dist_k1: {float(dist[0])!r}
    dist_k2: {float(dist[1])!r}
    dist_p1: {float(dist[2])!r}
    dist_p2: {float(dist[3])!r}
    dist_k3: {float(dist[4])!r}
    t_imu_lidar: "0,0,0"
    R_imu_lidar: "1,0,0,0,1,0,0,0,1"
    t_imu_camera: "0,0,0"
    R_imu_camera: "1,0,0,0,1,0,0,0,1"
gp:
    grid: {MAP_GRID}
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


def run_bag_check(bag: str, ds: str, common: str, want, gt_positions, dev):
    """examples/run_bag on the card in a subprocess, as a user runs it:
    exit 0, every artifact, each pose in pose.txt equal to the livo phase's
    front-end position after the sweep that emitted the frame (within 1e-4
    m: the bag holds the points as float32 and times as integer ns; 'text_
    equal_rows' counts the rows whose formatted text is identical), and the
    ATE of those poses < LIVO_ATE_MAX."""
    from gslivm_tpu_torch.config import load_config, load_yaml
    from gslivm_tpu_torch.utils.outputs import append_tum_pose

    raw = load_yaml(ds)
    cfg = load_config({k: v for k, v in raw.items() if k != "dataset"}, load_yaml(common))
    assert cfg == livo_config(), "the bag run's configuration is not the livo phase's"
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "gslivm_tpu_torch.examples.run_bag", bag,
               "--dataset", ds, "--common", common, "--out", out, "--device", str(dev)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        listing = sorted(os.listdir(out))
        pngs = os.listdir(os.path.join(out, "training")) \
            if os.path.isdir(os.path.join(out, "training")) else []
        pose_file = os.path.join(out, "pose.txt")
        rows = np.loadtxt(pose_file, ndmin=2) if os.path.exists(pose_file) else np.zeros((0, 8))
        lines = open(pose_file).read().splitlines() if os.path.exists(pose_file) else []
        ref_file = os.path.join(out, "livo_pose.txt")
        for t, p in zip(rows[:, 0], want):
            append_tum_pose(ref_file, t, p, [0.0, 0.0, 0.0, 1.0])
        ref_lines = open(ref_file).read().splitlines() if len(rows) else []
    stdout = proc.stdout.splitlines()

    def line(prefix):
        ln = next((x for x in stdout if x.startswith(prefix)), None)
        return json.loads(ln[len(prefix):]) if ln else None

    got = rows[:, 1:4]
    n = min(len(got), len(want))
    dev_m = float(np.abs(got[:n] - want[:n]).max()) if n else None
    ate = float(np.sqrt(np.mean(np.sum((got - gt_positions[:len(got)]) ** 2, axis=1)))) \
        if len(got) else None
    out = {"command": " ".join(["python", *cmd[1:3], "<bag>", "--dataset", "<yaml>",
                                "--common", "<empty yaml>", "--out", "<tmp>", *cmd[-2:]]),
           "returncode": proc.returncode, "seconds": seconds, "artifacts": listing,
           "training_pngs": len(pngs), "poses": len(got), "livo_frames": len(want),
           "max_pose_deviation_m": dev_m, "pose_tol_m": 1e-4,
           "text_equal_rows": sum(a.split()[1:4] == b.split()[1:4]
                                  for a, b in zip(lines, ref_lines)),
           "ate_m": ate, "ate_max_m": LIVO_ATE_MAX,
           "bag": line("bag: "), "pipeline": line("pipeline: "),
           "keyframes": line("keyframes: "),
           "eval": next((x for x in stdout if x.startswith("eval:")), None),
           "stderr_tail": proc.stderr[-2000:] if proc.returncode else ""}
    assert proc.returncode == 0, out
    assert {"map.ply", "rgb_map.pcd", "pose.txt", "log_time.txt", "training"} <= set(listing) \
        and pngs, out
    assert len(got) == len(want) and dev_m <= 1e-4, out
    assert ate < LIVO_ATE_MAX, out
    return out


def profiled(fn):
    """Wall time, device busy time, idle share, launches and the top
    kernels by device time of one fn() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side ranges of user annotations (e.g. Adam's step) span
    # kernels that are listed on their own, so they are left out
    kernels_us = sorted(
        ((getattr(e, "self_device_time_total", 0), e.key, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)), reverse=True)
    busy_ms = sum(us for us, _, _ in kernels_us) / 1e3
    # PyTorch's index_add_ (and index_copy_) kernels: indexFunc*Index
    index_add = [(us, c) for us, k, c in kernels_us if "indexFunc" in k]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms,
                launches=sum(c for _, _, c in kernels_us),
                index_add={"calls": sum(c for _, c in index_add),
                           "device_ms": sum(us for us, _ in index_add) / 1e3},
                top=[{"kernel": k[:100], "device_ms": us / 1e3, "calls": c}
                     for us, k, c in kernels_us[:12]])


def progress(*parts):
    """A tool's progress lines, on stderr (stdout holds the phases' JSON)."""
    print(*parts, file=sys.stderr, flush=True)


def counted(counters, fn):
    """fn() with every kernel's launch counter set to 0 just before it;
    returns (fn's result, the launches by kernel read just after)."""
    import torch

    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def uncounted(counters, fn):
    """fn(), its launches taken back out of every kernel's counter."""
    saved = [c.launches for c in counters.values()]
    try:
        return fn()
    finally:
        for c, n in zip(counters.values(), saved):
            c.launches = n


def quality_phase(dev, profiled, counters) -> tuple[dict, dict]:
    """tools/quality_bench at the JAX record's settings: overflow 0 at every
    curve point, every loss finite, the tool's 25 dB floor; beside it the
    JAX reference's quality (QUALITY_r05.json). The idle share of training
    is estimated from QUALITY_PROFILE_ITERS more iterations of the trained
    map under the profiler (not counted): 1 - their device busy ms per
    iteration x iterations / the run's train seconds. K1, K2 and K3 are
    held against their plain versions on the trained map (not counted)."""
    import torch

    from gslivm_tpu_torch.tools import quality_bench

    args = quality_bench.build_argparser().parse_args(QUALITY_ARGV)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()  # what earlier phases keep alive
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (result, info), launches = counted(
        counters, lambda: quality_bench.run(args, device=dev, log=progress))
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mapper = info.pop("mapper")
    # K1, K2 and K3 against their plain versions at the trained map's
    # capacity, refitted budgets and views (not counted)
    kernel_parity = uncounted(
        counters, lambda: map_kernel_parity(mapper, dev, (args.width, args.height)))
    window = uncounted(counters, lambda: profiled(
        lambda: [mapper.train_iteration() for _ in range(QUALITY_PROFILE_ITERS)]))
    busy_per_iter = window["device_busy_ms"] / QUALITY_PROFILE_ITERS
    with open(QUALITY_RECORD) as f:
        record = json.load(f)
    fields = {**result, "seconds": seconds, "ingest_s": info["ingest_s"],
              "train_seconds": info["train_s"], "curve": info["curve"],
              "prunes": info["prunes"], "budget_refits": info["budget_refits"],
              "overflow_escalations": info["overflow_escalations"],
              "budget_events": info["budget_events"],
              "overflowed_iters": info["overflowed_iters"],
              "nonfinite_losses": info["nonfinite_losses"],
              "gaussians_final": info["gaussians_final"], "capacity": info["capacity"],
              "settings_final": info["settings"], "peak_memory_gb": peak_gb,
              "memory_at_start_gb": mem0 / 1e9,
              "train_idle_share_est":
                  1.0 - busy_per_iter * args.iters / (info["train_s"] * 1e3),
              "profile_window": {"iters": QUALITY_PROFILE_ITERS,
                                 **{k: window[k] for k in ("wall_ms", "device_busy_ms",
                                                           "idle_share", "launches")}},
              "launches": launches, "kernel_parity": kernel_parity,
              "jax_reference": {"source": "QUALITY_r05.json",
                                **{k: record[k] for k in QUALITY_RECORD_KEYS}},
              "psnr_gap_db": record["final_psnr"] - result["final_psnr"]}
    quality_bench.check_floor(result)
    assert info["nonfinite_losses"] == 0, fields
    assert all(r.get("overflow", 0) == 0 for r in info["curve"]), info["curve"]
    assert all(launches[k] > 0 for k in ("K1", "K2", "K3")), launches
    return fields, launches


def quality_diag_phase(dev, counters) -> tuple[dict, dict]:
    """tools/quality_diag init (the GP-initialised map's keyframe PSNR) and
    oracle (splats on the exact surfaces, DIAG_ORACLE_ITERS iterations,
    then K1, K2 and K3 against their plain versions on its map, not
    counted); pipeline is left out here, quality runs its flow."""
    from gslivm_tpu_torch.tools import quality_diag

    out, total = {}, {k: 0 for k in counters}
    for argv in (["init"], ["oracle", "--iters", str(DIAG_ORACLE_ITERS)]):
        args = quality_diag.build_argparser().parse_args(argv)
        t0 = time.perf_counter()
        (res, mapper), launches = counted(
            counters, lambda a=args: quality_diag.run(a, device=dev, log=progress))
        rows = {"init": res["init_psnr"], **({"final": res["final_psnr"]}
                                             if "final_psnr" in res else {})}
        summary = {tag: {"mean_psnr": float(np.mean([r["psnr"] for r in rs])),
                         "min_psnr": float(np.min([r["psnr"] for r in rs])),
                         "max_psnr": float(np.max([r["psnr"] for r in rs])),
                         "mean_ssim": float(np.mean([r["ssim"] for r in rs])),
                         "per_keyframe_psnr": [r["psnr"] for r in rs]}
                   for tag, rs in rows.items()}
        out[argv[0]] = {"seconds": time.perf_counter() - t0, "gaussians": res["gaussians"],
                        "setup_s": res["setup_s"], **summary, "launches": launches,
                        **{k: res[k] for k in ("psnr_curve", "iters", "train_s",
                                               "iters_per_s") if k in res}}
        assert all(np.isfinite(s["mean_psnr"]) for s in summary.values()), out
        assert launches["K1"] > 0 and launches["K3"] > 0, launches
        for k in total:
            total[k] += launches[k]
        if argv[0] == "oracle":  # the kernels at the planted map's shapes (not counted)
            size = (args.width, args.height)
            out["oracle"]["kernel_parity"] = uncounted(
                counters, lambda m=mapper: map_kernel_parity(m, dev, size))
        del mapper
    assert out["oracle"]["launches"]["K2"] > 0, out
    return out, total


def loop_profile_phase(dev, counters) -> tuple[dict, dict]:
    """tools/profile_iteration at its defaults (stages A, A2, B, D, C with
    device busy time) and tools/profile_ingest (10 frames)."""
    from gslivm_tpu_torch.tools import profile_ingest, profile_iteration

    t0 = time.perf_counter()
    it, l_it = counted(counters, lambda: profile_iteration.run(
        profile_iteration.build_argparser().parse_args([]), device=dev, log=progress))
    ing, l_ing = counted(counters, lambda: profile_ingest.run(
        profile_ingest.build_argparser().parse_args([]), device=dev, log=progress))
    assert all(l_it[k] > 0 for k in ("K1", "K2", "K3")), l_it
    assert ing["split"]["total"] > 0 and ing["stages"]["untimed"] >= 0, ing
    launches = {k: l_it[k] + l_ing[k] for k in counters}
    return {"seconds": time.perf_counter() - t0, "iteration": it, "ingest": ing,
            "launches": {"profile_iteration": l_it, "profile_ingest": l_ing}}, launches


def sweep_loss_cotangent(tiles):
    """The tile cotangent of exp_block's loss, sum(C^2) + 0.1 sum(A)."""
    import torch

    g = torch.zeros_like(tiles)
    g[:, 0:3], g[:, 4] = 2.0 * tiles[:, 0:3], 0.1
    return g


def band_loss_cotangent(tiles):
    """The tile cotangent of band_projection's loss, sum(C) + 0.1 sum(A)."""
    import torch

    g = torch.zeros_like(tiles)
    g[:, 0:3], g[:, 4] = 1.0, 0.1
    return g


def blocks_phase(dev, counters) -> tuple[dict, dict]:
    """tools/exp_block's sweep on the bench scene, then crosscheck_blocks
    for every swept shape but (2, 2), with the tool's gates; then K1 and
    K2 against their plain versions at each shape's fitted budgets. A
    shape that fails, or overflows at its fitted budgets or in the
    cross-check, fails the phase."""
    from gslivm_tpu_torch.tools import crosscheck_blocks, exp_block

    def run():
        rows = exp_block.sweep(device=dev, log=progress)
        bad = [r for r in rows if "failed" in r or r["overflow"]]
        assert not bad, bad
        args, cam = exp_block.bench_scene(device=dev)
        checks = [crosscheck_blocks.crosscheck(bx, by, args, cam, log=progress)
                  for bx, by in exp_block.BLOCKS if (bx, by) != crosscheck_blocks.REF_BLOCK]
        assert all(c["overflow"] == [0, 0] for c in checks), checks
        return rows, checks

    t0 = time.perf_counter()
    (rows, checks), launches = counted(counters, run)
    assert launches["K1"] > 0 and launches["K2"] > 0, launches
    plain = uncounted(counters, lambda: bench_kernel_parity(dev, [
        ({"block": r["block"]},
         {"max_instances": r["maxi"], "max_chunks_per_tile": r["mc"],
          "block_x": r["block"][0], "block_y": r["block"][1]}) for r in rows],
        sweep_loss_cotangent))
    return {"seconds": time.perf_counter() - t0, "sweep": rows, "crosscheck": checks,
            "kernel_parity": plain,
            "gates": {"image_max_abs": crosscheck_blocks.IMAGE_TOL,
                      "grad_rel": crosscheck_blocks.GRAD_TOL},
            "launches": launches}, launches


def bench_kernel_parity(dev, cases, cotangent) -> list[dict]:
    """K1 and K2 against their plain versions on the bench scene of
    exp_block and band_projection, once for each (fields, bin_tiles
    keywords) of `cases`; K2 takes the tile cotangent `cotangent(tiles)`.
    Gates as map_kernel_parity's. Returns a row for each case."""
    import torch

    from gslivm_tpu_torch.ops import rasterize_reference
    from gslivm_tpu_torch.ops import rasterize_tiles as rt
    from gslivm_tpu_torch.tools.exp_block import bench_scene

    args, cam = bench_scene(device=dev)
    with torch.no_grad():
        pre = rasterize_reference.preprocess(*args, cam)
    rows = []
    for fields, kw in cases:
        table, binned, cfg = rt.bin_tiles(pre, cam.width, cam.height, **kw)
        k1 = dict.fromkeys(("rows", "ncontrib", "neff", "ckpt", "flags", "pixels", "tiles",
                            "ckpt_values"), 0)
        _, _, k2, _ = tile_kernel_parity(table, binned, cfg, cotangent, True, k1)
        row = {**fields, "overflow": int(binned.overflow), "max_chunks": cfg.max_chunks,
               **k1_fields(k1), "k2_max_scaled_err": k2, "k1_k2_tol": 1e-3}
        rows.append(row)
        assert row["overflow"] == 0 and k2 <= 1e-3, row
        check_k1(k1)
    return rows


def projection_phase(dev, counters) -> tuple[dict, dict]:
    """tools/band_projection for N in PROJECTION_DEVICES (the band's fwd+bwd
    measured, the collectives computed over an assumed link rate; K1 and
    K2 held against their plain versions at each band's shapes), and
    tools/scaling_bench on one NCCL rank in this process (N = 1; larger N
    reported as needing more cards)."""
    from gslivm_tpu_torch.tools import band_projection, scaling_bench
    from gslivm_tpu_torch.tools.multihost_demo import _free_port

    t0 = time.perf_counter()
    bands, l_band = counted(counters, lambda: band_projection.run(
        device=dev, devices=PROJECTION_DEVICES, log=progress))
    assert all(r["overflow"] == 0 for r in bands), bands
    assert l_band["K1"] > 0 and l_band["K2"] > 0, l_band
    band_parity = uncounted(counters, lambda: bench_kernel_parity(dev, [
        ({"pixel_devices": n, "band_rows": geo["band_rows"]},
         {"max_instances": geo["max_instances"], "max_chunks_per_tile": band_projection.MAXCH,
          "capacity_slack": band_projection.SLACK, "block_x": band_projection.BLOCK[0],
          "block_y": band_projection.BLOCK[1], "band_rows": geo["band_rows"],
          "band_start": geo["band_start"]})
        for n in PROJECTION_DEVICES for geo in [band_projection.band_geometry(n)]],
        band_loss_cotangent))
    sargs = scaling_bench.build_argparser().parse_args(SCALING_ARGV)
    scaling, l_scale = counted(counters, lambda: scaling_bench.run_rank(
        sargs, 0, 1, f"tcp://127.0.0.1:{_free_port()}", log=progress))
    assert scaling[0]["devices"] == 1 and scaling[0]["overflow"] == 0, scaling
    assert all("skipped" in r for r in scaling[1:]), scaling
    assert all(l_scale[k] > 0 for k in ("K1", "K2", "K3")), l_scale
    launches = {k: l_band[k] + l_scale[k] for k in counters}
    return {"seconds": time.perf_counter() - t0, "band_projection": bands,
            "band_kernel_parity": band_parity, "scaling_bench": scaling,
            "launches": {"band_projection": l_band, "scaling_bench": l_scale}}, launches


# the stage profilers' runs: (key, tool module, argv)
STAGE_RUNS = (("profile_stages", "profile_stages", []),
              ("profile_stages_bwd", "profile_stages", ["bwd"]),
              ("profile_binning", "profile_binning", []),
              ("microbench_losses", "microbench_losses", []),
              ("microbench_losses_stack", "microbench_losses", ["stack"]),
              ("microbench_gridsample", "microbench_gridsample", []))


def stages_child(out_path: str):
    """The stages phase's tool runs, in the fresh process stages_phase
    starts: the profiler drops records of short windows late in a long
    process. Writes the results and the K1-K3 launches, counted around the
    runs, to out_path as JSON."""
    import importlib

    import torch

    from gslivm_tpu_torch.ops import blur, rasterize_tiles

    counters = {"K1": rasterize_tiles.composite_tiles, "K2": rasterize_tiles.composite_tiles_bwd,
                "K3": blur.blur_cuda}
    dev = torch.device("cuda")

    def run():
        out = {}
        for key, name, argv in STAGE_RUNS:
            tool = importlib.import_module(f"gslivm_tpu_torch.tools.{name}")
            out[key] = tool.run(tool.build_argparser().parse_args(argv), device=dev,
                                log=progress)
        return out

    res, launches = counted(counters, run)
    with open(out_path, "w") as f:
        json.dump({"results": res, "launches": launches}, f)


def stages_phase(dev, counters, blocks) -> tuple[dict, dict]:
    """The stage profilers at their defaults (STAGE_RUNS), in a fresh
    process (stages_child), which counts their K1-K3 launches; no row may
    stay lost; the FULL fwd+bwd busy ms beside `blocks`' (2,2) busy ms of
    this process; then K1/K2 at profile_stages' budgets and K3 on
    microbench_losses' SSIM stack and one of its images against their
    plain versions here (not counted)."""
    import torch

    from gslivm_tpu_torch.ops import blur, losses
    from gslivm_tpu_torch.tools import microbench_losses, profile_stages

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "stages.json")
        cmd = [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.stages_child(sys.argv[1])",
               out]
        proc = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True, timeout=900)
        assert proc.returncode == 0, f"the stages child exited {proc.returncode}"
        with open(out) as f:
            child = json.load(f)
    res, launches = child["results"], child["launches"]
    assert res["profile_stages"]["stats"]["overflow"] == 0, res["profile_stages"]["stats"]
    lost = [(key, r["name"]) for key, out in res.items()
            for r in out.get("cuts", out.get("rows", [])) if r["lost"]]
    assert not lost, f"the profiler lost these rows' records: {lost}"
    assert all(launches[k] > 0 for k in ("K1", "K2", "K3")), launches
    full = next(r for r in res["profile_stages"]["cuts"] if r["name"] == "FULL fwd+bwd")
    ref = next(r for r in blocks["sweep"] if r["block"] == [2, 2])
    kernel_parity = uncounted(counters, lambda: bench_kernel_parity(
        dev, [({"tool": "profile_stages"}, profile_stages.BUDGETS)], sweep_loss_cotangent))

    def k3_check():
        # the stacked SSIM's [15, H, W] and the separate chains' [3, H, W]
        # (a shorter stack takes another strip height)
        imgs = microbench_losses.images(device=dev)
        taps = losses.gaussian_1d()
        out = []
        for x in (microbench_losses.ssim_stack(*imgs), imgs[0]):
            errs = {}
            for name, t in (("taps", taps), ("reversed", taps[::-1].copy())):
                errs[name] = float((blur.blur_cuda(x, t) - blur.blur_plain(x, t)).abs().max())
            out.append({"shape": list(x.shape), "max_abs_err": errs, "tol": 1e-5})
        return out

    k3 = uncounted(counters, k3_check)
    assert all(max(c["max_abs_err"].values()) <= 1e-5 for c in k3), k3
    torch.cuda.empty_cache()
    return {"seconds": time.perf_counter() - t0, **res,
            "full_fwd_bwd_busy_ms": full["busy_ms"], "blocks_2x2_busy_ms": ref["busy_ms"],
            "full_over_blocks_busy": full["busy_ms"] / ref["busy_ms"],
            "kernel_parity": kernel_parity, "k3_parity": k3, "launches": launches}, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "gslivm_tpu_torch")):
        print("chip_smoke: gslivm_tpu_torch/ is not beside this script; run it from "
              "the root of a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gslivm_tpu_torch import convert, kernels
    from gslivm_tpu_torch.models import gaussian_model, training
    from gslivm_tpu_torch.models.cameras import make_camera
    from gslivm_tpu_torch.ops import blur, losses, rasterize_reference, rasterize_tiles
    from gslivm_tpu_torch.ops.binning import CHUNK
    from gslivm_tpu_torch.ops.rasterize import RasterizeSettings, rasterize
    from gslivm_tpu_torch.tools import microbench_fwdablate as ablate
    from gslivm_tpu_torch.tools import microbench_kernelcost as kernelcost
    from gslivm_tpu_torch.tools import microbench_roll as roll
    from gslivm_tpu_torch.tools import profile_step3
    from gslivm_tpu_torch.utils import metrics

    # ---- env ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=kind,
         count=torch.cuda.device_count(), nvidia_smi=smi)

    # ---- build: one nvcc per kernel source, in parallel --------------------
    t0 = time.perf_counter()
    logs = kernels.build()
    usage = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
             for n, log in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs), ptxas=usage)

    # ---- the map: JAX layout -> port -> PLY -> card ------------------------
    settings = RasterizeSettings()  # the mapper's defaults: auto -> tiles
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "map.ply")
        gaussian_model.save_ply(convert.params_from_numpy(make_map(), device="cpu"), ply)
        params = gaussian_model.load_ply(ply, device=dev)
    assert params.capacity == N_GAUSS and int(params.n_active) == N_GAUSS
    cams = [make_camera(np.eye(3), np.asarray(c), WIDTH, HEIGHT, fovx=1.2,
                        fovy=0.8, device=dev) for c in VIEWS]
    bg = torch.ones(3, device=dev)

    # ---- reference: K1's plain version on the same binned inputs ----------
    refs = []
    with torch.no_grad():
        for cam in cams:
            pre = rasterize_reference.preprocess(
                params.xyz, params.get_scaling(), params.get_rotation(),
                params.get_opacity()[:, 0], params.get_features(), cam,
                active_mask=params.active_mask())
            inst, binned, cfg = rasterize_tiles.prepare_tiles(
                pre, WIDTH, HEIGHT, max_instances=settings.max_instances,
                max_chunks_per_tile=settings.max_chunks_per_tile,
                capacity_slack=settings.capacity_slack,
                block_x=settings.block_x, block_y=settings.block_y,
                contrib_stats=settings.contrib_stats)
            args = (inst, binned.sorted_start, binned.tile_nchunks,
                    binned.cnt_allowed, cfg)
            plain = rasterize_tiles.composite_tiles_plain(*args)
            img = rasterize_tiles.tiles_to_image(plain, cfg)[:, :HEIGHT, :WIDTH]
            color = img[0:3] + img[5][None] * bg[:, None, None]
            refs.append(dict(args=args, plain=plain, color=color, binned=binned))
    torch.cuda.synchronize()
    emit("reference", views=len(refs),
         plain_color_mean=[float(r["color"].mean()) for r in refs])

    # ---- serve: the main path, launch counters around it -------------------
    rasterize_tiles.composite_tiles.launches = 0
    blur.blur_cuda.launches = 0
    renders, scores = [], []
    with torch.no_grad():
        for cam, ref in zip(cams, refs):
            out = training.render_params(params, cam, bg, settings)
            scores.append(metrics.image_pair_metrics(out.color, ref["color"]))
            renders.append(out)
    torch.cuda.synchronize()
    launches = {"K1": rasterize_tiles.composite_tiles.launches,
                "K3": blur.blur_cuda.launches}
    for out, s in zip(renders, scores):
        assert out.color.shape == (3, HEIGHT, WIDTH)
        assert bool(torch.isfinite(out.color).all() & torch.isfinite(out.depth).all())
        assert int(out.overflow) == 0, f"binning overflow {int(out.overflow)}"
        # the kernel render and the plain render of one view agree closely
        assert s["psnr"] > 60.0 and s["ssim"] > 0.9999, s
    assert launches["K1"] > 0 and launches["K3"] > 0, launches

    with torch.no_grad():
        render_ms = [cuda_ms(lambda c=c: training.render_params(params, c, bg, settings), 5)
                     for c in cams]
        eval_ms = cuda_ms(lambda: (losses.psnr(renders[0].color, refs[0]["color"]),
                                   losses.ssim(renders[0].color, refs[0]["color"])), 5)
    emit("serve", launches=launches, render_ms=render_ms, psnr_ssim_ms=eval_ms,
         views=[{"num_instances": int(o.num_instances), "max_nchunks": int(o.max_nchunks),
                 "walked_chunks": int(o.walked_chunks), "overflow": int(o.overflow),
                 **s} for o, s in zip(renders, scores)])

    # ---- profile: where one served view's device time goes -----------------
    with torch.no_grad():
        emit("profile", view=0, **profiled(lambda: metrics.image_pair_metrics(
            training.render_params(params, cams[0], bg, settings).color, refs[0]["color"])))

    # ---- k1_parity: K1 vs its plain version, the same binned inputs --------
    k1_err, ncontrib_diff, neff_diff, pairs, in_rect, inst_bytes = 0.0, 0, 0, 0, 0, 0
    k1_ms, plain_ms = [], []
    with torch.no_grad():
        for out, ref in zip(renders, refs):
            args, plain = ref["args"], ref["plain"]
            cfg = args[-1]
            k = rasterize_tiles.composite_tiles(*args)
            # the main path rendered this same image
            img = rasterize_tiles.tiles_to_image(k, cfg)[:, :HEIGHT, :WIDTH]
            assert float((img[3] - out.depth).abs().max()) <= 1e-5 * max(
                float(out.depth.abs().max()), 1.0)
            for row in range(6):
                scale = max(float(plain[:, row].abs().max()), 1.0)
                k1_err = max(k1_err, float((k[:, row] - plain[:, row]).abs().max()) / scale)
            ncontrib_diff += int((k[:, 6] != plain[:, 6]).sum())
            neff_diff += int((k[:, 7, 0] != plain[:, 7, 0]).sum())
            # the (instance, pixel) pairs this run's data makes K1 walk
            b = ref["binned"]
            walked = torch.minimum(b.cnt_allowed.long(), k[:, 7, 0].long() * CHUNK)
            pairs += int(walked.sum()) * cfg.npix
            # of them, those inside the instance's tile-rect: the pairs any
            # design has to evaluate, the work of the bound
            in_rect += rect_pairs(args[0], b, k[:, 7, 0].long(), cfg)
            inst_bytes += int(walked.sum()) * 4 * rasterize_tiles.FEAT
            k1_ms.append(cuda_ms(lambda a=args: rasterize_tiles.composite_tiles(*a), 20))
            plain_ms.append(cuda_ms(lambda a=args: rasterize_tiles.composite_tiles_plain(*a), 3))
    n_views = len(renders)
    n_pix = n_views * cfg.num_tiles * cfg.npix
    n_tiles = n_views * cfg.num_tiles
    k1_flops = in_rect * K1_FLOPS_PER_PAIR / n_views
    k1_bytes = (inst_bytes / n_views + cfg.num_tiles * 3 * 4
                + cfg.num_tiles * 8 * cfg.npix * 4)
    k1_bound = max(k1_flops / PEAK_F32, k1_bytes / PEAK_BYTES) * 1e3
    # the bound as it was counted before the warp-uniform rect skip: every
    # walked pair evaluated
    k1_bound_walked = max(pairs * K1_FLOPS_PER_PAIR / n_views / PEAK_F32,
                          k1_bytes / PEAK_BYTES) * 1e3
    emit("k1_parity", max_scaled_err=k1_err, tol=1e-3,
         ncontrib_mismatch_pixels=ncontrib_diff, pixels=n_pix,
         neff_mismatch_tiles=neff_diff, tiles=n_tiles,
         kernel_ms=k1_ms, plain_ms=plain_ms, walked_pairs_per_view=pairs // n_views,
         rect_pairs_per_view=in_rect // n_views,
         outside_rect_share=1.0 - in_rect / pairs, bound_ms=k1_bound,
         bound_ms_walked=k1_bound_walked)
    assert k1_err <= 1e-3, k1_err
    assert ncontrib_diff <= 1e-3 * n_pix and neff_diff <= 1e-3 * n_tiles

    # ---- k3_parity: K3 on the SSIM stacks of view 0 ------------------------
    # served: ssim without ref_stats blurs [a, b, a^2, b^2, ab] (15 slices);
    # training: ssim with the cached GT statistics blurs [a, a^2, ab] (9)
    taps = losses.gaussian_1d()
    a, b = renders[0].color, refs[0]["color"]
    stacks = {"serve": torch.cat([a, b, a * a, b * b, a * b]).contiguous(),
              "train": torch.cat([a, a * a, a * b]).contiguous()}
    k3 = {}
    with torch.no_grad():
        for key, st in stacks.items():
            errs = {}
            for orient, t in (("taps", taps), ("reversed", taps[::-1])):
                errs[orient] = float((blur.blur_cuda(st, t) - blur.blur_plain(st, t)).abs().max())
            n_el = st.numel()
            k3_bytes = 2 * n_el * 4              # one read, one write per element
            k3_flops = n_el * 2 * 2 * len(taps)  # two passes of k multiply-adds
            n, h, w = st.shape
            vec = blur.float4_rows(w, st.data_ptr(), st.data_ptr())
            resident = blur.resident_blocks(torch.cuda.current_device(), len(taps), vec)
            strip = blur.strip_rows(n, h, w, resident)
            k3[key] = {"shape": list(st.shape), "max_abs_err": errs, "vec": vec, "strip": strip,
                       "blocks": n * -(-w // blur.BLOCK_COLS) * -(-h // strip),
                       "resident_blocks": resident,
                       "kernel_ms": cuda_ms(lambda st=st: blur.blur_cuda(st, taps), 50),
                       "copy_ms": cuda_ms(lambda st=st: st.clone(), 50),
                       "plain_ms": cuda_ms(lambda st=st: blur.blur_plain(st, taps), 5),
                       "bytes": k3_bytes, "flops": k3_flops,
                       "bound_ms": max(k3_bytes / PEAK_BYTES, k3_flops / PEAK_F32) * 1e3,
                       "bound_by": ("bytes" if k3_bytes / PEAK_BYTES >= k3_flops / PEAK_F32
                                    else "operations")}
        # library yardstick: one cuDNN convolution in full f32 (never on the path)
        stack = stacks["serve"]
        torch.backends.cudnn.allow_tf32 = False
        w2d = torch.as_tensor(np.outer(taps, taps), device=dev)[None, None]
        conv = torch.nn.functional.conv2d(stack[:, None], w2d, padding=len(taps) // 2)[:, 0]
        conv_err = float((conv - blur.blur_plain(stack, taps)).abs().max())
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
            stack[:, None], w2d, padding=len(taps) // 2), 20)
    k3_usage = kernels.usage("blur", len(taps), int(k3["serve"]["vec"]))
    k3_err = max(e for r in k3.values() for e in r["max_abs_err"].values())
    emit("k3_parity", tol=1e-5, stacks=k3, conv2d_ms=lib_ms, conv2d_max_abs_err=conv_err,
         usage=k3_usage)
    assert k3_err <= 1e-5, k3
    del stacks, conv

    # ---- train: the training path, launch counters around its first step --
    rng = np.random.default_rng(SIMI_SEED)
    d = make_map()
    d["features_dc"] = d["features_dc"] + 0.2 * rng.normal(size=d["features_dc"].shape)
    d["xyz"] = d["xyz"] + 0.02 * rng.normal(size=d["xyz"].shape)
    tparams = convert.params_from_numpy(d, device=dev)
    optimizer = training.make_optimizer(tparams)
    simi = convert.simi_from_numpy(make_simi(rng), device=dev)
    gt = torch.stack([out.color for out in renders])  # K1 renders of the map
    with torch.no_grad():
        stats = [torch.stack(x) for x in zip(*(losses.ssim_ref_stats(g) for g in gt))]

    def step(n_cams=len(cams)):
        # the last two of three cameras are the delta-depth history pair
        return training.train_step(tparams, optimizer, cams[:n_cams], gt[:n_cams], simi,
                                   settings=settings, n_history_pairs=int(n_cams == 3),
                                   gt_stats=[x[:n_cams] for x in stats])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rasterize_tiles.composite_tiles.launches = 0
    rasterize_tiles.composite_tiles_bwd.launches = 0
    blur.blur_cuda.launches = 0
    history = [step()]
    torch.cuda.synchronize()
    train_launches = {"K1": rasterize_tiles.composite_tiles.launches,
                      "K2": rasterize_tiles.composite_tiles_bwd.launches,
                      "K3": blur.blur_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # one step: a K1 and a K2 per view, a forward and a backward K3 per view
    assert train_launches == {"K1": 3, "K2": 3, "K3": 6}, train_launches
    history += [step() for _ in range(TRAIN_STEPS - 1)]
    steps = [{"loss": float(m.loss), "image_loss": float(m.image_loss),
              "simi": float(m.simi), "delta": float(m.delta), "psnr": float(m.psnr),
              "ssim": float(m.ssim), "overflow": int(m.overflow),
              "num_instances": int(m.num_instances), "max_nchunks": int(m.max_nchunks),
              "walked_chunks": int(m.walked_chunks)} for m in history]
    assert all(r["overflow"] == 0 for r in steps), steps
    assert all(np.isfinite(r["loss"]) for r in steps), steps
    assert steps[-1]["loss"] < steps[0]["loss"], steps
    step3_ms = cuda_ms(step, 5)
    step1_ms = cuda_ms(lambda: step(1), 5)
    emit("train", launches=train_launches, steps=steps, train_step3_ms=step3_ms,
         train_step_ms=step1_ms, peak_memory_gb_step1=peak_gb)

    # ---- train_profile: where one three-camera step's device time goes -----
    emit("train_profile", cameras=3, **profiled(step))

    # ---- k2_parity: K1's checkpoints and K2 at full size, view 0 -----------
    pre = rasterize_reference.preprocess(
        tparams.xyz, tparams.get_scaling(), tparams.get_rotation(),
        tparams.get_opacity()[:, 0], tparams.get_features(), cams[0],
        active_mask=tparams.active_mask())
    table, binned, cfg = rasterize_tiles.bin_tiles(
        pre, WIDTH, HEIGHT, max_instances=settings.max_instances,
        max_chunks_per_tile=settings.max_chunks_per_tile,
        capacity_slack=settings.capacity_slack, block_x=settings.block_x,
        block_y=settings.block_y, contrib_stats=False)
    contrib_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    chunk_terms = rasterize_tiles._chunk_terms

    def counting_chunk_terms(*a):
        # the plain K1 calls this once per chunk of every tile group; tiles
        # that are done or past their run contribute nothing, so the sum is
        # the contributing (instance, pixel) pairs of this view
        nonlocal contrib_pairs
        m = chunk_terms(*a)
        contrib_pairs = contrib_pairs + m.contrib.sum()
        return m

    with torch.no_grad():
        inst = table.detach().t()[binned.gid_sorted.long()].contiguous()
        kargs = (inst, binned.sorted_start, binned.tile_nchunks, binned.cnt_allowed, cfg)
        tiles, ckpt = rasterize_tiles.composite_tiles(*kargs, save_ckpt=True)
        rasterize_tiles._chunk_terms = counting_chunk_terms
        try:
            ptiles, pckpt = rasterize_tiles.composite_tiles_plain(*kargs, save_ckpt=True)
        finally:
            rasterize_tiles._chunk_terms = chunk_terms
        neff = tiles[:, 7, 0].long()
        assert torch.equal(neff, ptiles[:, 7, 0].long())
        walked_rows = torch.arange(cfg.max_chunks, device=dev)[None, :] < neff[:, None]
        ckpt_err = float((ckpt.abs() - pckpt.abs())[walked_rows].abs().max())
        flag_flips = int(((ckpt < 0) != (pckpt < 0))[walked_rows].sum())
        del pckpt
    # the cotangents of view 0's real loss, (1-λ)L1 + λ(1-SSIM), at K1's rows
    tiles_g = tiles.clone().requires_grad_(True)
    img = rasterize_tiles.tiles_to_image(tiles_g, cfg)[:, :HEIGHT, :WIDTH]
    color = img[0:3] + img[5][None] * bg[:, None, None]
    lam = training.GsOptimParams().lambda_dssim
    view_loss = ((1.0 - lam) * losses.l1_loss(color, gt[0]) + lam * (
        1.0 - losses.ssim(color, gt[0], ref_stats=(stats[0][0], stats[1][0]))))
    (g_tiles,) = torch.autograd.grad(view_loss, tiles_g)
    n, dg = table.shape[1], settings.depth_grad
    bwd_args = (inst, binned.sorted_start, binned.cnt_allowed, g_tiles.contiguous(),
                tiles, ckpt, cfg)
    with torch.no_grad():
        d_k = rasterize_tiles.composite_tiles_bwd(*bwd_args, n, dg)
        rows_p = rasterize_tiles.composite_tiles_bwd_plain(*bwd_args, dg)
        d_p = rasterize_tiles.scatter_instance_grads(rows_p, n, dg)
        torch.cuda.synchronize()
        k2_err = max(scaled_err(d_k[c], d_p[c]) for c in range(10))
        assert not bool(d_k[10:].any()) and (dg or not bool(d_k[9].any()))
        # run to run: the atomics sum a gaussian's instances in varying order
        runs = [rasterize_tiles.composite_tiles_bwd(*bwd_args, n, dg) for _ in range(5)]
        k2_spread = max(float((r[c] - runs[0][c]).abs().max())
                        / max(float(d_p[c].abs().max()), 1e-12)
                        for r in runs[1:] for c in range(10))
        del runs
    leaves = {"xyz": tparams.xyz, "scaling": tparams.scaling, "rotation": tparams.rotation,
              "opacity": tparams.opacity, "features_dc": tparams.features_dc}
    gk = torch.autograd.grad(table, list(leaves.values()), d_k, retain_graph=True)
    gp = torch.autograd.grad(table, list(leaves.values()), d_p)
    param_err = {name: scaled_err(a, b) for name, a, b in zip(leaves, gk, gp)}
    n_slots = rows_p.shape[0]
    del rows_p
    with torch.no_grad():
        k1_fwd_ms = cuda_ms(lambda: rasterize_tiles.composite_tiles(*kargs), 10)
        ckpt_ms = cuda_ms(lambda: rasterize_tiles.composite_tiles(*kargs, save_ckpt=True), 10)
        k2_ms = cuda_ms(lambda: rasterize_tiles.composite_tiles_bwd(*bwd_args, n, dg), 10)
        k2_plain_ms = cuda_ms(lambda: rasterize_tiles.scatter_instance_grads(
            rasterize_tiles.composite_tiles_bwd_plain(*bwd_args, dg), n, dg), 2)
    _, slot = walked_slots(binned, neff)
    walked_inst = int(slot.numel())
    walked_chunks = int(neff.sum())
    k2_pairs = walked_inst * cfg.npix
    k2_rect_pairs = rect_pairs(inst, binned, neff, cfg)
    n_terms = 10 if dg else 9
    k2_flops = k2_rect_pairs * K1_FLOPS_PER_PAIR + int(contrib_pairs) * K2_FLOPS_PER_CONTRIB
    # read once: cotangent rows C, D, A, T and K1's rows C, D, A, T_final (12
    # per pixel), neff, the tile starts and counts, the walked checkpoint
    # rows and instances; written once: the [16, P] gradient, and the
    # walked instances' terms added to it (a read and a write each)
    k2_bytes = (cfg.num_tiles * (12 * cfg.npix + 3) * 4 + walked_chunks * cfg.npix * 4
                + walked_inst * 4 * rasterize_tiles.FEAT + rasterize_tiles.FEAT * n * 4
                + 2 * walked_inst * n_terms * 4)
    k2_bound = max(k2_flops / PEAK_F32, k2_bytes / PEAK_BYTES) * 1e3
    k2_bound_by = "operations" if k2_flops / PEAK_F32 >= k2_bytes / PEAK_BYTES else "bytes"
    # the bound as it was counted before the warp-uniform rect skip (every
    # walked pair evaluated, the per-instance rows written)
    k2_bound_walked = max(
        (k2_pairs * K1_FLOPS_PER_PAIR + int(contrib_pairs) * K2_FLOPS_PER_CONTRIB) / PEAK_F32,
        (cfg.num_tiles * (7 * cfg.npix + 3) * 4 + walked_chunks * cfg.npix * 4
         + 2 * walked_inst * 4 * rasterize_tiles.FEAT) / PEAK_BYTES) * 1e3
    ckpt_bytes = cfg.num_tiles * cfg.max_chunks * cfg.npix * 4
    emit("k2_parity", view=0, max_scaled_err=k2_err, param_scaled_err=param_err, tol=1e-3,
         run_spread=k2_spread, ckpt_max_abs_err=ckpt_err, ckpt_flag_flips=flag_flips,
         ckpt_walked_values=int(walked_rows.sum()) * cfg.npix, k1_ms=k1_fwd_ms,
         k1_ckpt_ms=ckpt_ms, ckpt_bytes_per_view=ckpt_bytes, kernel_ms=k2_ms,
         plain_ms=k2_plain_ms, instance_slots=n_slots, walked_instances=walked_inst,
         walked_pairs=k2_pairs, rect_pairs=k2_rect_pairs,
         contrib_pairs=int(contrib_pairs), walked_chunks=walked_chunks, flops=k2_flops,
         bytes=k2_bytes, bound_ms=k2_bound, bound_by=k2_bound_by,
         bound_ms_walked=k2_bound_walked)
    assert k2_err <= 1e-3 and max(param_err.values()) <= 1e-3, (k2_err, param_err)
    assert ckpt_err <= 1e-3 and flag_flips <= 1e-3 * int(walked_rows.sum()) * cfg.npix
    del tiles, ckpt, ptiles, d_k, d_p, table, pre

    # ---- tile_usage: K1 and K2 as the main path launches them --------------
    # the runtime's report for this card at the main path's pixels a thread
    # (K2 with the train step's depth term), and the waves of its blocks
    ppt = cfg.npix // 256
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile_usage = {"K1": kernels.usage("tile_forward", ppt),
                  "K2": kernels.usage("tile_backward", ppt, int(dg))}
    for u in tile_usage.values():
        u["waves"] = cfg.num_tiles / (u["blocks_per_sm"] * sms)
    emit("tile_usage", pixels_per_thread=ppt, sms=sms, blocks=cfg.num_tiles, **tile_usage)

    # ---- tile_sass: instruction counts of the same K1 and K2 ----------------
    tile_sass = {}
    for key, lib, name in (("K1", "tile_forward", f"tile_forward_kernelILi{ppt}E"),
                           ("K2", "tile_backward",
                            f"tile_backward_kernelILi{ppt}ELb{int(dg)}E")):
        counts = sass_counts(kernels.library_path(lib))
        if counts is not None:
            tile_sass[key] = next((c for k, c in counts.items() if name in k), None)
    emit("tile_sass", **tile_sass)

    # ---- grad_parity: tiles vs naive gradients on a small scene ------------
    grad_err = {}
    for block in ((1, 1), (2, 2)):
        rng = np.random.default_rng(2)
        q = rng.normal(size=(3000, 4))
        scene = [torch.as_tensor(a, dtype=torch.float32, device=dev).requires_grad_(True)
                 for a in (rng.normal(0, 1.0, (3000, 3)) + [0, 0, 4.0],
                           rng.uniform(0.02, 0.08, (3000, 3)),
                           q / np.linalg.norm(q, axis=1, keepdims=True),
                           rng.uniform(0.2, 0.95, 3000),
                           rng.uniform(-0.3, 0.8, (3000, 1, 3)))]
        scam = make_camera(np.eye(3), np.zeros(3), 160, 120, fovx=1.0, fovy=0.8, device=dev)
        sgt = torch.as_tensor(rng.uniform(size=(3, 120, 160)), dtype=torch.float32, device=dev)
        grads = {}
        for backend in ("tiles", "naive"):
            out = rasterize(*scene, scam, bg_color=torch.tensor([0.2, 0.5, 0.8], device=dev),
                            settings=RasterizeSettings(backend=backend, block_x=block[0],
                                                       block_y=block[1], max_instances=1 << 17))
            loss = ((out.color - sgt) ** 2).sum() + 0.1 * out.acc.sum()
            grads[backend] = torch.autograd.grad(loss, scene)
        grad_err[f"{block[0]}x{block[1]}"] = {
            name: scaled_err(a, b) for name, a, b in zip(
                ("means", "scales", "quats", "opacities", "shs"),
                grads["tiles"], grads["naive"])}
    emit("grad_parity", scene="160x120, 3000 gaussians", tol=1e-3, scaled_err=grad_err)
    assert max(e for blk in grad_err.values() for e in blk.values()) <= 1e-3, grad_err

    # ---- kernelcost: K1/K2 cost split; K1-K3's tool counters from here ------
    # (T1 and T2 launch none of K1-K3; step_profile ends the count)
    rasterize_tiles.composite_tiles.launches = 0
    rasterize_tiles.composite_tiles_bwd.launches = 0
    blur.blur_cuda.launches = 0
    cost = kernelcost.sweep(device=dev, reps=10)
    k1_slope = cost["fits"]["k1_ms"]["slope_us_per_chunk"]
    emit("kernelcost", **cost)

    # ---- t1_fetch: the chunk-fetch tool (T1), counters around its run -----
    roll.fetch_sum.launches = 0
    t1_runs = {v: roll.run(v, device=dev, reps=100) for v in roll.VARIANTS}
    torch.cuda.synchronize()
    t1_launches = roll.fetch_sum.launches
    assert t1_launches > 0, t1_launches
    t1, sums = {}, {}
    with torch.no_grad():
        for v in roll.VARIANTS:
            inst_np, off_np, nch_np = roll.make_inputs(v)
            inst = convert.inst_from_numpy(inst_np, device=dev)
            off, nch = torch.from_numpy(off_np).to(dev), torch.from_numpy(nch_np).to(dev)
            sums[v] = roll.fetch_sum(inst, off, nch, v)
            plain = roll.fetch_sum_plain(inst, off, nch)
            t1[v] = {**t1_runs[v],
                     "max_rel_err": float(((sums[v] - plain).abs() / plain.abs()).max()),
                     "max_abs_err": float((sums[v] - plain).abs().max()),
                     "plain_ms": cuda_ms(lambda: roll.fetch_sum_plain(inst, off, nch), 10)}
            if v == "A":
                # library yardstick (never on a path): one norm per tile over
                # the same bytes, the aligned runs being contiguous rows
                rows = inst[:roll.T * roll.NCH * CHUNK].view(roll.T, -1)
                norm = torch.linalg.vector_norm(rows, dim=1)
                t1[v]["library_ms"] = cuda_ms(lambda: torch.linalg.vector_norm(rows, dim=1), 100)
                t1[v]["library_rel_err"] = float(((norm * norm - plain).abs() / plain).max())
            del inst, off, nch, plain
    same_sums = max(float(((sums[v] - sums["B"]).abs() / sums["B"].abs()).max()) for v in "CD")
    emit("t1_fetch", tiles=roll.T, chunks_per_tile=roll.NCH, launches=t1_launches,
         tol_rel=1e-5, variants=t1, b_c_d_max_rel_diff=same_sums,
         unaligned_cost_ms={v: t1[v]["ms"] - t1["A"]["ms"] for v in "BCD"})
    assert max(r["max_rel_err"] for r in t1.values()) <= 1e-5, t1
    assert same_sums <= 1e-5, same_sums

    # ---- t2_ablate: the K1 ablation tool (T2), counters around its run ----
    inputs = ablate.device_inputs(dev)
    ablate.chunk_walk.launches = 0
    t2_runs = {v: ablate.run(v, device=dev, reps=20, inputs=inputs) for v in ablate.VARIANTS}
    torch.cuda.synchronize()
    t2_launches = ablate.chunk_walk.launches
    assert t2_launches > 0, t2_launches
    t2_work = ablate.work(inputs[2], inputs[3])
    t2 = {}
    with torch.no_grad():
        for v in ablate.VARIANTS:
            k = ablate.chunk_walk(*inputs, ablate.GX, v)
            p = ablate.chunk_walk_plain(*inputs, ablate.GX, v)
            err = max(float((k[:, r] - p[:, r]).abs().max())
                      / max(float(p[:, r].abs().max()), 1.0) for r in range(6))
            t2[v] = {**t2_runs[v], "max_scaled_err": err,
                     "max_abs_err": float((k[:, :6] - p[:, :6]).abs().max()),
                     "saves_us_per_chunk": t2_runs["full"]["us_per_chunk"]
                     - t2_runs[v]["us_per_chunk"],
                     "usage": kernels.usage("microbench_fwdablate", ablate.VARIANTS.index(v))}
            del k, p
        t2_plain_ms = cuda_ms(lambda: ablate.chunk_walk_plain(*inputs, ablate.GX, "full"), 2)
    del inputs
    # static instruction counts of each variant's kernel (template <V>)
    sass = sass_counts(kernels.library_path("microbench_fwdablate"))
    if sass is not None:
        sass = {ablate.VARIANTS[int(re.search(r"ILi(\d+)E", name).group(1))]: c
                for name, c in sass.items() if "ablate_kernel" in name}
    # T2 walks a chunk as K1 does: FULL's time per chunk beside K1's slope
    # from kernelcost in this run
    emit("t2_ablate", tiles=ablate.GX * ablate.GY, chunks_per_tile=ablate.NCH,
         launches=t2_launches, tol=1e-3, variants=t2, full_plain_ms=t2_plain_ms,
         k1_slope_us_per_chunk=k1_slope,
         full_over_k1_slope=t2["full"]["us_per_chunk"] / k1_slope, sass=sass, **t2_work)
    assert max(r["max_scaled_err"] for r in t2.values()) <= 1e-3, t2

    # ---- step_profile: the train step's stages (counters read after it) ----
    emit("step_profile", **profile_step3.run(device=dev, reps=10))
    torch.cuda.synchronize()
    tool_launches = {"K1": rasterize_tiles.composite_tiles.launches,
                     "K2": rasterize_tiles.composite_tiles_bwd.launches,
                     "K3": blur.blur_cuda.launches}

    # ---- map_parity, map: the incremental mapper ---------------------------
    from gslivm_tpu_torch.config import Config, GpParams
    from gslivm_tpu_torch.frontend import synthetic

    t0 = time.perf_counter()
    map_cfg = Config(gp=GpParams(grid=MAP_GRID))
    frames_cpu = synthetic.make_sequence(n_frames=MAP_FRAMES, width=MAP_W, height=MAP_H,
                                         points_per_frame=MAP_POINTS, device="cpu")
    frames = [frame_to(f, dev) for f in frames_cpu]
    scene_s = time.perf_counter() - t0
    emit("map_parity", scene_seconds=scene_s, **map_parity(
        frames_cpu[:MAP_PARITY_FRAMES], frames[:MAP_PARITY_FRAMES], map_cfg, dev))
    del frames_cpu
    counters = {"K1": rasterize_tiles.composite_tiles, "K2": rasterize_tiles.composite_tiles_bwd,
                "K3": blur.blur_cuda}
    map_fields, map_launches = map_loop(frames, map_cfg, dev, profiled, counters)
    emit("map", **map_fields)
    del frames

    # ---- livo, checkpoint, run_synthetic: the system's entry point ---------
    t0 = time.perf_counter()
    stream = synthetic.dolly_stream(LIVO_SWEEPS, LIVO_W, LIVO_H, LIVO_POINTS)
    stream_s = time.perf_counter() - t0
    livo_cfg = livo_config()
    livo_fields, livo_launches, livo_mapper, est = livo_serial(
        stream, livo_cfg, dev, profiled, counters)
    overlap, est_overlap = livo_overlap(stream, livo_cfg, dev)
    same_poses = bool(np.array_equal(est, est_overlap))
    emit("livo", stream_seconds=stream_s, **livo_fields, overlap=overlap,
         overlap_positions_equal=same_poses)
    assert same_poses  # the front end is deterministic whatever the mapper does
    bag_dir = tempfile.TemporaryDirectory()
    bag = os.path.join(bag_dir.name, "dolly.bag")
    bag_written = write_dolly_bag(stream, bag)
    dolly_dataset_yaml(os.path.join(bag_dir.name, "dolly.yaml"), stream)
    open(os.path.join(bag_dir.name, "empty.yaml"), "w").close()
    r3live = r3live_camera()
    jpeg_bag = os.path.join(bag_dir.name, "dolly_jpeg.bag")
    jpeg_written, jpeg_messages = write_compressed_bag(stream, jpeg_bag, r3live)
    dolly_dataset_yaml(os.path.join(bag_dir.name, "dolly_jpeg.yaml"), stream,
                       topics=r3live["topics"], size=r3live["size"], ratio=r3live["ratio"],
                       dist=r3live["dist"])
    frames_of = [i for i, k in enumerate(livo_fields["frames_per_sweep"]) for _ in range(k)]
    bag_want = est[frames_of]
    bag_gt = np.asarray([stream.sweeps[i].gt_displacement for i in frames_of])
    del stream
    emit("checkpoint", **checkpoint_check(livo_mapper, livo_cfg, dev))
    del livo_mapper
    torch.cuda.empty_cache()
    emit("run_synthetic", **run_synthetic_check(dev))

    # ---- shard: the sharded train step at full width -----------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step_fields, shard_launches = shard_step_check(tparams, cams, gt, simi, dev)
    rank_fields = shard_ranks(tparams, cams, gt, dev, profiled, counters)
    emit("shard", seconds=time.perf_counter() - t0, gaussians=tparams.capacity,
         views=len(cams), width=WIDTH, height=HEIGHT, block=list(SHARD_BLOCK),
         launches=shard_launches, **step_fields, ranks=rank_fields)
    torch.cuda.empty_cache()

    # ---- run_bag: the ROS-bag entry point on the livo phase's streams ------
    raw_bag = run_bag_check(bag, os.path.join(bag_dir.name, "dolly.yaml"),
                            os.path.join(bag_dir.name, "empty.yaml"), bag_want, bag_gt, dev)
    emit("run_bag", bag_file=bag_written, **raw_bag)

    # ---- the camera intake: codec_parity, bag_compressed -------------------
    emit("codec_parity", **codec_parity(jpeg_messages, r3live, dev, profiled))
    del jpeg_messages
    comp = run_bag_check(jpeg_bag, os.path.join(bag_dir.name, "dolly_jpeg.yaml"),
                         os.path.join(bag_dir.name, "empty.yaml"), bag_want, bag_gt, dev)
    bag_dir.cleanup()
    kfs = comp["keyframes"] or {}
    staged = np.asarray(kfs.get("psnr_staged") or [])
    final = np.asarray(kfs.get("psnr_final") or [])
    per_sweep = {name: r["pipeline"]["frontend_s"] / r["pipeline"]["sweeps"] * 1e3
                 for name, r in (("raw", raw_bag), ("jpeg", comp))}
    emit("bag_compressed", bag_file=jpeg_written, camera={
        "size": list(r3live["size"]), "ratio": r3live["ratio"], "dist": r3live["dist"],
        "topics": r3live["topics"], "jpeg_quality": JPEG_QUALITY}, **comp,
        kf0_psnr_staged_final=[float(staged[0]), float(final[0])] if len(staged) else None,
        mean_psnr_staged_final=[float(staged.mean()), float(final.mean())]
        if len(staged) else None,
        frontend_ms_per_sweep=per_sweep,
        wall_fps={"raw": raw_bag["pipeline"]["wall_fps"], "jpeg": comp["pipeline"]["wall_fps"]},
        decode_ms_per_message={"raw": raw_bag["bag"]["decode_ms_per_message"],
                               "jpeg": comp["bag"]["decode_ms_per_message"]},
        bag_bytes={"raw": bag_written["bytes"], "jpeg": jpeg_written["bytes"]})
    assert len(staged) == len(final) >= 2, kfs
    assert final[0] >= staged[0] + 3.0, kfs
    assert final.mean() >= staged.mean(), kfs

    # ---- gp_figure: the offline tool's GP on the card ----------------------
    emit("gp_figure", **gp_figure_check(dev))

    # ---- the root tools: quality, quality_diag, loop_profile, blocks,
    # projection, and the stage profilers: stages
    torch.cuda.empty_cache()
    new_phases = {"quality": lambda: quality_phase(dev, profiled, counters),
                  "quality_diag": lambda: quality_diag_phase(dev, counters),
                  "loop_profile": lambda: loop_profile_phase(dev, counters),
                  "blocks": lambda: blocks_phase(dev, counters),
                  "projection": lambda: projection_phase(dev, counters),
                  "stages": lambda: stages_phase(dev, counters, new_fields["blocks"])}
    new_fields, new_launches = {}, {}
    for name in NEW_PHASES:
        new_fields[name], new_launches[name] = new_phases[name]()
        emit(name, **new_fields[name])
        torch.cuda.empty_cache()

    # ---- the kernels table ---------------------------------------------------
    k1_bound_by = "operations" if k1_flops / PEAK_F32 >= k1_bytes / PEAK_BYTES else "bytes"
    k1_mean, k1_plain_mean = float(np.mean(k1_ms)), float(np.mean(plain_ms))
    table = [
        {"name": "K1 tile_forward", "route": "cuda",
         "source": "gslivm_tpu_torch/csrc/tile_forward.cu",
         "replaces": "gslivm_tpu/ops/rasterize_pallas.py:298",
         "launches": launches["K1"] + train_launches["K1"] + map_launches["K1"]
         + livo_launches["K1"],
         "launches_serve": launches["K1"], "launches_train_step": train_launches["K1"],
         "launches_map": map_launches["K1"], "launches_livo": livo_launches["K1"],
         "max_abs_err": k1_err, "ms": k1_mean, "ckpt_ms": ckpt_ms,
         "plain_ms": k1_plain_mean,
         "bound_ms": k1_bound, "bound_by": k1_bound_by, "library_ms": None,
         "bound_ms_walked": k1_bound_walked, "redesigned": True,
         "earlier_times": EARLIER_TIMES, **tile_usage["K1"]},
        {"name": "K2 tile_backward", "route": "cuda",
         "source": "gslivm_tpu_torch/csrc/tile_backward.cu",
         "replaces": "gslivm_tpu/ops/rasterize_pallas.py:455",
         "launches": train_launches["K2"] + map_launches["K2"] + livo_launches["K2"],
         "launches_train_step": train_launches["K2"], "launches_map": map_launches["K2"],
         "launches_livo": livo_launches["K2"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_bound_by, "library_ms": None,
         "bound_ms_walked": k2_bound_walked, "run_spread": k2_spread,
         "redesigned": True, "earlier_times": EARLIER_TIMES, **tile_usage["K2"]},
        {"name": "K3 blur", "route": "cuda", "source": "gslivm_tpu_torch/csrc/blur.cu",
         "replaces": "gslivm_tpu/ops/blur_pallas.py:34",
         "launches": launches["K3"] + train_launches["K3"] + map_launches["K3"]
         + livo_launches["K3"],
         "launches_serve": launches["K3"], "launches_train_step": train_launches["K3"],
         "launches_map": map_launches["K3"], "launches_livo": livo_launches["K3"],
         "max_abs_err": k3_err, "ms": k3["serve"]["kernel_ms"],
         "plain_ms": k3["serve"]["plain_ms"], "bound_ms": k3["serve"]["bound_ms"],
         "bound_by": k3["serve"]["bound_by"], "library_ms": lib_ms,
         "copy_ms": k3["serve"]["copy_ms"], "ms_train_stack": k3["train"]["kernel_ms"],
         "bound_ms_train_stack": k3["train"]["bound_ms"], "redesigned": True,
         "earlier_times": EARLIER_TIMES, **k3_usage},
        {"name": "T1 microbench_fetch", "route": "cuda",
         "source": "gslivm_tpu_torch/csrc/microbench_fetch.cu",
         "replaces": "tools/microbench_roll.py:42",
         "launches": t1_launches, "launches_tools": t1_launches, "launches_map": 0,
         "launches_livo": 0,
         "max_abs_err": max(r["max_abs_err"] for r in t1.values()),
         "max_rel_err": max(r["max_rel_err"] for r in t1.values()),
         "ms": t1["A"]["ms"], "plain_ms": t1["A"]["plain_ms"],
         "bound_ms": t1["A"]["bound_ms"], "bound_by": "bytes",
         "library_ms": t1["A"]["library_ms"],
         "variants_ms": {v: r["ms"] for v, r in t1.items()}},
        {"name": "T2 microbench_fwdablate", "route": "cuda",
         "source": "gslivm_tpu_torch/csrc/microbench_fwdablate.cu",
         "replaces": "tools/microbench_fwdablate.py:51",
         "launches": t2_launches, "launches_tools": t2_launches, "launches_map": 0,
         "launches_livo": 0,
         "max_abs_err": max(r["max_abs_err"] for r in t2.values()),
         "max_scaled_err": max(r["max_scaled_err"] for r in t2.values()),
         "ms": t2["full"]["ms"], "plain_ms": t2_plain_ms,
         "bound_ms": t2_work["bound_ms"], "bound_by": t2_work["bound_by"],
         "library_ms": None, "redesigned": True, "earlier_times": EARLIER_TIMES,
         "variants_ms": {v: r["ms"] for v, r in t2.items()}, **t2["full"]["usage"]},
    ]
    for row, key in zip(table, ("K1", "K2", "K3")):
        row["launches_tools"] = tool_launches[key]
        row["launches_shard"] = shard_launches[key]
        row["launches"] += shard_launches[key]
    for row in table[3:]:
        row["launches_shard"] = 0
    for name in NEW_PHASES:
        for row, key in zip(table, ("K1", "K2", "K3", None, None)):
            row[f"launches_{name}"] = new_launches[name][key] if key else 0
            row["launches"] += row[f"launches_{name}"]
    print(smi, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # report the failing phase with its traceback, then fail
        traceback.print_exc()
        print(f"chip_smoke: failed after phase {emit.last_phase!r}", file=sys.stderr,
              flush=True)
        rc = 1
    sys.exit(rc)
