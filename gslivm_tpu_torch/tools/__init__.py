"""Measurement and offline tools of the port (counterparts of the repo's
`tools/` microbenchmarks and of `gslivm_tpu/tools/`).

Each microbenchmark is a module with a `main()`, run on the card:

    python -m gslivm_tpu_torch.tools.microbench_roll        # T1, chunk fetch
    python -m gslivm_tpu_torch.tools.microbench_fwdablate   # T2, K1 ablation
    python -m gslivm_tpu_torch.tools.microbench_kernelcost  # K1/K2 cost split
    python -m gslivm_tpu_torch.tools.profile_step3          # train-step stages

They time with CUDA events (`timing.py`) and raise without a card. The
offline tools (`evaluate.py`, `memlog.py`, `gp_figure.py`) run on the
card by default and on the CPU when asked; `bag_export.py` reads ROS bags
on the host (a JPEG's reconstruction on --device), and `multihost_demo.py`
runs the sharded train step across processes (`--nproc N --device cpu` on
gloo, or under torchrun on the cards).

The offline tools of the reference's `python/` scripts, own copies of
gslivm_tpu/tools/*.py, each a CLI (`python -m gslivm_tpu_torch.tools.<name>`):
`calib` (extrinsic arithmetic), `nerf_export` (transforms.json),
`traj_plot` and `time_plot` (plots), `see_image` (a depth map through a
colormap; images read by the port's PNG and JPEG decoders), `sbs_video`
(side-by-side mp4; frames read by the PNG decoder, written by OpenCV's
VideoWriter, the port's one use of cv2) and `gp_figure` (the voxel GP on
one cell: `compute` on the card, then the plots). matplotlib is imported
only where a plot is drawn; the card machine has none.

The root tools that drive the mapper and the rasterizer, twins of the
repo's `tools/` scripts with their flags: `quality_bench` (map quality at
960x600 beside QUALITY_r05.json), `quality_diag` (init, pipeline,
oracle), `profile_iteration` and `profile_ingest` (the mapper's loop by
stage), `exp_block` (the supertile block-shape sweep), `crosscheck_blocks`
(a shape against 2x2), `band_projection` (the pixel axis projected from
one card) and `scaling_bench` (the sharded step over mesh sizes). Those
that time by CUDA events need a card; the others take `--cpu`.

The stage profilers, twins of the repo's tools of the same names, split
the device time of the 1080p render and its losses into named stages:
`profile_stages` (the render pipeline's cumulative cuts, forward and
`bwd`), `profile_binning` (the stages inside `bin_instances`),
`microbench_losses` (the image loss; K3 against the SSIM algebra) and
`microbench_gridsample` (the delta-depth warp against three gathers).
They need a card.
"""
