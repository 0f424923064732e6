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
"""
