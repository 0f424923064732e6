"""Measurement and offline tools of the port (counterparts of the repo's
`tools/` microbenchmarks and of `gslivm_tpu/tools/`).

Each microbenchmark is a module with a `main()`, run on the card:

    python -m gslivm_tpu_torch.tools.microbench_roll        # T1, chunk fetch
    python -m gslivm_tpu_torch.tools.microbench_fwdablate   # T2, K1 ablation
    python -m gslivm_tpu_torch.tools.microbench_kernelcost  # K1/K2 cost split
    python -m gslivm_tpu_torch.tools.profile_step3          # train-step stages

They time with CUDA events (`timing.py`) and raise without a card. The
offline tools (`evaluate.py`, `memlog.py`) run on the card by default and
on the CPU when asked; `bag_export.py` reads ROS bags on the host, and
`multihost_demo.py` runs the sharded train step across processes
(`--nproc N --device cpu` on gloo, or under torchrun on the cards).
"""
