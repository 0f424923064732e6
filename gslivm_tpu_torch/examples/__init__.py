"""The port's example entry points (its own copies of the JAX package's
examples/): `python -m gslivm_tpu_torch.examples.run_synthetic`,
`python -m gslivm_tpu_torch.examples.run_bag` and
`python -m gslivm_tpu_torch.examples.offline_fit`."""
