"""The benchmark of gslivm_tpu_torch (`python3 -m benchmark.run`): harness,
generator, plain reference, drivers, per-layer readers and tests."""
