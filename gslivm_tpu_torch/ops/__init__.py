"""ops of the PyTorch port (mirrors gslivm_tpu/ops)."""
